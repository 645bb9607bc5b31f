from ace_tpu_torch.inference.inference import main

if __name__ == "__main__":
    main()
