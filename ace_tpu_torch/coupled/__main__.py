from ace_tpu_torch.coupled.train import main

if __name__ == "__main__":
    main()
