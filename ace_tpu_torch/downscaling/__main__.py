from ace_tpu_torch.downscaling.train import main

if __name__ == "__main__":
    main()
