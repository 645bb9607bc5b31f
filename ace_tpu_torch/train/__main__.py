from ace_tpu_torch.train.train import main

if __name__ == "__main__":
    main()
