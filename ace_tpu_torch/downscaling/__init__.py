"""Generative diffusion downscaling (HiRO-ACE; port of
ace_tpu/downscaling/): the SongUNet, compact UNet and SwinIR networks,
the EDM loss and sampler, patched generation, and the training
(``python -m ace_tpu_torch.downscaling``), downscaler
(``downscaling.predict``) and evaluator (``downscaling.evaluator``)
entries."""
