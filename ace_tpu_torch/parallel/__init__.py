"""Multi-process data parallelism over ``torch.distributed`` (port of
ace_tpu/parallel/)."""
