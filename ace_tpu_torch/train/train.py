"""The training entry point (port of ace_tpu/train/train.py):

    python -m ace_tpu_torch.train <config.yaml> [--override a.b=1 ...]
        [--device cpu]

It reads the same YAML as ``python -m ace_tpu.train``, trains on the CUDA
device unless ``--device`` (or ``device=``) asks for another, and writes
``metrics.jsonl`` and the checkpoints into ``experiment_dir``; run again
on the same directory, it resumes from ``training_checkpoints/ckpt.msgpack``.
Without CUDA it stops rather than fall back to the CPU.

Over N processes (``torchrun --nproc-per-node N -m ace_tpu_torch.train
<config.yaml>``, or the ``ACE_TPU_*`` variables of
``parallel/distributed.py``) with ``mesh: {data_parallel: N}`` in the
config, each process trains on ``cuda:{LOCAL_RANK}`` (gloo on the CPU
with ``--device cpu``), and only the first writes files.
"""

import logging

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.device import entry_device
from ace_tpu_torch.parallel import distributed as dist
from ace_tpu_torch.train.trainer import Trainer, TrainConfig


def run_train_from_config(config: TrainConfig, device=None) -> Trainer:
    config.logging.configure(config.experiment_dir)
    trainer = config.build_trainer(device=device)
    trainer.train()
    GlobalTimer.get_instance().log_durations()
    return trainer


def main(argv=None, device=None) -> Trainer:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the trainer."""
    args = get_parser().parse_args(argv)
    device = device if device is not None else args.device
    # join the process group where the launch made one
    dist.initialize(device=device)
    device = entry_device(device)
    data = prepare_config(args.yaml_config, args.override)
    config = from_dict(TrainConfig, data)
    if dist.is_root():
        prepare_directory(config.experiment_dir, data)
    dist.barrier("prepare_directory")
    logging.info("Starting training")
    return run_train_from_config(config, device=device)


if __name__ == "__main__":
    main()
