"""The coupled evaluator entry (port of ace_tpu/coupled/evaluator.py):

    python -m ace_tpu_torch.coupled.evaluator <config.yaml>
        [--override a.b=1 ...] [--device cpu]

The configuration of coupled inference, with the paired aggregation
against the target data forced on.
"""

import logging

from ace_tpu_torch.core.cli import get_parser, prepare_config, prepare_directory
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.coupled.inference import (
    CoupledInferenceConfig,
    run_coupled_inference,
)
from ace_tpu_torch.device import entry_device


def main(argv=None, device=None) -> dict[str, float]:
    """The command line; ``device`` (when given) takes the place of
    ``--device``. Returns the logs."""
    args = get_parser().parse_args(argv)
    device = entry_device(device if device is not None else args.device)
    data = prepare_config(args.yaml_config, args.override)
    data["evaluate"] = True
    config = from_dict(CoupledInferenceConfig, data)
    prepare_directory(config.experiment_dir, data)
    config.logging.configure(config.experiment_dir)
    logging.info("Starting coupled evaluator")
    return run_coupled_inference(config, device=device)


if __name__ == "__main__":
    main()
