"""CLI plumbing: YAML and ``--override`` dotlists, experiment-directory
preparation (port of ace_tpu/core/cli.py:97-120).

JAX's platform variable and compilation cache have no counterpart: an
entry point's ``--device`` flag picks the device, and nothing is compiled
ahead of time.
"""

import argparse
import os
from typing import Any

from ace_tpu_torch.core.config import update_dict_with_dotlist


def prepare_config(path: str, override: list[str] | None = None
                   ) -> dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return update_dict_with_dotlist(data, override)


def prepare_directory(experiment_dir: str, config_data: dict[str, Any]):
    """Create the experiment dir and snapshot the resolved config into it."""
    import yaml

    os.makedirs(experiment_dir, exist_ok=True)
    with open(os.path.join(experiment_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config_data, f)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("yaml_config", type=str, help="path to YAML config")
    parser.add_argument(
        "--override",
        nargs="*",
        default=None,
        help="dotlist overrides, e.g. a.b=1 c=hello",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="the device to run on, e.g. cpu or cuda:1 (default: the "
             "CUDA device; without CUDA the run stops unless cpu is given)",
    )
    return parser
