"""Rules of the port: no JAX inside it, and the card by default."""

import ast
from pathlib import Path

import pytest
import torch

from ace_tpu_torch.device import get_device

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ace_tpu")


def _port_sources():
    return sorted((ROOT / "ace_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_imports_no_jax(path):
    """Checked on the source: this test process has JAX loaded anyway."""
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_get_device_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_device()
    with pytest.raises(RuntimeError):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def test_stepper_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from datetime import timedelta

    import numpy as np

    from ace_tpu_torch.core.coordinates import (
        LatLonCoordinates,
        gaussian_latitudes,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = StepperConfig(step=StepSelector(type="single_module", config={
        "builder": {"type": "NoiseConditionedSFNO", "config": {
            "embed_dim": 8, "noise_embed_dim": 4, "num_layers": 1}},
        "in_names": ["a"], "out_names": ["a"],
        "normalization": {"network": {"means": {"a": 0.0},
                                      "stds": {"a": 1.0}}},
    }))
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=gaussian_latitudes(8), lon=np.linspace(0, 360, 16,
                                                       endpoint=False)),
        timestep=timedelta(hours=6),
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.get_stepper(info)
    assert config.get_stepper(info, device="cpu").device.type == "cpu"
