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


@pytest.fixture
def tf32_on():
    """Both TF32 flags on (PyTorch's default for cuDNN) for the test, and
    as they were after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def test_entry_device_pins_float32(tf32_on):
    from ace_tpu_torch.device import entry_device

    assert entry_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("entry", [
    "ace_tpu_torch.train.train", "ace_tpu_torch.inference.inference",
    "ace_tpu_torch.inference.evaluator", "ace_tpu_torch.coupled.train",
    "ace_tpu_torch.coupled.inference", "ace_tpu_torch.coupled.evaluator",
    "ace_tpu_torch.downscaling.train", "ace_tpu_torch.downscaling.predict",
    "ace_tpu_torch.downscaling.evaluator",
])
def test_each_entry_pins_float32_where_it_picks_its_device(entry, tf32_on,
                                                           tmp_path):
    """Each entry's ``main`` turns TF32 off for CUDA matmuls and cuDNN
    convolutions as it picks its device, before it reads its config (here
    a missing file, so that it stops there), whatever the device."""
    import importlib

    main = importlib.import_module(entry).main
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.yaml")], device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("target, args", [
    ("ace_tpu_torch.downscaling.predict:run_downscaler", (None,)),
    ("ace_tpu_torch.downscaling.evaluator:run_downscaling_evaluator",
     (None,)),
    ("ace_tpu_torch.downscaling.train:DownscalingTrainer", (None,)),
])
def test_each_run_function_needs_cuda_and_pins_float32(target, args,
                                                       tf32_on,
                                                       monkeypatch):
    """The functions under the downscaling entries pick their device as the
    entries do: CUDA unless the CPU is asked for, with TF32 off, before
    they read their config (here none)."""
    import importlib

    module, name = target.split(":")
    function = getattr(importlib.import_module(module), name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        function(*args)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("name", ["DiffusionModel", "DeterministicModel"])
def test_downscaling_models_need_cuda_unless_cpu_is_asked(name,
                                                          monkeypatch):
    """A downscaling model, and so ``load_downscaling_model`` and
    ``DenoisingMoEPredictor.load``, which build one, is on the CUDA device
    unless the CPU is asked for."""
    from ace_tpu_torch.downscaling import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(models, name)(None, None)
