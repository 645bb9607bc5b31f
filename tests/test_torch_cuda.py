"""Tests of the port that need a CUDA card; they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. There, skip the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from ace_tpu_torch.ops.dhconv_filter import dhconv_filter, dhconv_filter_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(1, 180, 181, 512, 512), (2, 3, 181, 96, 200), (1, 2, 5, 32, 8)],
    ids=["flagship", "ragged", "tiny"],
)
def test_dhconv_kernel_matches_plain(cuda, shape):
    """The kernel against its plain version at the flagship shape and at
    ragged M and O edges: the same bf16 products summed in another order,
    so the bf16 outputs differ by at most their final rounding."""
    b, l, m, i, o = shape
    gen = torch.Generator(cuda).manual_seed(0)
    xr, xi = (torch.randn(b, l, m, i, generator=gen, device=cuda)
              for _ in range(2))
    wr, wi = (torch.randn(l, i, o, generator=gen, device=cuda)
              .mul(0.02).to(torch.bfloat16) for _ in range(2))
    before = dhconv_filter.launches
    out = dhconv_filter(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert dhconv_filter.launches == before + 1
    for a, ref in zip(out, dhconv_filter_plain(xr, xi, wr, wi)):
        assert a.dtype == torch.bfloat16 and a.shape == ref.shape
        scale = float(ref.float().abs().max())
        assert float((a.float() - ref.float()).abs().max()) <= 8e-3 * scale


def test_dhconv_kernel_refuses_shapes_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 5, 48, device=cuda)  # I % 32 != 0
    w = torch.zeros(2, 48, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dhconv_filter(x, x, w, w)
    with pytest.raises(NotImplementedError):
        dhconv_filter(x[..., :32], x[..., :32], w[:, :32], w[:, :32],
                      out_dtype=torch.float32)


def test_small_flagship_rollout_on_card_matches_cpu(cuda, monkeypatch):
    """A 2-step bf16 rollout of a small flagship copy on the card against
    the CPU, with the same weights and noise. The filters and the noise
    conditioning are drawn large (``flagship.draw_check_weights``) so that
    they show in the outputs: dropping the filter's output moves them by
    about 7% of their spatial anomaly, a 1-ulp change of the filter's
    input rounding by about 1% (both on the CPU)."""
    from ace_tpu_torch import flagship
    from ace_tpu_torch.stepper.stepper import PrognosticState

    cpu = flagship.build_stepper(16, 32, nz=2, embed=128, layers=2,
                                 device="cpu")
    gpu = flagship.build_stepper(16, 32, nz=2, embed=128, layers=2,
                                 device=cuda)
    flagship.draw_check_weights(cpu, torch.Generator().manual_seed(0))
    gpu.load_state_dict(cpu.module.state_dict())
    # the card draws the CPU's noise sequence
    gpu_noise = torch.Generator().manual_seed(2)
    monkeypatch.setattr(
        gpu.module, "make_noise",
        lambda batch, generator: cpu.module.make_noise(batch, gpu_noise).to(cuda),
    )
    ic, forcing = flagship.synthetic_inputs(
        cpu, 2, generator=torch.Generator().manual_seed(1)
    )
    before = dhconv_filter.launches
    outputs = {}
    for name, stepper in (("cpu", cpu), ("gpu", gpu)):
        dev = stepper.device
        outputs[name], _ = stepper.predict(
            PrognosticState({k: v.to(dev) for k, v in ic.data.items()}),
            {k: v.to(dev) for k, v in forcing.items()},
            generator=torch.Generator().manual_seed(2) if name == "cpu" else None,
        )
    assert dhconv_filter.launches == before + 2 * 2
    # bf16 rounds at other points on the two devices: each variable
    # within CHECK_TOL (3e-2) of its spatial anomaly
    errs = {}
    for k, ref in outputs["cpu"].items():
        out = outputs["gpu"][k].cpu()
        assert torch.isfinite(out).all(), k
        errs[k] = flagship.anomaly_error(out, ref, (-2, -1))
    print(f"largest error over the anomaly: {max(errs.values()):.4g}")
    assert max(errs.values()) <= flagship.CHECK_TOL, errs
