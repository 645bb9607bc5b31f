"""Tests of the port that need a CUDA card; they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. There, skip the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from ace_tpu_torch.ops.dhconv_filter import (
    dhconv_filter,
    dhconv_filter_dw,
    dhconv_filter_dw_plain,
    dhconv_filter_dx,
    dhconv_filter_dx_plain,
    dhconv_filter_param,
    dhconv_filter_plain,
)
from ace_tpu_torch.ops.fused_block_tail import (
    fused_block_tail,
    fused_block_tail_plain,
)
from ace_tpu_torch.ops.fused_sht import fused_sht
from ace_tpu_torch.ops.sht import RealSHT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the kernel's tile edges: M against its three 64-row slabs and 192-row
# chunks, O against its 128-column tiles and 64-column TMA boxes
_FILTER_EDGES = [(2, 3, m, 96, o) for m in (1, 64, 65, 181, 193)
                 for o in (8, 120, 136, 512)]


@pytest.mark.parametrize(
    "shape",
    [(1, 180, 181, 512, 512), (2, 3, 181, 96, 200), (1, 2, 5, 32, 8)]
    + _FILTER_EDGES,
    ids=["flagship", "ragged", "tiny"]
    + [f"M{s[2]}-O{s[4]}" for s in _FILTER_EDGES],
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
    # O % 8 != 0: the weight and output rows are no whole 16-byte TMA strides
    w12 = torch.zeros(2, 32, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="O % 8"):
        dhconv_filter(x[..., :32], x[..., :32], w12, w12)
    with pytest.raises(NotImplementedError):
        dhconv_filter(x[..., :32], x[..., :32], w[:, :32], w[:, :32],
                      out_dtype=torch.float32)


# 1b's tile edges: M against its 64-row slabs and 192-row tiles, I against
# its 32-column stores, 64-column staging and 128-column tiles, O (its
# contraction) against its 32-deep stages and 16-deep steps; B = 1 and 3
# beside the B = 2 cases
_DX_EDGES = [(2, 3, m, i, o) for m in (1, 64, 65, 181) for i in (8, 128, 136)
             for o in (8, 32, 40)] + [
    (b, 3, m, i, o) for b in (1, 3) for m in (1, 64, 65, 181, 192, 193)
    for i in (8, 40, 128, 136, 264) for o in (8, 40, 64, 72, 520)]
# more tiles than the card has SMs, so that each block of the persistent
# grid walks several, across (b, l) boundaries at odd counts
_DX_WALKS = [(1, 181, 65, 136, 40), (3, 45, 193, 264, 520),
             (3, 37, 181, 392, 72)]


def _bwd_inputs(b, l, m, i, o, device):
    gen = torch.Generator(device).manual_seed(0)
    xr, xi = (torch.randn(b, l, m, i, generator=gen, device=device)
              for _ in range(2))
    gr, gi = (torch.randn(b, l, m, o, generator=gen, device=device)
              .to(torch.bfloat16) for _ in range(2))
    wr, wi = (torch.randn(l, i, o, generator=gen, device=device)
              .mul(0.02).to(torch.bfloat16) for _ in range(2))
    return xr, xi, gr, gi, wr, wi


def _assert_f32_close(out, ref):
    """bf16 products are exact in f32: only the order of the sum differs,
    so 1e-4 of the largest output."""
    for a, r in zip(out, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize(
    "shape",
    [(4, 180, 181, 512, 512), (2, 3, 181, 96, 200)] + _DX_EDGES + _DX_WALKS,
    ids=["flagship-train", "ragged"]
    + ["M{}-I{}-O{}".format(*s[2:]) if s[0] == 2
       else "B{}-M{}-I{}-O{}".format(s[0], *s[2:]) for s in _DX_EDGES]
    + ["walk-B{}-L{}-M{}-I{}-O{}".format(*s) for s in _DX_WALKS],
)
def test_dhconv_dx_kernel_matches_plain(cuda, shape):
    """1b (dx) against its plain version at the training shape and its
    tile edges."""
    _, _, gr, gi, wr, wi = _bwd_inputs(*shape, cuda)
    before = dhconv_filter_dx.launches
    out = dhconv_filter_dx(gr, gi, wr, wi)
    torch.cuda.synchronize()
    assert dhconv_filter_dx.launches == before + 1
    _assert_f32_close(out, dhconv_filter_dx_plain(gr, gi, wr, wi))


# 1c's tile edges: M against its 32-row stages (the contraction runs over
# B and M), I against its 32-column x boxes, 64-row slabs and 128-row
# tiles, O against its 32-column stores, 64-column g boxes and 128-column
# tiles
_DW_EDGES = [(b, 3, m, i, o) for b in (1, 3) for m in (1, 32, 33, 181)
             for i, o in ((8, 8), (64, 128), (72, 136), (56, 120),
                          (200, 264))]


@pytest.mark.parametrize(
    "shape", [(4, 180, 181, 512, 512), (2, 3, 181, 96, 200)] + _DW_EDGES,
    ids=["flagship-train", "ragged"]
    + ["B{}-M{}-I{}-O{}".format(s[0], *s[2:]) for s in _DW_EDGES],
)
def test_dhconv_dw_kernel_matches_plain(cuda, shape):
    """1c (dW, in the weight's [2, L, I, O] layout) against its plain
    version."""
    xr, xi, gr, gi, _, _ = _bwd_inputs(*shape, cuda)
    before = dhconv_filter_dw.launches
    out = dhconv_filter_dw(xr, xi, gr, gi)
    torch.cuda.synchronize()
    assert dhconv_filter_dw.launches == before + 1
    ref = torch.stack(dhconv_filter_dw_plain(xr, xi, gr, gi))
    _assert_f32_close((out,), (ref,))


def test_dhconv_filter_gradients_on_card_match_cpu(cuda):
    """The differentiable filter on the card (K1, 1b, 1c) against the same
    call on the CPU (plain versions)."""
    xr, xi, gr, gi, wr, wi = _bwd_inputs(2, 5, 37, 64, 64, cuda)
    weight = torch.stack((wr.float(), wi.float()))
    grads = {}
    for dev in ("cpu", cuda):
        x = [t.to(dev).requires_grad_() for t in (xr, xi, weight)]
        outr, outi = dhconv_filter_param(*x)
        torch.autograd.backward((outr, outi), (gr.to(dev), gi.to(dev)))
        grads[str(dev)] = [t.grad.cpu() for t in x]
    _assert_f32_close(grads["cuda"], grads["cpu"])


def test_dhconv_bwd_kernels_run_in_a_fresh_thread(cuda):
    """1b and 1c, each the first CUDA work of a new thread, as in autograd's
    worker thread: such a thread has no current context until something
    binds one, and the kernels' tensor maps cannot be encoded without it."""
    import threading

    xr, xi, gr, gi, wr, wi = _bwd_inputs(2, 5, 37, 64, 64, cuda)
    calls = {
        "dx": (lambda: dhconv_filter_dx(gr, gi, wr, wi),
               lambda: dhconv_filter_dx_plain(gr, gi, wr, wi)),
        "dw": (lambda: (dhconv_filter_dw(xr, xi, gr, gi),),
               lambda: (torch.stack(dhconv_filter_dw_plain(xr, xi, gr, gi)),)),
    }
    for name, (kernel, plain) in calls.items():
        result = {}

        def run():
            try:
                result["out"] = kernel()
                torch.cuda.synchronize()
            except Exception as err:  # reported below, on the test's thread
                result["err"] = err

        thread = threading.Thread(target=run)
        thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive(), f"{name}: still running"
        assert "err" not in result, f"{name}: {result.get('err')}"
        _assert_f32_close(result["out"], plain())


def test_dhconv_bwd_kernels_refuse_what_they_do_not_take(cuda):
    xr, xi, gr, gi, wr, wi = _bwd_inputs(1, 2, 5, 32, 12, cuda)
    with pytest.raises(ValueError, match="O % 8"):
        dhconv_filter_dx(gr, gi, wr, wi)
    with pytest.raises(TypeError):
        dhconv_filter_dw(xr, xi, gr.float(), gi.float())
    with pytest.raises(ValueError, match="contiguous"):
        dhconv_filter_dx(gr[..., :8], gi[..., :8], wr[..., :8], wi[..., :8])


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


def tail_inputs(n, c, hidden, nc, device, seed=0):
    """Rows and weights for the fused tail, the weights drawn at std
    1/sqrt(fan-in) so that every product shows in the output."""
    gen = torch.Generator(device).manual_seed(seed)

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=device) * std

    bf = torch.bfloat16
    xf, resid = r(n, c).to(bf), r(n, c).to(bf)
    noise = r(n, nc)
    weights = (
        r(c, c, std=c ** -0.5), r(c, std=0.1), 1.0 + r(c, std=0.1),
        r(c, std=0.1), r(nc, c, std=0.1), r(nc, c, std=0.1),
        r(c, hidden, std=c ** -0.5), r(hidden, std=0.1),
        r(hidden, c, std=hidden ** -0.5), r(c, std=0.1),
    )
    return xf, resid, noise, tuple(w.to(bf).contiguous() for w in weights)


# the kernel's tile edges: N against its 64-row tiles, C against the two
# warpgroups' 64-column blocks (odd at 192), hidden against its 256-column
# chunks, the noise against its 32-row weight stages and 64-channel tile
_TAIL_EDGES = [(n, c, h, nc) for n in (1, 127, 128, 129) for c in (64, 192, 512)
               for h in (64, 1024) for nc in (1, 4, 32, 33)]


@pytest.mark.parametrize(
    "shape", [(1000, 128, 256, 4), (64800, 512, 1024, 32)] + _TAIL_EDGES,
    ids=["ragged", "flagship"] + ["N{}-C{}-H{}-nc{}".format(*s)
                                  for s in _TAIL_EDGES],
)
def test_block_tail_kernel_matches_plain(cuda, shape):
    """K2 against its plain version: the same bf16 products summed in
    another order, with four bf16 rounding points between them, so 2e-2
    of the largest output (the JAX package's fused-versus-module limit)."""
    args = tail_inputs(*shape, cuda)
    before = fused_block_tail.launches
    out = fused_block_tail(*args)
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    ref = fused_block_tail_plain(*args)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2 * scale


# (B, nlat, nlon, C, lmax, mmax, grid) at the kernel's tile edges: the
# 32-deep stages over K (phase 2) and J (phase 1), the 128-row tiles over
# C (phase 1) and 2C (phase 2), the 64-column chunks and 192-column tiles
# over 2M (phase 1) and L (phase 2), L < M, the other grids, B = 2
_SHT_EDGES = (
    [(1, k, 40, 64, None, None, "legendre-gauss") for k in (31, 32, 33)]
    + [(1, 16, j, 8, None, None, "legendre-gauss") for j in (63, 64, 65)]
    + [(1, 16, 32, c, None, None, "legendre-gauss")
       for c in (60, 64, 68, 124, 128, 132)]
    + [(1, 70, 16, 8, l, None, "legendre-gauss") for l in (63, 64, 65)]
    + [(1, 200, 16, 8, l, None, "legendre-gauss") for l in (191, 192, 193)]
    + [(1, 16, 200, 8, None, m, "legendre-gauss")
       for m in (31, 32, 33, 95, 96, 97)]
    + [(1, 12, 48, 8, 7, 20, "legendre-gauss"),
       (2, 33, 64, 32, None, None, "lobatto"),
       (2, 33, 64, 32, None, None, "equiangular"),
       (2, 40, 80, 128, None, None, "legendre-gauss")]
)


@pytest.mark.parametrize(
    "case",
    [(2, 37, 72, 96, None, None, "legendre-gauss"),
     (1, 180, 360, 512, None, None, "legendre-gauss")] + _SHT_EDGES,
    ids=["ragged", "flagship"]
    + ["B{}-K{}-J{}-C{}-L{}-M{}-{}".format(*s) for s in _SHT_EDGES],
)
def test_fused_sht_kernel_matches_forward_pair(cuda, case):
    """K3 against forward_pair (the einsum path, f32): split-TF32 products
    (about 22 mantissa bits) summed in another order over 360 and 180
    terms, so 1e-4 of the largest output."""
    b, nlat, nlon, c, lmax, mmax, grid = case
    sht = RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid, device=cuda)
    x = torch.randn(b, nlat, nlon, c,
                    generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    before = fused_sht.launches
    out = sht.forward_fused(x)
    torch.cuda.synchronize()
    assert fused_sht.launches == before + 1
    for a, ref in zip(out, sht.forward_pair(x)):
        assert a.shape == ref.shape == (b, sht.lmax, sht.mmax, c)
        scale = float(ref.abs().max())
        assert float((a - ref).abs().max()) <= 1e-4 * scale


def test_block_tail_and_sht_kernels_refuse_what_they_do_not_take(cuda):
    xf, resid, noise, w = tail_inputs(70, 128, 256, 4, cuda)
    with pytest.raises(ValueError, match="C % 64"):
        fused_block_tail(xf[:, :96].contiguous(), resid[:, :96].contiguous(),
                         noise, tail_inputs(70, 96, 256, 4, cuda)[3])
    with pytest.raises(TypeError):
        fused_block_tail(xf, resid, noise.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        fused_block_tail(xf, resid, noise.t().contiguous().t(), w)
    # C = 576: the tiles of a block no longer fit its shared memory
    args = tail_inputs(70, 576, 64, 4, cuda)
    with pytest.raises(ValueError, match="shared"):
        fused_block_tail(*args)
    sht = RealSHT(16, 32, device=cuda)
    x = torch.zeros(1, 16, 32, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sht(x.transpose(1, 2).contiguous().transpose(1, 2), sht.fc,
                  sht.fs, sht.fused_table())
    # C % 4 != 0: the rows of x are no whole 16-byte TMA strides
    with pytest.raises(ValueError, match="C % 4"):
        fused_sht(torch.zeros(1, 16, 32, 6, device=cuda), sht.fc, sht.fs,
                  sht.fused_table())
    # split tables of another transform
    other = RealSHT(16, 32, lmax=8, device=cuda)
    with pytest.raises(ValueError, match="tables"):
        fused_sht(x, sht.fc, sht.fs, sht.fused_table(),
                  tables=other.kernel_tables())


def test_small_fused_rollout_on_card_matches_cpu(cuda, monkeypatch):
    """The 2-step rollout check above with the fused tail on both
    devices: K1 and K2 on the card, their plain versions on the CPU."""
    from ace_tpu_torch import flagship
    from ace_tpu_torch.stepper.stepper import PrognosticState

    kw = dict(nz=2, embed=128, layers=2, fused_block_tail=True)
    cpu = flagship.build_stepper(16, 32, device="cpu", **kw)
    gpu = flagship.build_stepper(16, 32, device=cuda, **kw)
    flagship.draw_check_weights(cpu, torch.Generator().manual_seed(0))
    gpu.load_state_dict(cpu.module.state_dict())
    gpu_noise = torch.Generator().manual_seed(2)
    monkeypatch.setattr(
        gpu.module, "make_noise",
        lambda batch, generator: cpu.module.make_noise(batch, gpu_noise).to(cuda),
    )
    ic, forcing = flagship.synthetic_inputs(
        cpu, 2, generator=torch.Generator().manual_seed(1)
    )
    before = (dhconv_filter.launches, fused_block_tail.launches)
    outputs = {}
    for name, stepper in (("cpu", cpu), ("gpu", gpu)):
        dev = stepper.device
        outputs[name], _ = stepper.predict(
            PrognosticState({k: v.to(dev) for k, v in ic.data.items()}),
            {k: v.to(dev) for k, v in forcing.items()},
            generator=torch.Generator().manual_seed(2) if name == "cpu" else None,
        )
    assert dhconv_filter.launches == before[0] + 2 * 2
    assert fused_block_tail.launches == before[1] + 2 * 2
    errs = {}
    for k, ref in outputs["cpu"].items():
        out = outputs["gpu"][k].cpu()
        assert torch.isfinite(out).all(), k
        errs[k] = flagship.anomaly_error(out, ref, (-2, -1))
    print(f"largest error over the anomaly: {max(errs.values()):.4g}")
    assert max(errs.values()) <= flagship.CHECK_TOL, errs
