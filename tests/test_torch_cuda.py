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
    [(1, 180, 181, 512, 512), (1, 180, 181, 384, 384), (2, 3, 181, 96, 200),
     (1, 2, 5, 32, 8)]
    + _FILTER_EDGES,
    ids=["flagship", "sfno", "ragged", "tiny"]
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
    [(4, 180, 181, 512, 512), (1, 180, 181, 384, 384), (2, 3, 181, 96, 200)]
    + _DX_EDGES + _DX_WALKS,
    ids=["flagship-train", "sfno-train", "ragged"]
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
    "shape", [(4, 180, 181, 512, 512), (1, 180, 181, 384, 384),
              (2, 3, 181, 96, 200)] + _DW_EDGES,
    ids=["flagship-train", "sfno-train", "ragged"]
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
    "shape", [(1000, 128, 256, 4), (64800, 512, 1024, 32),
              (1000, 128, 256, 34), (64800, 512, 1024, 34)] + _TAIL_EDGES,
    ids=["ragged", "flagship", "ragged-nc34", "path-l"]
    + ["N{}-C{}-H{}-nc{}".format(*s) for s in _TAIL_EDGES],
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


@pytest.mark.parametrize("fault", ["none", "dw_modes", "half_batch",
                                   "no_ema"])
def test_reference_r_holds_the_updates_and_catches_planted_faults(
        cuda, monkeypatch, fault):
    """``chip_smoke.py``'s reference phase R (one epoch through the
    training entry, card against CPU, at the shipped learning rate)
    passes as it is, and fails with a fault planted on the card side
    only: 1c's gradient with its upper half of the modes zeroed, each
    train step on half its batch, or no EMA update. Prints each reading
    (run with ``-s``): they set ``chip_smoke.R_CHANGE_TOL``."""
    import chip_smoke
    from ace_tpu_torch.core.optimization import EMATracker
    from ace_tpu_torch.ops import dhconv_filter as k1
    from ace_tpu_torch.stepper.train import TrainStepper

    if fault == "dw_modes":
        dw = k1.dhconv_filter_dw

        def planted(xr, xi, gr, gi):
            out = dw(xr, xi, gr, gi)
            if out.is_cuda:
                out[:, out.shape[1] // 2:] = 0
            return out

        planted.launches = 0  # the wrapper counts on the module's name

        monkeypatch.setattr(k1, "dhconv_filter_dw", planted)
    elif fault == "half_batch":
        train_step = TrainStepper.train_step

        def planted(self, batch, *args, **kwargs):
            if next(iter(batch.values())).is_cuda:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return train_step(self, batch, *args, **kwargs)

        monkeypatch.setattr(TrainStepper, "train_step", planted)
    elif fault == "no_ema":
        update = EMATracker.__call__

        def planted(self, params):
            if params[0].is_cuda:
                return self.ema_params
            return update(self, params)

        monkeypatch.setattr(EMATracker, "__call__", planted)
    if fault == "none":
        errs = chip_smoke.reference_train_entry_phase()
        print(f"reference R reading, no fault: {errs}")
        return
    with pytest.raises(AssertionError, match="reference R") as info:
        chip_smoke.reference_train_entry_phase()
    print(f"reference R reading, fault {fault}: {info.value}")


def test_histograms_on_the_card_equal_the_cpu(cuda):
    """``HistogramAggregator`` fed card tensors (pinned copies closed by an
    event, filled one window behind) gives the counts and edges of one fed
    the same values on the CPU."""
    from ace_tpu_torch.aggregator.histogram import HistogramAggregator

    gen = torch.Generator(cuda).manual_seed(0)
    card, host = HistogramAggregator(), HistogramAggregator()
    for w in range(3):
        gen_w = {"a": torch.randn(2, 5, 18, 36, generator=gen, device=cuda)
                 * (1 + w),
                 "b": torch.randn(2, 5, 18, 36, generator=gen, device=cuda)}
        tgt_w = {"a": torch.randn(2, 5, 18, 36, generator=gen, device=cuda)}
        card.record_batch(gen_w, tgt_w)
        host.record_batch({k: v.cpu() for k, v in gen_w.items()},
                          {k: v.cpu() for k, v in tgt_w.items()})
    out, ref = card.get_diagnostics(), host.get_diagnostics()
    assert set(out) == set(ref) and len(ref) == 6
    for k, v in ref.items():
        assert (out[k] == v).all(), k
    assert card.get_logs() == host.get_logs()


def test_accumulation_and_frozen_updates_on_the_card(cuda):
    """``Optimization.step`` with gradient accumulation and a frozen
    parameter on the card against the CPU: the frozen weight stays, the
    others, the moments and the running mean within 1e-6 relative."""
    from ace_tpu_torch.core.optimization import OptimizationConfig

    config = OptimizationConfig(optimizer_type="AdamW", lr=1e-2,
                                max_grad_norm=0.5,
                                gradient_accumulation_steps=2)
    gen = torch.Generator().manual_seed(0)
    start = [torch.randn(7, 5, generator=gen), torch.randn(11, generator=gen)]
    grads = [[torch.randn_like(p) for p in start] for _ in range(5)]
    out = []
    for device in ("cpu", cuda):
        opt = config.build(max_epochs=1)
        opt.set_frozen([True, False])
        params = [p.clone().to(device) for p in start]
        opt.init(params)
        for g in grads:
            opt.step(params, [x.to(device) for x in g])
        out.append(([p.cpu() for p in params],
                    [t.cpu() for t in opt.mu + opt.nu + opt.acc],
                    (opt._count, opt.adam_count, opt.schedule_count,
                     opt.mini_step)))
    (p_cpu, s_cpu, c_cpu), (p_card, s_card, c_card) = out
    assert c_card == c_cpu == (5, 2, 2, 1)
    assert torch.equal(p_card[0], start[0]) and torch.equal(p_cpu[0],
                                                            start[0])
    for a, b in zip(p_card + s_card, p_cpu + s_cpu):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("keep_graphs", [False, True])
def test_last_step_only_holds_one_step_of_activations(cuda, keep_graphs):
    """Path F's memory gate on the flagship train step (embed 512, 8
    layers, 180x360, per-block recompute, batch 1 x 2 members): at 6
    rollout steps with ``optimize_last_step_only`` the peak stays within
    3 GB of the 1-step step's; with every step's graph kept (the loss
    summed over the steps: the memory the loss held before the earlier
    steps ran without grad) it passes that by far, so the gate sees the
    fault. Prints the readings (with ``-s``)."""
    import dataclasses

    from ace_tpu_torch import flagship

    ts = flagship.build_train_stepper(device=cuda)
    ts.train_config = dataclasses.replace(
        ts.train_config, n_forward_steps=6,
        optimize_last_step_only=not keep_graphs)
    ts.init(torch.Generator(cuda).manual_seed(0))
    batch = flagship.synthetic_batch(
        ts.stepper, 1, 6, generator=torch.Generator(cuda).manual_seed(1))
    peaks = {}
    for n in (1, 6):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts.train_step(batch, torch.Generator(cuda).manual_seed(2), n)
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() / 1e9
    extra = peaks[6] - peaks[1]
    print(f"\nflagship train step, batch 1 x 2, keep_graphs {keep_graphs}: "
          f"peak 1 step {peaks[1]:.3f} GB, 6 steps {peaks[6]:.3f} GB, "
          f"{extra:.3f} GB above (gate 3 GB)")
    assert (extra > 3.0) == keep_graphs, extra


@pytest.mark.parametrize("zonally_periodic", [False, True])
def test_samudra_on_card_matches_cpu(cuda, zonally_periodic):
    """A small Samudra (widths 16-32, 3 levels) at an odd grid, 22x45 (the
    decoder pads each upsampled level to its skip's shape), on the card
    with TF32 off against the CPU from the same weights, within reference
    S's float32 limits: the outputs within 1e-4 of their largest value,
    each gradient within 1e-3 of its norm plus 1e-6 of the largest
    gradient's norm, but the wide convolutions' biases, whose true
    gradient is zero (the instance norm after them removes them): those
    within 1e-3 of the largest gradient's norm on both sides. Prints the
    readings (``-s``)."""
    from ace_tpu_torch.models.layers import init_weights
    from ace_tpu_torch.models.samudra import Samudra

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    models = [Samudra(7, 5, ch_width=(16, 24, 32), dilation=(1, 2, 2),
                      zonally_periodic_upsample=zonally_periodic)
              for _ in range(2)]
    init_weights(models[0], gen)
    models[1].load_state_dict(models[0].state_dict())
    models[1].to(cuda)
    x = torch.randn(2, 22, 45, 7, generator=gen)
    target = torch.randn(2, 22, 45, 5, generator=gen)
    outs, grads = [], []
    for model, dev in zip(models, ("cpu", cuda)):
        out = model(x.to(dev))
        ((out - target.to(dev)) ** 2).mean().backward()
        outs.append(out.detach().cpu())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    ref, got = outs
    out_err = float((got - ref).abs().max() / ref.abs().max())
    largest = max(g.norm() for g in grads[0].values())
    errs = {}
    for k, r in grads[0].items():
        g = grads[1][k]
        if k.endswith((".conv1.bias", ".conv2.bias")):
            errs[k] = float(max(r.norm(), g.norm()) / (1e-3 * largest))
        else:
            errs[k] = float((g - r).norm()
                            / (1e-3 * r.norm() + 1e-6 * largest))
    worst = max(errs, key=errs.get)
    print(f"Samudra card vs CPU: outputs {out_err:.3g} of the largest; "
          f"gradients {errs[worst]:.3g} of the allowed ({worst})")
    assert out_err <= 1e-4
    assert errs[worst] <= 1


def test_reference_o_runs_on_the_card(cuda):
    """``chip_smoke.py``'s reference phase O: a small copy of path O's
    stepper (Samudra, masks, the ocean corrector) over 3 steps, card
    against CPU, within reference S's float32 limits."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.reference_ocean_phase([dhconv_filter])


def test_reference_c_runs_on_the_card(cuda):
    """``chip_smoke.py``'s reference phase C: a small coupled system of the
    CM4 recipes' shape (the SFNO and Samudra, 4 atmosphere steps an ocean
    step, 2 ocean steps) card against CPU: both components' outputs, the
    coupled loss and every ocean gradient, within reference S's float32
    limits."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.reference_coupled_phase([dhconv_filter])


def test_coupled_bf16_launch_pattern_on_the_card(cuda):
    """The coupled system with the atmosphere in bfloat16 (embed 32, 2
    blocks, 4 atmosphere steps an ocean step, 2 ocean steps): a rollout
    launches K1 in each block of each atmosphere step; a training rollout
    with the atmosphere frozen launches K1 again in the recompute of each
    step of the second outer step (the first depends on data alone), 1b in
    those steps' backward and no 1c; the ocean's gradients finite."""
    import chip_smoke
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.coupled.stepper import CoupledStepperConfig

    torch.backends.cudnn.allow_tf32 = False
    stepper, a_info, o_info = chip_smoke.coupled_stepper_dicts(
        compute_dtype="bfloat16")
    coupled = from_dict(CoupledStepperConfig, stepper).get_stepper(
        a_info, o_info, device=cuda)
    coupled.init_params(torch.Generator(cuda).manual_seed(0))
    for p in coupled.atmosphere.module.parameters():
        p.requires_grad_(False)
    ic, af, of, _, _ = chip_smoke.coupled_inputs(
        coupled, 2, 1, torch.Generator().manual_seed(1))

    def on_card(state):
        return type(state)(data={k: v.to(cuda) for k, v in state.data.items()})

    ic = type(ic)(atmosphere_data=on_card(ic.atmosphere_data),
                  ocean_data=on_card(ic.ocean_data))
    af = {k: v.to(cuda) for k, v in af.items()}
    of = {k: v.to(cuda) for k, v in of.items()}
    counters = [dhconv_filter, dhconv_filter_dx, dhconv_filter_dw]
    per_outer = 2 * coupled.n_inner_steps
    _, launches = chip_smoke.counted(counters,
                                     lambda: coupled.predict(ic, af, of))
    assert launches == {"dhconv_filter": 2 * per_outer,
                        "dhconv_filter_dx": 0, "dhconv_filter_dw": 0}

    def train():
        _, o_out, _ = coupled.predict_with_grad(ic, af, of)
        loss = sum(v.nan_to_num().square().mean() for v in o_out.values())
        loss.backward()

    _, launches = chip_smoke.counted(counters, train)
    assert launches == {"dhconv_filter": 3 * per_outer,
                        "dhconv_filter_dx": per_outer,
                        "dhconv_filter_dw": 0}
    for p in coupled.ocean.module.parameters():
        assert torch.isfinite(p.grad).all()


def test_an_entry_pins_samudra_to_the_gated_float32(cuda, tmp_path):
    """A Samudra stepper's step (``chip_smoke.ocean_stepper_config`` at
    reference O's widths, 32x64) with TF32 on (PyTorch's default for
    cuDNN) differs from the gated float32 step (TF32 off, as
    ``chip_smoke.py`` and the parity tests hold it); after the training
    entry picks its device (its ``main``, stopped at a missing config),
    the same step equals the gated one. Prints the readings (``-s``)."""
    import chip_smoke
    from ace_tpu_torch.stepper.stepper import PrognosticState
    from ace_tpu_torch.train.train import main

    sizes = chip_smoke.O_REFERENCE_SIZES
    nlat, nlon = 32, 64
    config, info = chip_smoke.ocean_stepper_config(
        nlat, nlon, sizes["ch_width"], sizes["dilation"])
    stepper = config.get_stepper(info, device=cuda)
    stepper.init_params(torch.Generator(cuda).manual_seed(0))
    step = stepper.step
    data = chip_smoke.ocean_inputs(
        sorted(set(step.input_names) | set(step.output_names)),
        (2, 2, nlat, nlon), torch.Generator().manual_seed(1),
        info.horizontal_coordinates.lat, info.vertical_coordinate.idepth,
        info.mask_provider)
    ic = PrognosticState(data={k: data[k][:, :1].to(cuda)
                               for k in stepper.prognostic_names})
    forcing = {k: data[k].to(cuda) for k in stepper.forcing_window_names}

    def one_step(tf32=None):
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            out, _ = stepper.predict(ic, forcing)
        return torch.stack([out[k] for k in sorted(out)]).nan_to_num(0.0)

    gated = one_step(False)
    tf32 = one_step(True)
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.yaml")], device="cuda")
    entry = one_step()
    scale = float(gated.abs().max())
    errs = [float((x - gated).abs().max()) / scale for x in (tf32, entry)]
    print(f"Samudra step, TF32 on vs off: {errs[0]:.3g} of the largest "
          f"output; after the entry picked its device: {errs[1]:.3g}")
    assert not torch.backends.cudnn.allow_tf32
    assert errs[0] > 1e-5
    assert errs[1] <= 1e-6


def test_reference_n_runs_on_the_card(cuda):
    """``chip_smoke.py``'s reference phase N: ``DiscoConvS2`` at ragged
    shapes (odd nlat, a downsampling; piecewise linear and Zernike) and a
    small FCN3 of the recipe's shape (32x64, 2 levels with a diagnostic in
    each, 4 layers) card against CPU: one forward step and one MSE train
    step within reference S's float32 limits, no kernel launch."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.reference_fcn3_phase([dhconv_filter, dhconv_filter_dx,
                                     dhconv_filter_dw])


def test_reference_l_runs_on_the_card(cuda):
    """``chip_smoke.py``'s reference phase L: the bf16 conditional SFNO
    with local blocks, LoRA, ``spectral_ratio`` 0.5 and labels (K1, 1b and
    1c at spectral width 32), float32 with the global layer norm,
    LocalNet and AnkurLocalNet, card against CPU: a 2-step rollout (its
    second step against the CPU's step from the card's first) and an MSE
    train step, exact launch counts."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.reference_local_phase([dhconv_filter, dhconv_filter_dx,
                                      dhconv_filter_dw, fused_block_tail])


@pytest.mark.parametrize("basis", ["piecewise linear", "morlet",
                                   "zernike"])
def test_disco_on_card_matches_cpu(cuda, basis):
    """``DiscoConvS2`` and its gradient with respect to the input at the
    recipe's decoder shape cut to 2 channels (180x360 to itself, morlet
    3x3) and at an odd downsampling: within 1e-5 of the largest value."""
    from ace_tpu_torch.ops.disco import DiscoConvS2

    gen = torch.Generator().manual_seed(2)
    for in_shape, out_shape in (((180, 360), (180, 360)),
                                ((45, 90), (15, 30))):
        conv = DiscoConvS2(in_shape, out_shape, (3, 3),
                           grid_in="legendre-gauss",
                           grid_out="legendre-gauss", basis_type=basis)
        x = torch.randn(2, *in_shape, 2, generator=gen)
        w = torch.randn(2, *out_shape, conv.kernel_size, 2, generator=gen)
        outs = []
        for dev in ("cpu", cuda):
            xd = x.detach().to(dev).requires_grad_()
            out = conv.to(dev)(xd)
            (out * w.to(dev)).sum().backward()
            outs.append((out.detach().cpu(), xd.grad.cpu()))
        for ref, got in zip(*outs):
            assert got.shape == ref.shape
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= 1e-5, (in_shape, err)


def test_reference_h_runs_on_the_card(cuda):
    """``chip_smoke.py``'s reference phase H: the HEALPix pad at p = 1-3
    (equal to the CPU), the nside-64 transforms against float64, a
    band-limited round trip, the winds at 180x360 against float64, then
    three small HEALPixUNets over every block type (a forward step and an
    MSE train step) and an ensemble-loss train step on the HEALPix SHT,
    card against CPU within reference S's float32 limits, no launch."""
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.reference_healpix_phase([dhconv_filter, dhconv_filter_dx,
                                        dhconv_filter_dw])


@pytest.mark.parametrize("p", [1, 2, 3])
def test_healpix_pad_gradient_on_card_matches_cpu(cuda, p):
    """The pad's backward (``index_select``'s: an ``index_add`` of each
    padded cell into its sources, the corners' halves too) at nside 64
    and 32 channels: within 1e-6 of the largest gradient."""
    from ace_tpu_torch.models.healpix import healpix_pad

    gen = torch.Generator().manual_seed(p)
    x = torch.randn(2, 12, 64, 64, 32, generator=gen)
    w = torch.randn(2, 12, 64 + 2 * p, 64 + 2 * p, 32, generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        (healpix_pad(xd, p) * w.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    assert err <= 1e-6, err


def test_graphcast_segment_sum_is_deterministic_on_the_card(cuda):
    """GraphCast's segment sum at path G's mesh size (the 322,560 directed
    edges of the merged meshes 4-6 into their 40,962 nodes, two samples
    of 256 channels) gives the same bits on every run, equals a float64
    sum within float32 rounding, and so do the gathers' gradients; the
    library's ``index_add_`` (atomics) is shown beside it (``-s``)."""
    import numpy as np

    from ace_tpu_torch.models import graphcast as gcast

    hierarchy = gcast.get_mesh_hierarchy(6)[4:]
    senders, receivers = gcast.faces_to_edges(
        gcast.merge_meshes(hierarchy).faces)
    n = len(hierarchy[-1].vertices)
    module = torch.nn.Module()
    seg = gcast.Segments(module, "receivers", receivers, n, device=cuda)
    index, order, lengths = seg.tensors(module)
    gen = torch.Generator(cuda).manual_seed(0)
    values = torch.randn(2, len(receivers), 256, generator=gen, device=cuda)
    runs = [gcast.segment_sum(values, order, lengths) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = torch.zeros(2, n, 256, dtype=torch.float64, device=cuda).index_add_(
        1, index, values.double())
    assert float((runs[0].double() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())
    nodes = torch.randn(2, n, 256, generator=gen, device=cuda)
    grads = []
    for _ in range(2):
        x = nodes.clone().requires_grad_()
        gcast.gather(x, index, order, lengths).backward(values)
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    atomics = [torch.zeros(2, n, 256, device=cuda).index_add_(1, index, values)
               for _ in range(3)]
    differ = sum(not torch.equal(atomics[0], a) for a in atomics[1:])
    print(f"segment sum over {len(receivers)} edges into {n} nodes: 3 runs "
          f"equal; index_add_ runs that differ from its first: {differ} of "
          f"2 (largest difference "
          f"{float((atomics[0] - atomics[1]).abs().max()):.3g})")
    assert np.array_equal(np.bincount(receivers, minlength=n),
                          lengths.cpu().numpy())


def test_a_swin_train_step_is_float32_after_the_entry_picks_its_device(
        cuda, tmp_path):
    """A small Swin train step (reference W's first net) with TF32 on
    differs from the gated float32 step; after the training entry picks
    its device (its ``main``, stopped at a missing config), the same step
    equals the gated one. Prints the readings (``-s``)."""
    import chip_smoke
    from ace_tpu_torch import flagship
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper
    from ace_tpu_torch.train.train import main

    builder, labelled = chip_smoke.W_REFERENCE["cln-cosl-earth"]
    config, info = chip_smoke.swin_stepper_config(builder, labelled)
    ts = TrainStepper(
        config.get_stepper(info, device=cuda),
        StepperTrainConfig(n_forward_steps=1, loss=from_dict(
            StepLossConfig, {"type": "MSE"})),
        OptimizationConfig(lr=1e-4, optimizer_type="AdamW"), EMAConfig())
    flagship.draw_check_weights(ts.stepper, torch.Generator(cuda).manual_seed(0))
    batch = flagship.synthetic_batch(ts.stepper, 2, generator=torch.Generator(
        cuda).manual_seed(1))

    def step(tf32=None):
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        loss, grads = flagship.train_gradients(
            ts, batch, generator=torch.Generator(cuda).manual_seed(2))
        return loss, torch.cat([g.flatten() for g in grads.values()])

    gated = step(False)
    tf32 = step(True)
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.yaml")], device="cuda")
    entry = step()
    errs = [float((x[1] - gated[1]).norm() / gated[1].norm())
            for x in (tf32, entry)]
    print(f"Swin train step, TF32 on vs off: gradients {errs[0]:.3g} "
          f"relative L2; after the entry picked its device: {errs[1]:.3g}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert errs[0] > 1e-6
    assert errs[1] == 0.0 and torch.equal(entry[0], gated[0])


def test_a_songunet_train_step_is_float32_after_the_entry_picks_its_device(
        cuda, tmp_path):
    """A small SongUNet diffusion model's EDM loss gradients (reference
    D's first net, fixed sigma and noise) with TF32 on differ from the
    gated float32 ones; after the downscaling training entry picks its
    device (its ``main``, stopped at a missing config), they equal the
    gated ones. Prints the readings (``-s``)."""
    import numpy as np

    import chip_smoke
    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.downscaling.models import DiffusionModelConfig
    from ace_tpu_torch.downscaling.train import main
    from ace_tpu_torch.models.layers import init_weights

    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        lat=np.linspace(-40.0, 40.0, 16), lon=np.linspace(0.0, 350.0, 16)))
    model = from_dict(DiffusionModelConfig, {
        "in_names": ["a"], "out_names": ["a"],
        "normalization": {"coarse": {"means": {"a": 0.0},
                                     "stds": {"a": 1.0}},
                          "fine": {"means": {"a": 0.0}, "stds": {"a": 1.0}}},
        "module": chip_smoke.D_REFERENCE["song-standard"],
        "downscale_factor": 2}).build(info, device=cuda)
    init_weights(model.net, torch.Generator(cuda).manual_seed(0))
    gen = torch.Generator(cuda).manual_seed(1)
    coarse = {"a": torch.randn(2, 16, 16, generator=gen, device=cuda)}
    fine = {"a": torch.randn(2, 32, 32, generator=gen, device=cuda)}
    sigma = torch.tensor([0.5, 4.0], device=cuda)
    noise = torch.randn(2, 32, 32, 1, generator=gen, device=cuda)

    def step(tf32=None):
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        loss = model.loss_fn(coarse, fine, sigma=sigma, noise=noise)
        grads = torch.autograd.grad(loss, list(model.net.parameters()))
        return loss, torch.cat([g.flatten() for g in grads])

    gated = step(False)
    tf32 = step(True)
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "missing.yaml")], device="cuda")
    entry = step()
    errs = [float((x[1] - gated[1]).norm() / gated[1].norm())
            for x in (tf32, entry)]
    print(f"SongUNet EDM step, TF32 on vs off: gradients {errs[0]:.3g} "
          f"relative L2; after the entry: {errs[1]:.3g}")
    # cuDNN's weight gradients may sum in another order from run to run:
    # float32 rounding, far below TF32's
    assert errs[0] > 1e-4 and errs[1] <= 1e-6
