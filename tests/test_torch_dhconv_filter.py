"""The dhconv filter of the port: its plain version against the JAX
package's Pallas kernel (run in the interpreter) and the wrapper's
checks. The CUDA kernel itself is held against the plain version on a
card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from ace_tpu.ops.pallas_filter import _bwd as jax_filter_bwd
from ace_tpu.ops.pallas_filter import dhconv_filter as jax_dhconv_filter
from ace_tpu_torch.ops.dhconv_filter import (
    dhconv_filter,
    dhconv_filter_bwd_plain,
    dhconv_filter_dw,
    dhconv_filter_dx,
    dhconv_filter_param,
    dhconv_filter_plain,
)

torch.set_num_threads(2)

L, M, I, O = 5, 12, 128, 128


def _inputs(batch=2, l=L, m=M, i=I, o=O):
    rng = np.random.RandomState(0)
    xr = rng.randn(batch, l, m, i).astype(np.float32)
    xi = rng.randn(batch, l, m, i).astype(np.float32)
    wr = (rng.randn(l, i, o) * 0.02).astype(np.float32)
    wi = (rng.randn(l, i, o) * 0.02).astype(np.float32)
    return xr, xi, wr, wi


def _bf16(w):
    return torch.from_numpy(w).to(torch.bfloat16)


def test_plain_matches_jax_kernel_bf16_out():
    """Same bf16 operands and f32 accumulation; the outputs differ by the
    final bf16 rounding only (atol 8e-3 of the largest output)."""
    xr, xi, wr, wi = _inputs()
    outr_j, outi_j = jax_dhconv_filter(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr, jnp.bfloat16),
        jnp.asarray(wi, jnp.bfloat16), interpret=True,
    )
    outr, outi = dhconv_filter_plain(
        torch.from_numpy(xr), torch.from_numpy(xi), _bf16(wr), _bf16(wi)
    )
    assert outr.dtype == torch.bfloat16
    for out, ref in ((outr, outr_j), (outi, outi_j)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(
            out.float().numpy(), ref, rtol=0,
            atol=float(np.max(np.abs(ref))) * 8e-3,
        )


def test_plain_matches_jax_kernel_f32_out():
    """With f32 outputs only the summation order differs (1e-6)."""
    xr, xi, wr, wi = _inputs(batch=1)
    outr_j, outi_j = jax_dhconv_filter(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr, jnp.bfloat16),
        jnp.asarray(wi, jnp.bfloat16), out_dtype=jnp.float32, interpret=True,
    )
    outr, outi = dhconv_filter_plain(
        torch.from_numpy(xr), torch.from_numpy(xi), _bf16(wr), _bf16(wi),
        out_dtype=torch.float32,
    )
    np.testing.assert_allclose(outr.numpy(), np.asarray(outr_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outi.numpy(), np.asarray(outi_j),
                               rtol=1e-6, atol=1e-6)


def test_wrapper_uses_plain_version_on_cpu():
    xr, xi, wr, wi = (torch.from_numpy(a) for a in _inputs(batch=1))
    wr, wi = wr.to(torch.bfloat16), wi.to(torch.bfloat16)
    before = dhconv_filter.launches
    out = dhconv_filter(xr, xi, wr, wi)
    ref = dhconv_filter_plain(xr, xi, wr, wi)
    assert dhconv_filter.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("misuse", ["x_bf16", "w_f32", "grad", "shape"])
def test_wrapper_refuses_misuse(misuse):
    """``grad``: tensors that require grad now go through the backward,
    which exists for the bf16 outputs of the AMP contract only."""
    xr, xi, wr, wi = (torch.from_numpy(a) for a in _inputs(batch=1))
    wr, wi = wr.to(torch.bfloat16), wi.to(torch.bfloat16)
    if misuse == "x_bf16":
        xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
        error = TypeError
    elif misuse == "w_f32":
        wr, wi = wr.float(), wi.float()
        error = TypeError
    elif misuse == "grad":
        xr.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="bfloat16 outputs"):
            dhconv_filter(xr, xi, wr, wi, out_dtype=torch.float32)
        return
    else:
        wr, wi = wr[:, :-1], wi[:, :-1]
        error = ValueError
    with pytest.raises(error):
        dhconv_filter(xr, xi, wr, wi)


def _cotangents(batch=2, l=L, m=M, o=O):
    rng = np.random.RandomState(7)
    return tuple(rng.randn(batch, l, m, o).astype(np.float32)
                 for _ in range(2))


def _f32_close(out, ref):
    """Exact bf16 products, f32 sums in another order: 1e-5 of the
    largest value."""
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def test_bwd_plain_matches_jax_bwd():
    """dhconv_filter_bwd_plain against ace_tpu's ``_bwd`` einsums."""
    xr, xi, wr, wi = _inputs()
    gr, gi = (g.astype(jnp.bfloat16) for g in map(jnp.asarray, _cotangents()))
    ref = jax_filter_bwd(jnp.bfloat16, True, tuple(
        jnp.asarray(a) for a in (xr, xi, wr, wi)), (gr, gi))
    out = dhconv_filter_bwd_plain(
        *(torch.from_numpy(a) for a in (xr, xi, wr, wi)),
        *(torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16)
          for g in (gr, gi)),
    )
    for a, r in zip(out, ref):
        assert a.dtype == torch.float32
        _f32_close(a, r)


@pytest.mark.parametrize("entry", ["lio", "param"])
def test_filter_gradients_match_jax_vjp(entry):
    """The autograd Function's gradients (the wrapper with f32 ``[L, I,
    O]`` weights, or ``dhconv_filter_param`` on the ``[2, L, I, O]``
    parameter) against jax.vjp of ace_tpu's kernel in the interpreter."""
    xr, xi, wr, wi = _inputs()
    gr, gi = _cotangents()
    bf = jnp.bfloat16
    _, vjp = jax.vjp(
        lambda a, b, c, d: jax_dhconv_filter(a, b, c, d, interpret=True),
        *(jnp.asarray(t) for t in (xr, xi, wr, wi)),
    )
    ref = vjp((jnp.asarray(gr, bf), jnp.asarray(gi, bf)))
    x = [torch.from_numpy(t).requires_grad_() for t in (xr, xi)]
    cot = [torch.from_numpy(g).to(torch.bfloat16) for g in (gr, gi)]
    if entry == "lio":
        w = [torch.from_numpy(t).requires_grad_() for t in (wr, wi)]
        out = dhconv_filter(*x, *w)
        torch.autograd.backward(out, cot)
        grads = [t.grad for t in x + w]
    else:
        weight = torch.stack([torch.from_numpy(t) for t in (wr, wi)])
        weight.requires_grad_()
        out = dhconv_filter_param(*x, weight)
        torch.autograd.backward(out, cot)
        grads = [t.grad for t in x] + list(weight.grad)
    assert all(o.dtype == torch.bfloat16 for o in out)
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float32
        _f32_close(g, r)


def test_backward_wrappers_use_plain_versions_on_cpu():
    xr, xi, wr, wi = (torch.from_numpy(a) for a in _inputs())
    gr, gi = (torch.from_numpy(g).to(torch.bfloat16) for g in _cotangents())
    before = (dhconv_filter_dx.launches, dhconv_filter_dw.launches)
    dxr, dxi = dhconv_filter_dx(gr, gi, wr.to(torch.bfloat16),
                                wi.to(torch.bfloat16))
    dw = dhconv_filter_dw(xr, xi, gr, gi)
    assert (dhconv_filter_dx.launches, dhconv_filter_dw.launches) == before
    assert dw.shape == (2, L, I, O) and dxr.shape == xr.shape
    ref = dhconv_filter_bwd_plain(xr, xi, wr, wi, gr, gi)
    for a, r in zip((dxr, dxi), ref[:2]):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    torch.testing.assert_close(dw, torch.stack(ref[2:]), rtol=0, atol=0)


def _source_constant(name, source=None):
    """An ``int`` constexpr of a kernel source (K1's by default), as the
    compiler sees it."""
    import re
    from ace_tpu_torch.ops import dhconv_filter as module
    from ace_tpu_torch.ops.kernel_build import CSRC_DIR

    text = (CSRC_DIR / (source or module.SOURCE)).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_filter_tiles_follow_the_kernel_source():
    """The wrapper's tile count (its grid check) uses the kernel's tile:
    three 64-row slabs and 128 output columns."""
    from ace_tpu_torch.ops import dhconv_filter as module

    assert module.BN == _source_constant("BN")
    assert module.ROWS == 64 * _source_constant("SLABS")
    assert module.filter_tiles(181, 512) == 4  # the flagship: 720 per call
    assert module.filter_tiles(192, 128) == 1
    assert module.filter_tiles(193, 129) == 4
    assert module.filter_tiles(1, 8) == 1


def test_dx_grid_check_follows_the_kernel_source():
    """1b's grid check counts its tiles with ``filter_tiles(M, I)``: 1b's
    tile is K1's, three 64-row slabs over M and 128 columns of dx (I)."""
    from ace_tpu_torch.ops import dhconv_filter as module

    source = module.BWD_SOURCE
    assert module.ROWS == 64 * _source_constant("SLABS", source)
    assert module.BN == _source_constant("BN", source)
    assert module.filter_tiles(181, 512) == 4  # 2,880 tiles at B = 4


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source, the shared ``csrc/*.cuh``
    headers and the flags: an edited header rebuilds every kernel."""
    from ace_tpu_torch.ops import kernel_build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    before = kernel_build.library_path("k.cu")
    assert kernel_build.library_path("k.cu") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernel_build.library_path("k.cu") != before
    assert kernel_build.library_path("k.cu").name.startswith("k-")


_VARIANTS = ["nomma", "noload", "nostore", "noload+nostore"]


@pytest.mark.parametrize(
    "kernel,name", [("dw", n) for n in _VARIANTS]
    + [("dx", n) for n in _VARIANTS],
    ids=_VARIANTS + [f"dx-{n}" for n in _VARIANTS],
)
def test_profile_variants_apply_to_the_dw_source(kernel, name):
    """Each variant of ``profile_dhconv_bwd`` finds the code it removes in
    its kernel's source (1c, ``dw``, and 1b, ``dx``), so the profile cannot
    time a stale edit."""
    from ace_tpu_torch import profile_dhconv_bwd
    from ace_tpu_torch.ops.kernel_build import CSRC_DIR

    source = (CSRC_DIR / profile_dhconv_bwd.SOURCES[kernel]).read_text()
    assert profile_dhconv_bwd.variant_source(name, kernel) != source
    with pytest.raises(KeyError):
        profile_dhconv_bwd.variant_source("nothing", kernel)
