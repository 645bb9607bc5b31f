"""The dhconv filter of the port: its plain version against the JAX
package's Pallas kernel (run in the interpreter) and the wrapper's
checks. The CUDA kernel itself is held against the plain version on a
card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.ops.pallas_filter import dhconv_filter as jax_dhconv_filter
from ace_tpu_torch.ops.dhconv_filter import (
    dhconv_filter,
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
        error = NotImplementedError
    else:
        wr, wi = wr[:, :-1], wi[:, :-1]
        error = ValueError
    with pytest.raises(error):
        dhconv_filter(xr, xi, wr, wi)


def _source_constant(name):
    """An ``int`` constexpr of the kernel source, as the compiler sees it."""
    import re
    from ace_tpu_torch.ops import dhconv_filter as module
    from ace_tpu_torch.ops.kernel_build import CSRC_DIR

    text = (CSRC_DIR / module.SOURCE).read_text()
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
