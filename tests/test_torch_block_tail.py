"""The port's fused block tail (kernel K2's plain version, the fused
branch of ConditionalFNOBlock and a fused NoiseConditionedSFNO) against
ace_tpu's fused tail, run in the Pallas interpreter on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.models import conditional_sfno as jax_csfno
from ace_tpu.ops import pallas_block as jax_block
from ace_tpu.ops import sht as jax_sht
from ace_tpu_torch.models import conditional_sfno
from ace_tpu_torch.ops import fused_block_tail as tail
from ace_tpu_torch.ops import sht
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

torch.set_num_threads(2)

C, HID, NC = 128, 256, 4
NLAT, NLON = 16, 32
# bf16 rounds at other points in the two frameworks (JAX rounds each
# elementwise op of GELU, PyTorch computes GELU in f32 and rounds once),
# with four rounding points between the products. The JAX package holds
# its fused tail to 2e-2 of the largest output (tests/test_pallas_block.py);
# these cases differ by 0.2-0.6%, so 1e-2 holds with room for another
# summation order
TOL = 1e-2


def _weights(rng, c=C, hid=HID, nc=NC, scale=0.05):
    def r(*s):
        return (rng.randn(*s) * scale).astype(np.float32)

    return (
        r(c, c), r(c), 1.0 + 0.1 * r(c), 0.1 * r(c), r(nc, c), r(nc, c),
        r(c, hid), r(hid), r(hid, c), r(c),
    )


def _close(out, ref, tol):
    out = np.asarray(out.detach().float().numpy() if isinstance(
        out, torch.Tensor) else out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.max(np.abs(out - ref)))
    scale = float(np.max(np.abs(ref)))
    print(f"error over the largest output: {err / scale:.3g}")
    assert err <= tol * scale, (err, tol * scale)


def test_plain_matches_ace_tpu_fused_tail():
    """Rows 2 x 16 x 32, C=128, hidden 256, noise 4: the same products
    on bf16 operands with f32 sums; only GELU's internal rounding
    differs."""
    rng = np.random.RandomState(0)
    shape = (2, NLAT, NLON)
    xf = rng.randn(*shape, C).astype(np.float32)
    resid = rng.randn(*shape, C).astype(np.float32)
    noise = rng.randn(*shape, NC).astype(np.float32)
    w = _weights(rng)
    out_j = jax_block.fused_block_tail(
        jnp.asarray(xf, jnp.bfloat16), jnp.asarray(resid, jnp.bfloat16),
        jnp.asarray(noise), tuple(jnp.asarray(a) for a in w), interpret=True,
    )
    out = tail.fused_block_tail(
        torch.from_numpy(xf).to(torch.bfloat16),
        torch.from_numpy(resid).to(torch.bfloat16),
        torch.from_numpy(noise), tuple(torch.from_numpy(a) for a in w),
    )
    assert out.dtype == torch.bfloat16 and out.shape == (*shape, C)
    _close(out, np.asarray(out_j, np.float32), TOL)


def _jax_block(affine):
    return jax_csfno.ConditionalFNOBlock(
        forward_transform=jax_sht.RealSHT(NLAT, NLON, channels_last=True),
        inverse_transform=jax_sht.InverseRealSHT(NLAT, NLON,
                                                 channels_last=True),
        embed_dim=C, embed_dim_noise=NC, affine_norms=affine,
        dtype=jnp.bfloat16,
    )


def _port_block(affine):
    return conditional_sfno.ConditionalFNOBlock(
        sht.RealSHT(NLAT, NLON, device="cpu"),
        sht.InverseRealSHT(NLAT, NLON, device="cpu"),
        C, NC, affine_norms=affine, dtype=torch.bfloat16, device="cpu",
    )


def _perturb(params, seed=1):
    """Random values for the zero-initialized conditioning kernels and
    the affine norms, so that every tail weight shows in the output."""
    rng = np.random.RandomState(seed)

    def visit(path, leaf):
        name = "/".join(str(p.key) for p in path)
        if "w_scale_2d" in name or "w_bias_2d" in name:
            return jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        if "norm" in name and leaf.ndim == 1:
            return leaf + jnp.asarray(rng.randn(*leaf.shape) * 0.1, leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def _block_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, NLAT, NLON, C).astype(np.float32)
    noise = rng.randn(2, NLAT, NLON, NC).astype(np.float32)
    return x, noise


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain_norms"])
def test_fused_block_matches_ace_tpu_fused_block(affine, monkeypatch):
    """The JAX block's fused-branch parameter tree converts with the same
    converter as the module tree (the trees are the same), and the port's
    fused block agrees with it."""
    monkeypatch.setenv("ACE_TPU_PALLAS_BLOCK", "interpret")
    monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    x, noise = _block_inputs()
    xj = jnp.asarray(x, jnp.bfloat16)
    block_j = _jax_block(affine)
    params = _perturb(block_j.init(jax.random.PRNGKey(0), xj,
                                  jnp.asarray(noise)))
    out_j = block_j.apply(params, xj, jnp.asarray(noise))

    block = _port_block(affine)
    block.load_state_dict(flax_params_to_state_dict(params))
    block.fused_tail = True
    before = tail.fused_block_tail.launches
    with torch.inference_mode():
        out = block(torch.from_numpy(x).to(torch.bfloat16),
                    torch.from_numpy(noise))
    # the plain version ran (CPU tensors): nothing counted as a launch
    assert tail.fused_block_tail.launches == before
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(out_j, np.float32), TOL)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain_norms"])
def test_fused_block_matches_unfused_block(affine):
    """One state_dict, both branches of the port's block: the same math
    with the same rounding points but for the dense layers (the unfused
    Linear adds its bias before rounding), so well inside TOL."""
    x, noise = _block_inputs(1)
    block = _port_block(affine)
    gen = torch.Generator().manual_seed(0)
    from ace_tpu_torch.models.layers import init_weights

    init_weights(block, gen)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "w_scale_2d" in name or "w_bias_2d" in name:
                p.normal_(std=0.1, generator=gen)
            elif name.endswith("bias"):
                p.normal_(std=0.05, generator=gen)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    nz = torch.from_numpy(noise)
    keys = set(block.state_dict())
    with torch.inference_mode():
        ref = block(xb, nz)
        block.fused_tail = True
        out = block(xb, nz)
    assert set(block.state_dict()) == keys
    assert not torch.equal(out, ref)  # the fused branch did run
    _close(out, ref.float().numpy(), TOL)


def test_fused_tail_gate():
    """float32 activations or no noise leave the block on the unfused
    tail, whatever ``fused_tail`` says. Widths are not part of the gate:
    they are the kernel's limits, which its wrapper checks."""
    block = _port_block(True)
    block.fused_tail = True
    xf = torch.zeros(1, 2, 2, C, dtype=torch.bfloat16)
    assert block._fuses(xf, torch.zeros(1, 2, 2, NC))
    assert not block._fuses(xf.float(), torch.zeros(1, 2, 2, NC))
    assert not block._fuses(xf, None)
    block.fused_tail = False
    assert not block._fuses(xf, torch.zeros(1, 2, 2, NC))
    assert tail.tail_shapes_supported(512, 1024, 32)
    assert tail.tail_shapes_supported(192, 384, 32)  # off the TPU's lanes
    assert not tail.tail_shapes_supported(8, 16, 4)
    assert not tail.tail_shapes_supported(512, 1024, 0)
    assert not tail.tail_shapes_supported(1024, 2048, 32)  # over the smem


def test_fused_block_at_a_width_off_the_tpu_lanes():
    """Embed 192 (hidden 384) is no multiple of 128, which the TPU kernel
    needs; the port's block still takes the fused branch there, through
    the wrapper. The same state_dict on both branches, at TOL."""
    c = 192
    block = conditional_sfno.ConditionalFNOBlock(
        sht.RealSHT(NLAT, NLON, device="cpu"),
        sht.InverseRealSHT(NLAT, NLON, device="cpu"),
        c, NC, affine_norms=True, dtype=torch.bfloat16, device="cpu",
    )
    gen = torch.Generator().manual_seed(0)
    from ace_tpu_torch.models.layers import init_weights

    init_weights(block, gen)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "w_scale_2d" in name or "w_bias_2d" in name:
                p.normal_(std=0.1, generator=gen)
    rng = np.random.RandomState(2)
    xb = torch.from_numpy(
        rng.randn(1, NLAT, NLON, c).astype(np.float32)).to(torch.bfloat16)
    nz = torch.from_numpy(rng.randn(1, NLAT, NLON, NC).astype(np.float32))
    with torch.inference_mode():
        ref = block(xb, nz)
        block.fused_tail = True
        assert block._fuses(xb, nz)
        out = block(xb, nz)
    assert not torch.equal(out, ref)  # the fused branch did run
    _close(out, ref.float().numpy(), TOL)


def _model_kwargs(layers=2):
    return dict(
        img_shape=(NLAT, NLON), in_chans=5, out_chans=4, embed_dim=C,
        noise_embed_dim=NC, noise_type="isotropic", num_layers=layers,
        affine_norms=True, normalize_big_skip=True,
    )


def test_noise_conditioned_sfno_fused_matches_ace_tpu(monkeypatch):
    """A 2-layer bf16 model with the fused tail against the JAX model
    with its fused tail, on converted weights and the same noise."""
    monkeypatch.setenv("ACE_TPU_PALLAS_BLOCK", "interpret")
    monkeypatch.setenv("ACE_TPU_PALLAS_FILTER", "interpret")
    rng = np.random.RandomState(0)
    x = rng.randn(2, NLAT, NLON, 5).astype(np.float32)
    noise = rng.randn(2, NLAT, NLON, NC).astype(np.float32)
    monkeypatch.setattr(
        jax_csfno.NoiseConditionedSFNO, "_make_noise",
        lambda self, batch: jnp.asarray(noise),
    )
    model_j = jax_csfno.NoiseConditionedSFNO(**_model_kwargs(),
                                             dtype=jnp.bfloat16)
    params = _perturb(model_j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    out_j = model_j.apply(params, jnp.asarray(x))

    model = conditional_sfno.NoiseConditionedSFNO(
        **_model_kwargs(), dtype=torch.bfloat16, device="cpu"
    )
    keys = set(model.state_dict())
    model.load_state_dict(flax_params_to_state_dict(params))
    assert model.use_fused_block_tail(True) is model
    assert set(model.state_dict()) == keys
    assert all(getattr(model, f"block_{i}").fused_tail for i in range(2))
    with torch.inference_mode():
        out = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert out.dtype == torch.float32
    _close(out, out_j, TOL)


def test_flagship_fused_tail_is_an_argument_default_off():
    from ace_tpu_torch import flagship

    def blocks(stepper):
        m = stepper.module
        return [getattr(m, f"block_{i}").fused_tail
                for i in range(m.num_layers)]

    off = flagship.build_stepper(16, 32, nz=2, embed=128, layers=2,
                                 device="cpu")
    on = flagship.build_stepper(16, 32, nz=2, embed=128, layers=2,
                                device="cpu", fused_block_tail=True)
    assert blocks(off) == [False, False] and blocks(on) == [True, True]
    assert set(off.module.state_dict()) == set(on.module.state_dict())
    # the same weights give the same outputs within TOL on both branches
    flagship.draw_check_weights(off, torch.Generator().manual_seed(0))
    on.load_state_dict(off.module.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 32, off.module.in_chans, generator=gen)
    noise = off.module.make_noise(1, gen)
    with torch.inference_mode():
        ref = off.module(x, noise=noise)
        out = on.module(x, noise=noise)
    assert flagship.anomaly_error(out, ref, (1, 2)) <= flagship.CHECK_TOL


def _tail_args(requires_grad=False, device="cpu"):
    rng = np.random.RandomState(3)
    w = tuple(torch.from_numpy(a).to(device) for a in _weights(rng))
    xf = torch.zeros(4, C, dtype=torch.bfloat16, device=device)
    noise = torch.zeros(4, NC, device=device)
    if requires_grad:
        w = (w[0].requires_grad_(),) + w[1:]
    return xf, xf.clone(), noise, w


def test_wrapper_refuses_grad():
    """Tensors that require grad used to be refused (the tail had no
    backward); now they go through the autograd Function, whose backward
    is the plain tail's VJP. What it still refuses is a second derivative
    through that backward."""
    xf, resid, noise, w = _tail_args(requires_grad=True)
    before = tail.fused_block_tail.launches
    out = tail.fused_block_tail(xf, resid, noise, w)
    assert out.requires_grad and tail.fused_block_tail.launches == before
    (g,) = torch.autograd.grad(out.float().sum(), w[0], create_graph=True)
    with pytest.raises(RuntimeError, match="does not require grad"):
        g.sum().backward()


def _tail_f32(xf, resid, noise, weights):
    """The tail's math in float32 throughout (no bf16 rounding points)."""
    (skip_k, skip_b, ln_w, ln_b, ws, wb, fc1_k, fc1_b, fc2_k,
     fc2_b) = weights
    xf, resid = xf.float(), resid.float()
    t = torch.nn.functional.gelu(xf + resid @ skip_k + skip_b,
                                 approximate="tanh")
    y = torch.nn.functional.layer_norm(t, t.shape[-1:], eps=tail.EPS)
    y = (y * ln_w + ln_b) * (1.0 + noise @ ws) + noise @ wb
    h = torch.nn.functional.gelu(y @ fc1_k + fc1_b, approximate="tanh")
    return h @ fc2_k + fc2_b + resid


# the tail's per-channel weights whose gradient is a sum over the rows:
# ace_tpu's VJP sums them in bf16 (XLA:CPU rounds every partial sum of a
# bf16 reduce to bf16), 3.7-5.2% off the tail's float32 VJP here, where the
# port sums in float32 (below 1%)
ROW_SUMS = ("skip_b", "ln_w", "ln_b", "fc1_b", "fc2_b")
TAIL_INPUTS = ("xf", "resid", "noise", "skip_k", "skip_b", "ln_w", "ln_b",
               "w_s", "w_b", "fc1_k", "fc1_b", "fc2_k", "fc2_b")


def test_tail_gradients_match_ace_tpu_vjp():
    """The Function's gradients for every input (f32 weights: the
    gradients the parameters receive) against jax.vjp of ace_tpu's fused
    tail in the interpreter, whose backward is the VJP of its plain tail:
    bf16 cotangents rounded at other points, so 2e-2 of each gradient's
    largest value. Every gradient is held within 2e-2 of the tail's
    float32 VJP (measured up to 1.5e-2), and every one outside
    ``ROW_SUMS`` within 2e-2 of ace_tpu's (1.1e-2 measured). Those in
    ``ROW_SUMS`` are XLA's bf16 sums: the fc2 bias gradient of ace_tpu is
    bit for bit XLA's bf16 reduce of the bf16 cotangent over the rows,
    3.7% off its float32 sum, where torch's sum of the same bf16 values
    is 0.26% off."""
    rng = np.random.RandomState(5)
    shape = (2, 8, NLON)
    xf = rng.randn(*shape, C).astype(np.float32)
    resid = rng.randn(*shape, C).astype(np.float32)
    noise = rng.randn(*shape, NC).astype(np.float32)
    w = _weights(rng, scale=0.1)
    g = rng.randn(*shape, C).astype(np.float32)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(
        lambda a, b, c, d: jax_block.fused_block_tail(a, b, c, d,
                                                      interpret=True),
        jnp.asarray(xf, bf), jnp.asarray(resid, bf), jnp.asarray(noise),
        tuple(jnp.asarray(a) for a in w),
    )
    dxf, dresid, dnoise, dw = vjp(jnp.asarray(g, bf))
    inputs = [torch.from_numpy(xf).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(resid).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(noise).requires_grad_()]
    weights = [torch.from_numpy(a).requires_grad_() for a in w]
    out = tail.fused_block_tail(*inputs, tuple(weights))
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    exact = [t.detach().float().requires_grad_() for t in inputs + weights]
    _tail_f32(exact[0], exact[1], exact[2], exact[3:]).backward(
        torch.from_numpy(g))

    def err(a, b):
        a, b = (np.asarray(t, np.float64) for t in (a, b))
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    refs = dict(zip(TAIL_INPUTS, (dxf, dresid, dnoise, *dw)))
    for name, t, e in zip(TAIL_INPUTS, inputs + weights, exact):
        assert t.grad.dtype == t.dtype
        ours = t.grad.float().numpy()
        assert err(ours, e.grad.numpy()) <= 2e-2, name
        if name not in ROW_SUMS:
            ref = np.asarray(refs[name], np.float32)
            assert err(ours, ref) <= 2e-2, name
    # the witness: XLA's bf16 reduce of the cotangent is ace_tpu's fc2 bias
    # gradient, and torch's sum of the same bf16 values is not off
    g_bf = jnp.asarray(g, bf)
    (xla_sum,) = jax.vjp(lambda b: jnp.zeros(g_bf.shape, bf) + b.astype(bf),
                         jnp.zeros(C))[1](g_bf)
    np.testing.assert_array_equal(np.asarray(xla_sum), np.asarray(dw[9]))
    f32_sum = exact[-1].grad.numpy()
    assert err(xla_sum, f32_sum) > 3e-2
    torch_sum = torch.from_numpy(g).to(torch.bfloat16).reshape(-1, C).sum(0)
    assert err(torch_sum.float().numpy(), f32_sum) <= 5e-3


def test_wrapper_refuses_devices_other_than_cpu_and_cuda():
    with pytest.raises(NotImplementedError, match="no kernel"):
        tail.fused_block_tail(*_tail_args(device="meta"))


def test_wrapper_refuses_mismatched_shapes():
    xf, resid, noise, w = _tail_args()
    with pytest.raises(ValueError):
        tail.fused_block_tail(xf, resid[:2], noise, w)
    with pytest.raises(ValueError):
        tail.fused_block_tail(xf, resid, noise, w[:9])
    with pytest.raises(ValueError):
        tail.fused_block_tail(xf, resid, noise, (w[0][:, :64],) + w[1:])


def _source_constant(name):
    """An ``int`` constexpr of the kernel source, as the compiler sees it."""
    import re
    from ace_tpu_torch.ops.kernel_build import CSRC_DIR

    text = (CSRC_DIR / tail.SOURCE).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize(
    "shape", [(512, 1024, 32), (192, 384, 33), (64, 64, 1), (128, 256, 200)]
)
def test_smem_bytes_follow_the_kernel_source(shape):
    """``tail_smem_bytes`` is the layout the kernel carves: 1 KB to align
    the swizzled tiles, the ring, the 64-row t/y tile, the second tile (at
    least one 256-column hidden chunk, or the noise padded to 64) and ten
    barriers; the hidden width does not enter."""
    c, hidden, nc = shape
    rows, stages = _source_constant("ROWS"), _source_constant("STAGES")
    stage, chunk = _source_constant("STAGE_BYTES"), _source_constant("HC")
    assert (rows, stages, stage, chunk) == (
        tail.ROWS, tail.STAGES, tail.STAGE_BYTES, tail.HIDDEN_CHUNK)
    second = max(c, -(-nc // 64) * 64, chunk)
    want = 1024 + stages * stage + rows * 2 * (c + second) + 10 * 8
    assert tail.tail_smem_bytes(c, hidden, nc) == want
    assert tail.tail_smem_bytes(c, 4 * hidden, nc) == want


def test_smem_bytes_at_the_flagship_match_the_source_note():
    from ace_tpu_torch.ops.kernel_build import CSRC_DIR

    note = (CSRC_DIR / tail.SOURCE).read_text()
    assert "230,480 bytes at C = 512" in note
    assert tail.tail_smem_bytes(512, 1024, 32) == 230480 <= tail.MAX_SMEM
