"""The DISCO constructor (port of ace_tpu/ops/distributed_disco.py). The
port has no spatial mesh yet (the entries refuse ``mesh:`` with ``h * w >
1``), so
``build_disco`` builds the single-device ``DiscoConvS2``; the all-to-all
distributed convolution is not ported."""

from ace_tpu_torch.ops.disco import DiscoConvS2


def build_disco(in_shape, out_shape, kernel_shape,
                grid_in="equiangular", grid_out="equiangular",
                theta_cutoff=None, basis_norm_mode="mean",
                basis_type="piecewise linear", device=None) -> DiscoConvS2:
    """The DISCO contraction (port of ace_tpu/ops/distributed_disco.py:243,
    its single-device branch)."""
    return DiscoConvS2(
        in_shape, out_shape, kernel_shape,
        grid_in=grid_in, grid_out=grid_out,
        theta_cutoff=theta_cutoff, basis_norm_mode=basis_norm_mode,
        basis_type=basis_type, device=device,
    )
