"""Where the time of kernel 1c (the dhconv filter's weight gradient) goes
on the GPU.

    python -m ace_tpu_torch.profile_dhconv_dw [VARIANT ...]

Times ``dhconv_filter_dw`` with CUDA events at the flagship training shape
(x ``[4, 180, 181, 512]``, O = 512), for the kernel as built from
``csrc/dhconv_filter_dw.cu`` and for each named variant: a copy of that
source with a part compiled out, built beside it under
``build/kernels/variants/``. A variant is one name of ``VARIANTS`` or
several joined by ``+``. Variants compute wrong results on purpose; they
show what each part costs, not what the kernel returns. Beside them, one
bf16 ``torch.matmul`` of the same function (the stacked real form). All
run on one card, in turns, twice.
"""

import argparse
import ctypes
import subprocess

import torch

from ace_tpu_torch.device import get_device
from ace_tpu_torch.ops import dhconv_filter as k1
from ace_tpu_torch.ops import kernel_build

# (text of the source, its replacement) pairs of each variant
VARIANTS = {
    # no products: the TMA feed, the ring's barriers and the epilogue (the
    # A fragments feed only the products, so their reads go too)
    "nomma": [
        ("          wgmma_rs<1>(acc_r, ar, dgr, sd);\n"
         "          wgmma_rs<1>(acc_r, ai, dgi, 1);\n"
         "          wgmma_rs<1>(acc_i, ar, dgi, sd);\n"
         "          wgmma_rs<-1>(acc_i, ai, dgr, 1);\n", ""),
    ],
    # no loads: the producer only arrives on each stage's barrier, and the
    # consumers read fragments and multiply whatever the ring holds
    "noload": [
        ("mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "mbar_arrive(&full[stage]);"),
        ("tma_load_4d(s", "if (0) tma_load_4d(s"),
    ],
    # no output stores
    "nostore": [
        ("            tma_store_3d(&map_dw",
         "            if (0) tma_store_3d(&map_dw"),
    ],
}


def variant_source(name: str) -> str:
    """The kernel source with the edits of variant ``name`` applied."""
    source = (kernel_build.CSRC_DIR / k1.DW_SOURCE).read_text()
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if old not in source:
                raise ValueError(f"variant {part}: the source has no {old!r}")
            source = source.replace(old, new)
    return source


def cuda_ms(fn, iters=20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*",
                        help="names of VARIANTS, or several joined by +")
    args = parser.parse_args(argv)
    for name in args.variants:
        variant_source(name)  # unknown names and stale edits fail here

    device = get_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    libs = {"kernel": kernel_build.load(k1.DW_SOURCE)}
    libs.update(kernel_build.build_variants(
        k1.DW_SOURCE, {n: variant_source(n) for n in args.variants}))
    gen = torch.Generator(device).manual_seed(0)
    b, l, m, i, o = 4, 180, 181, 512, 512
    xr, xi = (torch.randn(b, l, m, i, generator=gen, device=device)
              for _ in range(2))
    gr, gi = (torch.randn(b, l, m, o, generator=gen, device=device)
              .to(torch.bfloat16) for _ in range(2))
    # dW = [x_r; x_i]^T @ [[g_r, g_i], [g_i, -g_r]] per l, over b and m
    x_st = torch.cat([xr, xi], dim=2).to(torch.bfloat16).permute(
        1, 3, 0, 2).reshape(l, i, 2 * b * m).contiguous()
    g_st = torch.cat([torch.cat([gr, gi], dim=-1),
                      torch.cat([gi, -gr], dim=-1)], dim=2).permute(
        1, 0, 2, 3).reshape(l, 2 * b * m, 2 * o).contiguous()
    for _ in range(2):
        print(f"{'library (bf16 matmul)':24s} "
              f"{cuda_ms(lambda: torch.matmul(x_st, g_st)):.4f} ms")
        for name, lib in libs.items():
            # the wrapper loads the library it finds in the cache
            kernel_build._LIBRARIES[k1.DW_SOURCE] = lib
            k1._dw_library()
            ms = cuda_ms(lambda: k1.dhconv_filter_dw(xr, xi, gr, gi))
            print(f"{name:24s} {ms:.4f} ms")
    kernel_build._LIBRARIES[k1.DW_SOURCE] = libs["kernel"]


if __name__ == "__main__":
    main()
