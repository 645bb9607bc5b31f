"""Where the time of K1's backward kernels goes on the GPU: 1b (the dhconv
filter's input gradient) or 1c (its weight gradient).

    python -m ace_tpu_torch.profile_dhconv_bwd [--kernel dx|dw] [VARIANT ...]

Times ``dhconv_filter_dx`` (``--kernel dx``, from ``csrc/dhconv_filter_bwd.cu``)
or ``dhconv_filter_dw`` (``--kernel dw``, the default, from
``csrc/dhconv_filter_dw.cu``) with CUDA events at the flagship training
shape (g ``[4, 180, 181, 512]``, I = O = 512), for the kernel as built from
its source and for each named variant: a copy of that source with a part
compiled out, built beside it under ``build/kernels/variants/``. A variant
is one name of ``VARIANTS[kernel]`` or several joined by ``+``. Variants
compute wrong results on purpose; they show what each part costs, not
what the kernel returns. Beside them, one bf16 ``torch.matmul`` of the
same function (the stacked real form). All run on one card, in turns,
twice.
"""

import argparse
import subprocess

import torch

from ace_tpu_torch.device import get_device
from ace_tpu_torch.ops import dhconv_filter as k1
from ace_tpu_torch.ops import kernel_build

SOURCES = {"dx": k1.BWD_SOURCE, "dw": k1.DW_SOURCE}

# per kernel, (text of the source, its replacement) pairs of each variant
VARIANTS = {
    "dx": {
        # no products: the TMA feed, the ring's barriers and the epilogue
        "nomma": [
            ("          wgmma_ss<1>(acc_r, dgr, dwr, sd);\n"
             "          wgmma_ss<1>(acc_i, dgi, dwr, sd);\n"
             "          wgmma_ss<1>(acc_r, dgi, dwi, 1);\n"
             "          wgmma_ss<-1>(acc_i, dgr, dwi, 1);\n", ""),
        ],
        # no loads: the producer only arrives on each stage's barrier, and
        # the consumers multiply whatever the ring holds
        "noload": [
            ("mbar_expect_tx(&full[stage], STAGE_BYTES);",
             "mbar_arrive(&full[stage]);"),
            ("tma_load_3d(s", "if (0) tma_load_3d(s"),
        ],
        # no output stores (the staging in shared memory stays)
        "nostore": [
            ("            tma_store_3d(map", "            if (0) tma_store_3d(map"),
        ],
    },
    "dw": {
        # no products: the TMA feed, the ring's barriers and the epilogue
        # (the A fragments feed only the products, so their reads go too)
        "nomma": [
            ("          wgmma_rs<1>(acc_r, ar, dgr, sd);\n"
             "          wgmma_rs<1>(acc_r, ai, dgi, 1);\n"
             "          wgmma_rs<1>(acc_i, ar, dgi, sd);\n"
             "          wgmma_rs<-1>(acc_i, ai, dgr, 1);\n", ""),
        ],
        # no loads: the producer only arrives on each stage's barrier, and
        # the consumers read fragments and multiply whatever the ring holds
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
    },
}


def variant_source(name: str, kernel: str = "dw") -> str:
    """The source of ``kernel`` (``dx`` or ``dw``) with the edits of
    variant ``name`` applied."""
    source = (kernel_build.CSRC_DIR / SOURCES[kernel]).read_text()
    for part in name.split("+"):
        for old, new in VARIANTS[kernel][part]:
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
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="dw",
                        help="1b (dx) or 1c (dw)")
    parser.add_argument("variants", nargs="*",
                        help="names of VARIANTS[kernel], or several joined "
                             "by +")
    args = parser.parse_args(argv)
    kernel, source = args.kernel, SOURCES[args.kernel]
    for name in args.variants:
        variant_source(name, kernel)  # unknown names and stale edits fail here

    device = get_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    libs = {"kernel": kernel_build.load(source)}
    libs.update(kernel_build.build_variants(
        source, {n: variant_source(n, kernel) for n in args.variants}))
    gen = torch.Generator(device).manual_seed(0)
    b, l, m, i, o = 4, 180, 181, 512, 512
    gr, gi = (torch.randn(b, l, m, o, generator=gen, device=device)
              .to(torch.bfloat16) for _ in range(2))
    if kernel == "dx":
        wr, wi = (torch.randn(l, i, o, generator=gen, device=device)
                  .mul(0.02).to(torch.bfloat16) for _ in range(2))
        # dx = [g_r | g_i] @ [[w_r^T, -w_i^T], [w_i^T, w_r^T]] per l
        lhs = torch.cat([gr, gi], dim=-1).transpose(0, 1).reshape(
            l, b * m, 2 * o).contiguous()
        rhs = torch.cat([torch.cat([wr, -wi], dim=1),
                         torch.cat([wi, wr], dim=1)], dim=2).transpose(
            1, 2).contiguous()

        def run():
            return k1.dhconv_filter_dx(gr, gi, wr, wi)
        bind = k1._bwd_library
    else:
        xr, xi = (torch.randn(b, l, m, i, generator=gen, device=device)
                  for _ in range(2))
        # dW = [x_r; x_i]^T @ [[g_r, g_i], [g_i, -g_r]] per l, over b and m
        lhs = torch.cat([xr, xi], dim=2).to(torch.bfloat16).permute(
            1, 3, 0, 2).reshape(l, i, 2 * b * m).contiguous()
        rhs = torch.cat([torch.cat([gr, gi], dim=-1),
                         torch.cat([gi, -gr], dim=-1)], dim=2).permute(
            1, 0, 2, 3).reshape(l, 2 * b * m, 2 * o).contiguous()

        def run():
            return k1.dhconv_filter_dw(xr, xi, gr, gi)
        bind = k1._dw_library
    print(f"kernel {kernel} ({source})")
    for _ in range(2):
        print(f"{'library (bf16 matmul)':24s} "
              f"{cuda_ms(lambda: torch.matmul(lhs, rhs)):.4f} ms")
        for name, lib in libs.items():
            # the wrapper loads the library it finds in the cache
            kernel_build._LIBRARIES[source] = lib
            bind()
            print(f"{name:24s} {cuda_ms(run):.4f} ms")
    kernel_build._LIBRARIES[source] = libs["kernel"]


if __name__ == "__main__":
    main()
