"""Where the time of kernel K3 (the fused forward SHT) goes on the GPU.

    python -m ace_tpu_torch.profile_fused_sht [VARIANT ...]

Times ``RealSHT.forward_fused`` on the flagship transform (``[1, 180, 360,
512]``, Gauss grid) with ``torch.profiler``, per phase of the kernel (phase
1 the DFT, phase 2 the Legendre contraction), for the kernel as built from
``csrc/fused_sht.cu`` and for each named variant: a copy of that source
with parts compiled out, built beside it under ``build/kernels/variants/``.
A variant is one name of ``VARIANTS`` or several joined by ``+``
(``nostore+nomma``). Variants compute wrong results on purpose; they show
what each part costs, not what the kernel returns. All variants of a call
run on one card, in turns, twice.
"""

import argparse
import ctypes
import re
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ace_tpu_torch.device import get_device
from ace_tpu_torch.ops import fused_sht as k3
from ace_tpu_torch.ops import kernel_build

# (text of the source, its replacement) pairs of each variant
VARIANTS = {
    # no output stores (phase 1's intermediate and phase 2's outputs)
    "nostore": [
        ("if (r < p.Cp) {\n              tma_store_5d",
         "if (0) {\n              tma_store_5d"),
        ("if (r < 2 * p.Cp && c0 < p.C) {", "if (0) {"),
    ],
    # no products: the operand feed and the fragment splits alone
    "nomma": [
        ("      wgmma_tf32(acc[c], a_lo[kk], b_hi);\n"
         "      wgmma_tf32(acc[c], a_hi[kk], b_lo);\n"
         "      wgmma_tf32(acc[c], a_hi[kk], b_hi);\n", ""),
    ],
    # one product of the three: the single-pass TF32 cost
    "onemma": [
        ("      wgmma_tf32(acc[c], a_lo[kk], b_hi);\n"
         "      wgmma_tf32(acc[c], a_hi[kk], b_lo);\n", ""),
    ],
}


def variant_source(name: str) -> str:
    """The kernel source with the edits of variant ``name`` applied."""
    source = (kernel_build.CSRC_DIR / k3.SOURCE).read_text()
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if old not in source:
                raise ValueError(f"variant {part}: the source has no {old!r}")
            source = source.replace(old, new)
    return source


def build_variants(names: list[str]) -> dict[str, ctypes.CDLL]:
    """Compile the variants, one nvcc each, all at once; load them."""
    return kernel_build.build_variants(
        k3.SOURCE, {name: variant_source(name) for name in names})


def phase_ms(sht, x, iters=20) -> dict[str, float]:
    """Mean device time of each phase's kernel over ``iters`` calls."""
    for _ in range(3):
        sht.forward_fused(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            sht.forward_fused(x)
        torch.cuda.synchronize()
    times = {}
    for event in prof.key_averages():
        phase = re.search(r"fused_sht_kernel<(\d)>", event.key)
        if phase:
            times[phase.group(1)] = event.device_time_total / event.count / 1e3
    return times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*",
                        help="names of VARIANTS, or several joined by +")
    args = parser.parse_args(argv)
    for name in args.variants:
        variant_source(name)  # unknown names and stale edits fail here

    from ace_tpu_torch.ops.sht import RealSHT

    device = get_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    libs = {"kernel": kernel_build.load(k3.SOURCE)}
    libs.update(build_variants(args.variants))
    sht = RealSHT(180, 360, device=device)
    x = torch.randn(1, 180, 360, 512, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    with torch.inference_mode():
        for _ in range(2):
            for name, lib in libs.items():
                # the wrapper loads the library it finds in the cache
                kernel_build._LIBRARIES[k3.SOURCE] = lib
                k3._library()
                t = phase_ms(sht, x)
                print(f"{name:24s} phase 1 {t.get('1', 0.0):.4f} ms, phase 2 "
                      f"{t.get('2', 0.0):.4f} ms, sum "
                      f"{t.get('1', 0.0) + t.get('2', 0.0):.4f} ms")
    kernel_build._LIBRARIES[k3.SOURCE] = libs["kernel"]


if __name__ == "__main__":
    main()
