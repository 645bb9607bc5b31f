"""Where the time of a flagship rollout step, or train step, goes on the
GPU.

    python -m ace_tpu_torch.profile_flagship [--steps N] [--out DIR]
                                             [--fused-block-tail] [--train]
    python -m ace_tpu_torch.profile_flagship --read TRACE --traced-steps N

Builds the ACE2-ERA5 flagship stepper (``ace_tpu_torch/flagship.py``) on
the CUDA device with weights from a seed, warms it up with one step, times
an ``N``-step ``Stepper.predict`` (default 20) untraced, then traces a
3-step one with ``torch.profiler``. Prints the card's name and power
limit, the wall time per step, the device's busy and idle share of the
traced window (the union of the trace's kernel, memcpy and memset
intervals over the wall time), the kernels that take the most device
time, the same time by family (``FAMILIES``) and the peak device memory.
``--read`` prints the kernel and family tables of a trace written before
(for example by another checkout of the repo), without a device.
``--fused-block-tail`` sends every block's tail through the fused
kernel K2. ``--train`` profiles the flagship pretraining step instead
(``flagship.build_train_stepper``, a batch of 2, the same batch and noise
each step): ``N`` untimed-apart steps (default 5 with ``--train``), then 2
traced. Writes the Chrome trace to ``DIR/flagship_trace.json`` (or
``flagship_train_trace.json``; default ``build/profiles``).
"""

import argparse
import collections
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ace_tpu_torch import flagship
from ace_tpu_torch.device import get_device


TRACED_STEPS = 3
TRACED_TRAIN_STEPS = 2
TRAIN_BATCH = 2
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel families, by the first pattern found in a device event's name
FAMILIES = (
    ("K1 dhconv_filter", ("dhconv_filter_kernel",)),
    ("1b dhconv_dx", ("dhconv_dx_kernel",)),
    ("1c dhconv_dw", ("dhconv_dw_kernel",)),
    ("K2 fused_block_tail", ("fused_block_tail",)),
    ("K3 fused_sht", ("fused_sht", "sht_dft", "sht_legendre")),
    ("strided copies (copies, casts, DtoD)", ("direct_copy", "copy_kernel",
                                               "Memcpy")),
    ("f32 SGEMM", ("sgemm", "f32f32", "gemm_f32")),
    ("bf16 GEMMs", ("nvjet", "cutlass", "gemm", "xmma")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def device_events(trace_path: str) -> list[dict]:
    """The device-side events (kernels, copies, sets) of a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(events: list[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def family(name: str) -> str:
    for label, patterns in FAMILIES:
        if any(p in name for p in patterns):
            return label
    return "rest"


def print_tables(events: list[dict], n: int, top: int = 30):
    """Device ms per step by kernel (the ``top`` largest) and by family,
    over a trace of ``n`` steps."""
    busy_s = busy_us(events) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_family = collections.defaultdict(float)
    for e in events:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
        by_family[family(e["name"])] += e["dur"]
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for name, (us, count) in rows[:top]:
        print(f"{us / 1e3 / n:14.3f} {100 * us / 1e6 / busy_s:5.1f}% "
              f"{count / n:10.1f}  {name[:110]}")
    print(f"{'device ms/step':>14} {'share':>6}  family (kernel time; "
          "overlaps make the sum exceed busy)")
    for label, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"{us / 1e3 / n:14.3f} {100 * us / 1e6 / busy_s:5.1f}%  {label}")
    print(f"{busy_s / n * 1e3:14.3f}         busy")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=None,
                        help="untraced steps to time (20; 5 with --train)")
    parser.add_argument("--out", default="build/profiles")
    parser.add_argument("--fused-block-tail", action="store_true",
                        help="run each block's tail through the fused kernel")
    parser.add_argument("--train", action="store_true",
                        help="profile the pretraining step, not the rollout")
    parser.add_argument("--read", metavar="TRACE",
                        help="only print the tables of this Chrome trace")
    parser.add_argument("--traced-steps", type=int, default=TRACED_TRAIN_STEPS,
                        help="steps in the trace given to --read")
    args = parser.parse_args(argv)
    if args.read:
        print_tables(device_events(args.read), args.traced_steps)
        return
    if args.steps is None:
        args.steps = 5 if args.train else 20

    device = get_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    if args.train:
        run, n = _train_runner(device, args.fused_block_tail), TRACED_TRAIN_STEPS
        name = "flagship_train_trace.json"
    else:
        run = _rollout_runner(device, args.fused_block_tail,
                              max(args.steps, TRACED_STEPS))
        n = TRACED_STEPS
        name = "flagship_trace.json"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    print(f"first call (1 step): {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    print(f"{args.steps} steps untraced: {wall_s:.4f} s = "
          f"{wall_s / args.steps * 1e3:.2f} ms/step = "
          f"{args.steps / wall_s:.3f} steps/s")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, name)
    prof.export_chrome_trace(trace_path)
    events = device_events(trace_path)
    busy_s = busy_us(events) / 1e6
    print(f"{n} steps traced: wall {wall_s / n * 1e3:.2f} ms/step; device "
          f"busy {busy_s / n * 1e3:.2f} ms/step ({100 * busy_s / wall_s:.1f}%), "
          f"idle {100 * (1 - busy_s / wall_s):.1f}%; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print_tables(events, n)


def _rollout_runner(device, fused, max_steps):
    """``run(n)``: an ``n``-step flagship rollout from the same state."""
    stepper = flagship.build_stepper(device=device, fused_block_tail=fused)
    stepper.init_params(torch.Generator(device).manual_seed(0))
    ic, forcing = flagship.synthetic_inputs(
        stepper, max_steps, generator=torch.Generator(device).manual_seed(1)
    )

    def run(n):
        stepper.predict(ic, {k: v[:, : n + 1] for k, v in forcing.items()})

    return run


def _train_runner(device, fused):
    """``run(n)``: ``n`` flagship train steps on one batch and noise."""
    ts = flagship.build_train_stepper(device=device, fused_block_tail=fused)
    ts.init(torch.Generator(device).manual_seed(0))
    batch = flagship.synthetic_batch(
        ts.stepper, TRAIN_BATCH, generator=torch.Generator(device).manual_seed(1)
    )

    def run(n):
        for _ in range(n):
            ts.train_step(batch, torch.Generator(device).manual_seed(2))

    return run


if __name__ == "__main__":
    main()
