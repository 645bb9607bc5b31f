"""Where the time of a flagship rollout step, or train step, goes on the
GPU.

    python -m ace_tpu_torch.profile_flagship [--steps N] [--out DIR]
                                             [--fused-block-tail]
                                             [--train | --inference |
                                              --evaluator | --shield |
                                              --som | --ocean |
                                              --coupled | --fcn3 |
                                              --local | --healpix |
                                              --swin | --graphcast |
                                              --downscaling]
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
traced. ``--inference`` profiles the inference loop as path I of
``chip_smoke.py`` runs it without a writer (``run_inference`` from start
indices [0, 1], batch 2, in windows of 5, with the default aggregators,
over forcing in host memory; weights from ``flagship.draw_check_weights``):
``N`` steps untraced (default 20), then 10 traced; a step is one forward
step of the batch of 2. The untraced run also prints the device time of
each call of the spectrum aggregator's flood fill, in order (CUDA events
around ``SmoothFloodFill.fill_stacked``: the fill runs until the host
knows that no variable has a NaN, and is skipped from then on).
``--evaluator`` profiles the loop as path E of ``chip_smoke.py`` runs it:
one initial condition, windows of 50, the outputs' dataset values as
targets and the aggregator flags of
``configs/baselines/era5/ace-evaluator-config.yaml`` (zonal means and
histograms on, the rest at their defaults): ``N`` steps untraced (default
100), then 100 traced, two windows, so that the histograms' host work of
the first overlaps the second's rollout. ``--shield`` profiles path S of
``chip_smoke.py``, the ACE2-SHiELD AMIP recipe
(``configs/baselines/amip-c96-shield/train-ace2.yaml``:
SphericalFourierNeuralOperatorNet, embed 384, 8 layers, float32): its
train step at batch 2 (``N`` steps untraced, default 5, then 2 traced),
then its rollout at batch 1 (20 untraced, 3 traced), each with its tables
and peak (``shield_train_trace.json``, ``shield_rollout_trace.json``).
``--som`` profiles path M, the ACE2-SOM slab-ocean recipe
(``configs/baselines/shield-som/ace-train-config.yaml``): a rollout step
as path M-I runs it (the multi-call wrapper without a config around the
slab-ocean step, float32, batch 4: 20 untraced, 3 traced), then a train
step as path M-bf16 runs it (bfloat16, CO2 quadrupled in a second call
of each step with its six radiative fluxes in the loss, batch 1: ``N``
untraced, default 5, then 2 traced; ``som_rollout_trace.json``,
``som_train_trace.json``). ``--ocean`` profiles path O, the uncoupled-ocean
CM4 recipe (``configs/baselines/cm4-piControl/uncoupled-ocean/
train-config.yaml``: Samudra at its widths, float32, 180x360, the ocean
corrector, input and output masking over a land mask of 30% of the grid
and its depth coordinate): its train step as path O-R runs it (batch 4, 4
forward steps, FusedAdam with weight decay, EMA: ``N`` untraced, default
5, then 2 traced), then its rollout at batch 1 as path O-E runs it (20
untraced, 3 traced; ``ocean_train_trace.json``,
``ocean_rollout_trace.json``). ``--coupled`` profiles path C, the CM4
coupled recipe (``configs/baselines/cm4-piControl/train-config.yaml``: the
frozen SFNO at embed 384 coupled to Samudra at its widths, float32,
180x360, data made in memory): a train step as path C-R's batch loop runs
it (batch 1, 4 coupled steps of 20 atmosphere steps: ``N`` untraced,
default 2, then 1 traced), then a coupled rollout window as path C-E
runs it (2 coupled steps: ``N`` untraced, then 1 traced;
``coupled_train_trace.json``, ``coupled_rollout_trace.json``).
``--fcn3`` profiles path N, FourCastNet3's recipe (``configs/fcn3-train.yaml``:
DISCO encoders and decoders at 180x360, 8 processor blocks at 45x90 over
1184 channels, float32; statistics of its draws' scale in place of its
files, weights from a seed): a train step as path N-R's batch loop runs
it (batch 4, one forward step, MSE, AdamW, EMA: ``N`` untraced, default
3, then 1 traced), then a rollout window as path N-I runs it (5 steps at
batch 2: ``N`` untraced, then 1 traced; ``fcn3_train_trace.json``,
``fcn3_rollout_trace.json``); its family table counts the DISCO
contractions (``DiscoConvS2``'s forward and its backward) as a family of
their own (``disco_relabel``). ``--local`` profiles path L: the
flagship network with local DISCO blocks at 1, 3, 5 and 7 (bf16, embed
512, conditioned on 2 labels, per-block recompute) in the pretraining
recipe of ``--train``, a train step at batch 2 with the labels and a data
mask that drops ``USWRFsfc`` (``N`` untraced, default 3, then 1 traced),
then a rollout window as path L-I runs it (5 steps at batch 1; ``N``
untraced, then 1 traced; ``local_train_trace.json``,
``local_rollout_trace.json``); the local blocks' DISCO (``DiscoConvS2``'s
forward and ``mixed``, and their backward) is a family of its own.
``--swin`` profiles path W: the flagship's step and pretraining recipe
(``--train``'s loss, optimizer and EMA) with the
NoiseConditionedSwinTransformer at its builder's defaults, f32: a train
step at batch 2 (``N`` untraced, default 3, then 1 traced), then a rollout
window (5 steps at batch 1; ``swin_train_trace.json``,
``swin_rollout_trace.json``); its family table counts the softmax, the
layer norms and the rolls apart (``swin_family``). ``--graphcast``
profiles path G: the sea-ice recipe with FloeNet at its builder's defaults
on the 1° grid (a train step at batch 2, then a rollout window of 5 steps
at batch 1), the gathers and the segment sums apart
(``graphcast_family``).
``--healpix`` profiles path H, DLWP-HPX's recipe
(``configs/dlwp-hpx64-train.yaml``: HEALPixUNet at its builder's defaults
on HPX64, float32, 11 inputs and 8 outputs; statistics of unit scale in
place of its files, weights from a seed): a train step as path H-R's
batch loop runs it (batch 4, one forward step, MSE, AdamW, EMA: ``N``
untraced, default 3, then 1 traced), then a rollout window as path H-I
runs it (5 steps at batch 1: ``N`` untraced, then 1 traced;
``healpix_train_trace.json``, ``healpix_rollout_trace.json``), with the
convolutions' operations counted from their shapes; its family table
counts the cuDNN convolutions and the neighbour pad's gathers (and their
backward) as families of their own (``healpix_family``).
``--downscaling`` profiles path D, the HiRO-ACE global recipe
(``configs/baselines/downscaling-hiro-global/train.yaml``: SongUNet at
model_channels 128 over 7 levels, f32, residual prediction with the fine
topography, x32 on 16x16 coarse patches, so 512x512 at the fine
resolution; statistics of unit scale in place of its files, weights from
a seed): a train step as path D-R's batch loop runs it (batch
``DOWNSCALING_BATCH``, the EDM loss with dropout, Adam, EMA: ``N``
untraced, default 3, then 1 traced), then a Heun step of path D-G's
sampler (two network evaluations at batch 1; ``downscaling_train_trace.json``,
``downscaling_sampler_trace.json``), with the convolutions' operations
counted from their shapes; its family table counts the cuDNN
convolutions, the group norms, the attention's softmax and the SiLUs
apart (``downscaling_family``).
Convolutions run with TF32 off, as every profile here.
Writes the Chrome trace to
``DIR/flagship_trace.json`` (``flagship_train_trace.json``,
``flagship_inference_trace.json``, ``flagship_evaluator_trace.json``;
default ``build/profiles``).
"""

import argparse
import collections
import contextlib
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
TRACED_INFERENCE_STEPS = 10
TRACED_EVALUATOR_STEPS = 100
TRAIN_BATCH = 2
INFERENCE_STEPS_IN_MEMORY = 5
EVALUATOR_STEPS_IN_MEMORY = 50
# the aggregator flags of the evaluator baseline
# (configs/baselines/era5/ace-evaluator-config.yaml)
EVALUATOR_AGGREGATOR = {"log_zonal_mean_images": True,
                        "log_histograms": True}
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


def print_tables(events: list[dict], n: int, top: int = 30, relabel=None):
    """Device ms per step by kernel (the ``top`` largest) and by family,
    over a trace of ``n`` steps. ``relabel(event)`` may name an event's
    family in place of ``FAMILIES`` (None keeps it)."""
    busy_s = busy_us(events) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_family = collections.defaultdict(float)
    for e in events:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
        label = relabel(e) if relabel is not None else None
        by_family[label or family(e["name"])] += e["dur"]
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
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the pretraining step, not the rollout")
    mode.add_argument("--inference", action="store_true",
                      help="profile the inference loop (batch 2, windows "
                           "of 5, aggregators, no writer)")
    mode.add_argument("--evaluator", action="store_true",
                      help="profile the evaluator's loop (batch 1, windows "
                           "of 50, targets, the evaluator baseline's "
                           "aggregators)")
    mode.add_argument("--shield", action="store_true",
                      help="profile path S: the ACE2-SHiELD AMIP recipe's "
                           "train step (batch 2), then its rollout (batch 1)")
    mode.add_argument("--ocean", action="store_true",
                      help="path O: the uncoupled-ocean recipe's train "
                           "step, then its rollout")
    mode.add_argument("--coupled", action="store_true",
                      help="path C: the CM4 coupled recipe's train step "
                           "(batch 1), then a coupled rollout window")
    mode.add_argument("--healpix", action="store_true",
                      help="profile path H (DLWP-HPX's HEALPixUNet on HPX64)")
    mode.add_argument("--fcn3", action="store_true",
                      help="path N: FourCastNet3's train step (batch 4), "
                           "then a rollout window (batch 2)")
    mode.add_argument("--local", action="store_true",
                      help="path L: the flagship with local blocks and "
                           "labels: a train step (batch 2), then a rollout "
                           "window (batch 1)")
    mode.add_argument("--swin", action="store_true",
                      help="path W: the flagship recipe with the "
                           "NoiseConditionedSwinTransformer: a train step "
                           "(batch 2), then a rollout window (batch 1)")
    mode.add_argument("--graphcast", action="store_true",
                      help="path G: the sea-ice recipe with FloeNet at 1 "
                           "degree: a train step (batch 2), then a rollout "
                           "window (batch 1)")
    mode.add_argument("--downscaling", action="store_true",
                      help="path D: the HiRO-ACE recipe's SongUNet at full "
                           "width: a train step (batch 6 of 512x512 "
                           "patches), then a sampler step (batch 1)")
    mode.add_argument("--som", action="store_true",
                      help="profile path M: the ACE2-SOM recipe's rollout "
                           "(f32, batch 4), then its bf16 multi-call train "
                           "step (batch 1)")
    parser.add_argument("--read", metavar="TRACE",
                        help="only print the tables of this Chrome trace")
    parser.add_argument("--traced-steps", type=int, default=TRACED_TRAIN_STEPS,
                        help="steps in the trace given to --read")
    args = parser.parse_args(argv)
    if args.read:
        print_tables(device_events(args.read), args.traced_steps)
        return
    if args.steps is None:
        args.steps = (2 if args.coupled
                      else 3 if (args.fcn3 or args.local or args.healpix
                                 or args.swin or args.graphcast
                                 or args.downscaling)
                      else 5
                      if args.train or args.shield or args.som
                      or args.ocean else 100
                      if args.evaluator else 20)

    device = get_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    if args.shield:
        train, rollout = _shield_runners(device)
        print("path S train step (batch 2, 2 forward steps, f32):")
        _profile(train, args.steps, TRACED_TRAIN_STEPS,
                 os.path.join(args.out, "shield_train_trace.json"))
        print("path S rollout (batch 1, f32):")
        _profile(rollout, 20, TRACED_STEPS,
                 os.path.join(args.out, "shield_rollout_trace.json"))
        return
    if args.som:
        train, rollout = _som_runners(device)
        print("path M rollout (batch 4, f32, the slab-ocean step):")
        _profile(rollout, 20, TRACED_STEPS,
                 os.path.join(args.out, "som_rollout_trace.json"))
        print("path M-bf16 train step (batch 1, 2 forward steps of 2 calls):")
        _profile(train, args.steps, TRACED_TRAIN_STEPS,
                 os.path.join(args.out, "som_train_trace.json"))
        return
    if args.coupled:
        train, rollout = _coupled_runners(device)
        print("path C-R train step (batch 1, 4 coupled steps: 80 atmosphere "
              "steps and 4 ocean steps, f32, the atmosphere frozen):")
        _profile(train, args.steps, 1,
                 os.path.join(args.out, "coupled_train_trace.json"))
        print(f"path C rollout window (batch 1, {COUPLED_WINDOW} coupled "
              f"steps: {COUPLED_WINDOW * 20} atmosphere steps and "
              f"{COUPLED_WINDOW} ocean steps, f32):")
        _profile(rollout, args.steps, 1,
                 os.path.join(args.out, "coupled_rollout_trace.json"))
        return
    if args.fcn3:
        train, rollout = _fcn3_runners(device)
        print(f"path N-R train step (batch {FCN3_BATCH}, 1 forward step, "
              f"f32):")
        _profile(train, args.steps, 1,
                 os.path.join(args.out, "fcn3_train_trace.json"),
                 relabel=disco_relabel)
        print(f"path N-I rollout window (batch 2, {FCN3_WINDOW} steps, "
              f"f32):")
        _profile(rollout, args.steps, 1,
                 os.path.join(args.out, "fcn3_rollout_trace.json"),
                 relabel=disco_relabel)
        return
    if args.local:
        train, rollout = _local_runners(device)
        print(f"path L-R train step (batch {TRAIN_BATCH} x 2 members, bf16, "
              f"local blocks {LOCAL_BLOCKS}):")
        _profile(train, args.steps, 1,
                 os.path.join(args.out, "local_train_trace.json"),
                 relabel=disco_relabel)
        print(f"path L-I rollout window (batch 1, {INFERENCE_STEPS_IN_MEMORY} "
              f"steps, bf16):")
        _profile(rollout, args.steps, 1,
                 os.path.join(args.out, "local_rollout_trace.json"),
                 relabel=disco_relabel)
        return
    if args.healpix:
        train, rollout = _healpix_runners(device)
        flop = convolution_flop(rollout) / HEALPIX_WINDOW
        print(f"HEALPixUNet's convolutions: {flop / 1e12:.4f} TFLOP a "
              f"sample-step forward (from their shapes), "
              f"{3 * flop / 1e12:.4f} with the backward (x3)")
        print(f"path H-R train step (batch {HEALPIX_BATCH}, 1 forward step, "
              f"f32):")
        busy = _profile(train, args.steps, 1,
                        os.path.join(args.out, "healpix_train_trace.json"),
                        relabel=lambda path: healpix_family)
        print(f"path H-R train step: "
              f"{3 * flop * HEALPIX_BATCH / busy / 1e12:.2f} TFLOP/s of "
              f"convolutions over the busy time")
        print(f"path H-I rollout window (batch 1, {HEALPIX_WINDOW} steps, "
              f"f32):")
        busy = _profile(rollout, args.steps, 1,
                        os.path.join(args.out, "healpix_rollout_trace.json"),
                        relabel=lambda path: healpix_family)
        print(f"path H-I rollout: "
              f"{flop * HEALPIX_WINDOW / busy / 1e12:.2f} TFLOP/s of "
              f"convolutions over the busy time")
        return
    if args.downscaling:
        train, sample = _downscaling_runners(device)
        flop = song_unet_flop(sample.model)
        print(f"SongUNet's convolutions: {flop / 1e12:.4f} TFLOP a "
              f"{DOWNSCALING_FINE}^2 sample forward (from their shapes), "
              f"{3 * flop / 1e12:.4f} with the backward (x3)")
        print(f"path D-R train step (batch {DOWNSCALING_BATCH}, f32):")
        busy = _profile(train, args.steps, 1,
                        os.path.join(args.out, "downscaling_train_trace.json"),
                        relabel=lambda path: downscaling_family)
        print(f"path D-R train step: "
              f"{3 * flop * DOWNSCALING_BATCH / busy / 1e12:.2f} TFLOP/s of "
              f"convolutions over the busy time (f32 peak 67)")
        print("path D-G sampler step (a Heun step: 2 network evaluations at "
              "batch 1, f32):")
        busy = _profile(sample, args.steps, 1,
                        os.path.join(args.out,
                                     "downscaling_sampler_trace.json"),
                        relabel=lambda path: downscaling_family)
        print(f"path D-G sampler step: {2 * flop / busy / 1e12:.2f} TFLOP/s "
              f"of convolutions over the busy time (f32 peak 67)")
        return
    if args.swin or args.graphcast:
        kind = "swin" if args.swin else "graphcast"
        runners, relabel, recipe = {
            "swin": (_swin_runners, swin_family, "W-R train step (batch "
                     f"{TRAIN_BATCH} x 2 members, CRPS, f32)"),
            "graphcast": (_graphcast_runners, graphcast_family,
                          f"G-R train step (batch {GRAPHCAST_BATCH}, MSE, "
                          "f32)")}[kind]
        if kind == "swin":
            fwd, both = swin_flop()
            print(f"the NoiseConditionedSwinTransformer: {fwd / 1e12:.4f} "
                  f"TFLOP of matmuls a sample-step forward, {both / 1e12:.4f}"
                  f" with the backward (counted on the meta device)")
        train, rollout = runners(device)
        if kind == "graphcast":
            fwd, shared = graphcast_flop(rollout.graphs)
            print(f"FloeNet's MLPs: {fwd / 1e12:.4f} TFLOP a sample-step "
                  f"forward, {shared / 1e12:.4f} more for the embeddings "
                  f"the batch shares (from the graphs' sizes)")
        print(f"path {recipe}:")
        _profile(train, args.steps, 1,
                 os.path.join(args.out, f"{kind}_train_trace.json"),
                 relabel=lambda path: relabel)
        print(f"path {recipe[0]} rollout window (batch 1, "
              f"{INFERENCE_STEPS_IN_MEMORY} steps, f32):")
        _profile(rollout, args.steps, 1,
                 os.path.join(args.out, f"{kind}_rollout_trace.json"),
                 relabel=lambda path: relabel)
        return
    if args.ocean:
        train, rollout = _ocean_runners(device)
        flop = convolution_flop(rollout)
        print(f"Samudra's convolutions: {flop / 1e12:.4f} TFLOP a "
              f"sample-step forward (from their shapes), "
              f"{3 * flop / 1e12:.4f} with the backward (x3)")
        print(f"path O train step (batch {OCEAN_BATCH}, 4 forward steps, "
              f"f32):")
        busy = _profile(train, args.steps, TRACED_TRAIN_STEPS,
                        os.path.join(args.out, "ocean_train_trace.json"))
        rate = 3 * flop * OCEAN_BATCH * 4 / busy / 1e12
        print(f"path O train step: {rate:.2f} TFLOP/s of convolutions over "
              f"the busy time")
        print("path O rollout (batch 1, f32):")
        busy = _profile(rollout, 20, TRACED_STEPS,
                        os.path.join(args.out, "ocean_rollout_trace.json"))
        print(f"path O rollout: {flop / busy / 1e12:.2f} TFLOP/s of "
              f"convolutions over the busy time")
        return
    if args.train:
        run, n = _train_runner(device, args.fused_block_tail), TRACED_TRAIN_STEPS
        name = "flagship_train_trace.json"
    elif args.inference:
        run = _inference_runner(device, args.fused_block_tail,
                                max(args.steps, TRACED_INFERENCE_STEPS))
        n = TRACED_INFERENCE_STEPS
        name = "flagship_inference_trace.json"
    elif args.evaluator:
        run = _inference_runner(device, args.fused_block_tail,
                                max(args.steps, TRACED_EVALUATOR_STEPS),
                                evaluator=True)
        n = TRACED_EVALUATOR_STEPS
        name = "flagship_evaluator_trace.json"
    else:
        run = _rollout_runner(device, args.fused_block_tail,
                              max(args.steps, TRACED_STEPS))
        n = TRACED_STEPS
        name = "flagship_trace.json"
    fills = []
    _profile(run, args.steps, n, os.path.join(args.out, name),
             (lambda: _fill_events(fills)) if args.inference
             else contextlib.nullcontext)
    if args.inference:
        print("flood fill, device ms per call (a call per window): "
              f"{[round(a.elapsed_time(b), 4) for a, b in fills]}")


def _profile(run, steps, n, trace_path, untraced=contextlib.nullcontext,
             relabel=None):
    """Time ``run(1)`` (the first call), then ``run(steps)`` untraced (in
    the context ``untraced()``), then trace ``run(n)`` into
    ``trace_path`` and print its tables (``relabel(trace_path)`` gives
    ``print_tables``' ``relabel``). Returns the device's busy seconds a
    step of the traced run."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    print(f"first call (1 step): {time.perf_counter() - t0:.3f} s")
    with untraced():
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    print(f"{steps} steps untraced: {wall_s:.4f} s = "
          f"{wall_s / steps * 1e3:.2f} ms/step = "
          f"{steps / wall_s:.3f} steps/s")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    events = device_events(trace_path)
    busy_s = busy_us(events) / 1e6
    print(f"{n} steps traced: wall {wall_s / n * 1e3:.2f} ms/step; device "
          f"busy {busy_s / n * 1e3:.2f} ms/step ({100 * busy_s / wall_s:.1f}%), "
          f"idle {100 * (1 - busy_s / wall_s):.1f}%; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print_tables(events, n,
                 relabel=relabel(trace_path) if relabel is not None else None)
    return busy_s / n


@contextlib.contextmanager
def _fill_events(pairs: list):
    """Appends to ``pairs`` the CUDA events recorded before and after each
    ``SmoothFloodFill.fill_stacked`` call while the context lasts."""
    from ace_tpu_torch.core.fill import SmoothFloodFill

    fill_stacked = SmoothFloodFill.fill_stacked

    def timed(self, x, names):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        out = fill_stacked(self, x, names)
        end.record()
        pairs.append((start, end))
        return out

    SmoothFloodFill.fill_stacked = timed
    try:
        yield
    finally:
        SmoothFloodFill.fill_stacked = fill_stacked


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


def _inference_runner(device, fused, max_steps, evaluator=False):
    """``run(n)``: the inference loop over ``n`` steps from start indices
    [0, 1], without a writer, from forcing in host memory; with
    ``evaluator``, from start index 0 in windows of 50, with the outputs'
    dataset values as targets and the evaluator baseline's aggregators."""
    from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
    from ace_tpu_torch.data.dataset import MemoryDataset
    from ace_tpu_torch.data.inference import (
        ExplicitIndices,
        InferenceGriddedData,
    )
    from ace_tpu_torch.data.time import TimeCoord
    from ace_tpu_torch.inference.loop import run_inference
    from ace_tpu_torch.stepper.stepper import PrognosticState

    stepper = flagship.build_stepper(device=device, fused_block_tail=fused)
    flagship.draw_check_weights(stepper, torch.Generator(device).manual_seed(0))
    n_times = max_steps + 2
    dataset = MemoryDataset(
        flagship.synthetic_series(
            stepper, n_times, generator=torch.Generator(device).manual_seed(3)),
        TimeCoord.from_range("2000-01-01T00:00", n_times, 21600),
        stepper.dataset_info,
    )
    info = stepper.dataset_info

    starts, in_memory, flags = (
        ([0], EVALUATOR_STEPS_IN_MEMORY, EVALUATOR_AGGREGATOR) if evaluator
        else ([0, 1], INFERENCE_STEPS_IN_MEMORY, {}))

    def run(n):
        data = InferenceGriddedData(
            dataset, ExplicitIndices(list=starts),
            stepper.forcing_window_names, stepper.prognostic_names, n,
            in_memory)
        ic = PrognosticState(data={
            k: torch.as_tensor(v).to(device)
            for k, v in data.initial_condition().data.items()})
        aggregator = InferenceAggregatorConfig(**flags).build(
            info, n_timesteps=n, normalizer=stepper.step.normalizer)
        run_inference(stepper, ic, data, aggregator=aggregator,
                      target_names=stepper.out_names if evaluator else None)
        if evaluator:
            aggregator.get_logs()

    return run


SHIELD_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "baselines", "amip-c96-shield", "train-ace2.yaml")


def _shield_runners(device, nlat=180, nlon=360, embed=None, layers=None):
    """``(train, rollout)``: ``train(n)`` runs ``n`` train steps (returns
    their metrics) of the
    ACE2-SHiELD AMIP recipe (``SHIELD_CONFIG``: its network, step,
    corrector, loss, optimizer and EMA; statistics of unit scale but for
    the surface pressure's and the water's, in place of its files) on one
    batch of 2 at ``nlat`` x ``nlon``; ``rollout(n)`` an ``n``-step
    rollout at batch 1 (returns its outputs). Weights from a seed. ``embed`` and ``layers``
    make a small copy."""
    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    with open(SHIELD_CONFIG) as f:
        config = yaml.safe_load(f)
    step = config["stepper"]["step"]["config"]
    names = sorted(set(step["in_names"]) | set(step["out_names"]))
    stds = {n: 1e-3 if n.startswith("specific_total_water") else 1.0
            for n in names}
    stats = {"means": {n: 1.0e5 if n == "PRESsfc" else 0.0 for n in names},
             "stds": {**stds, "PRESsfc": 100.0}}
    step["normalization"] = {"network": stats, "residual": stats}
    if embed is not None:
        step["builder"]["config"].update(embed_dim=embed, num_layers=layers)
    _, info = flagship.stepper_config(nlat, nlon)
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=step)).get_stepper(info, device=device)
    training = config["stepper_training"]
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(
            n_forward_steps=training["n_forward_steps"],
            loss=from_dict(StepLossConfig, training["loss"])),
        from_dict(OptimizationConfig, config["optimization"]),
        from_dict(EMAConfig, config["ema"]))
    ts.init(torch.Generator(device).manual_seed(0))
    batch = flagship.synthetic_batch(
        stepper, TRAIN_BATCH, n_forward_steps=training["n_forward_steps"],
        generator=torch.Generator(device).manual_seed(1))
    ic, forcing = flagship.synthetic_inputs(
        stepper, 20, generator=torch.Generator(device).manual_seed(2))

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        return stepper.predict(ic, {k: v[:, : n + 1]
                                    for k, v in forcing.items()})[0]

    return train, rollout


SOM_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "baselines", "shield-som", "ace-train-config.yaml")
# path M-bf16's multi-call: CO2 quadrupled, the six radiative fluxes kept
SOM_MULTI_CALL = {"forcing_name": "global_mean_co2",
                  "forcing_multipliers": {"_4xCO2": 4.0},
                  "output_names": ["ULWRFtoa", "USWRFtoa", "DLWRFsfc",
                                   "ULWRFsfc", "DSWRFsfc", "USWRFsfc"]}


def _som_draws(data: dict, generator):
    """The slab's forcing in ``data`` redrawn in realistic ranges: depths
    of 10-200 m (a depth near zero makes the slab tendency blow up) and
    q-fluxes within 100 W/m2."""
    for name, (low, high) in (("prescribed_mixed_layer_depth", (10., 200.)),
                              ("prescribed_qflux", (-100., 100.))):
        if name in data:
            v = data[name]
            data[name] = low + (high - low) * torch.rand(
                v.shape, generator=generator, device=v.device)
    return data


def _som_runners(device, nlat=180, nlon=360, embed=None, layers=None):
    """``(train, rollout)`` of the ACE2-SOM recipe (``SOM_CONFIG``: its
    network, slab-ocean step, corrector, loss, optimizer and EMA;
    statistics of unit scale but for the surface pressure's and the
    water's, in place of its files) at ``nlat`` x ``nlon``:
    ``rollout(n)`` an ``n``-step float32 rollout of its step (the
    multi-call wrapper without a config) at batch 4, as path M-I runs it
    (returns the outputs); ``train(n)`` ``n`` bfloat16 train steps on one
    batch of 1 with ``SOM_MULTI_CALL`` in the loss, as path M-bf16 runs
    them (returns their metrics). Weights from a seed. ``embed`` and
    ``layers`` make a small copy."""
    import copy

    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    with open(SOM_CONFIG) as f:
        config = yaml.safe_load(f)
    step = config["stepper"]["step"]
    wrapped = step["config"]["wrapped_step"]["config"]
    names = sorted(set(wrapped["in_names"]) | set(wrapped["out_names"]))
    stds = {n: 1e-3 if n.startswith("specific_total_water") else 1.0
            for n in names}
    stats = {"means": {n: 1.0e5 if n == "PRESsfc" else 0.0 for n in names},
             "stds": {**stds, "PRESsfc": 100.0}}
    wrapped["normalization"] = {"network": stats, "residual": stats}
    if embed is not None:
        wrapped["builder"]["config"].update(embed_dim=embed,
                                            num_layers=layers)
    _, info = flagship.stepper_config(nlat, nlon)
    stepper = StepperConfig(step=StepSelector(**step)).get_stepper(
        info, device=device)
    stepper.init_params(torch.Generator(device).manual_seed(0))
    gen = torch.Generator(device).manual_seed(2)
    ic, forcing = flagship.synthetic_inputs(stepper, 20, batch=4,
                                            generator=gen)
    _som_draws(forcing, gen)

    bf16 = copy.deepcopy(step)
    bf16["config"].update(config=SOM_MULTI_CALL,
                          include_multi_call_in_loss=True)
    bf16["config"]["wrapped_step"]["config"]["builder"]["config"][
        "compute_dtype"] = "bfloat16"
    train_stepper = StepperConfig(step=StepSelector(**bf16)).get_stepper(
        info, device=device)
    training = config["stepper_training"]
    ts = TrainStepper(
        train_stepper,
        StepperTrainConfig(
            n_forward_steps=training["n_forward_steps"],
            loss=from_dict(StepLossConfig, training["loss"])),
        from_dict(OptimizationConfig, config["optimization"]),
        from_dict(EMAConfig, config["ema"]))
    ts.init(torch.Generator(device).manual_seed(0))
    batch = _som_draws(flagship.synthetic_batch(
        train_stepper, 1, n_forward_steps=training["n_forward_steps"],
        generator=gen), gen)

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        return stepper.predict(ic, {k: v[:, : n + 1]
                                    for k, v in forcing.items()})[0]

    return train, rollout


OCEAN_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "baselines", "cm4-piControl", "uncoupled-ocean",
    "train-config.yaml")
OCEAN_BATCH = 4


def _ocean_runners(device, nlat=180, nlon=360, ch_width=None,
                   dilation=None):
    """``(train, rollout)`` of the uncoupled-ocean recipe (``OCEAN_CONFIG``:
    its Samudra, ocean corrector, input masking, loss, optimizer and EMA;
    statistics of unit scale in place of its files) at ``nlat`` x
    ``nlon``, over a random land mask of 30% of the grid with nested
    per-level masks (19 levels down to 5500 m) and inputs NaN on the dry
    cells, as path O's data: ``train(n)`` ``n`` train steps on one batch of
    ``OCEAN_BATCH`` (returns their metrics); ``rollout(n)`` an ``n``-step
    rollout at batch 1 (returns its outputs). Weights from a seed;
    ``ch_width`` and ``dilation`` make a small copy."""
    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    with open(OCEAN_CONFIG) as f:
        config = yaml.safe_load(f)
    step = config["stepper"]["step"]["config"]
    names = sorted(set(step["in_names"]) | set(step["out_names"]))
    step["normalization"] = {"network": {"means": dict.fromkeys(names, 0.0),
                                         "stds": dict.fromkeys(names, 1.0)}}
    if ch_width is not None:
        step["builder"]["config"].update(ch_width=ch_width,
                                         dilation=dilation)
    info = _ocean_info(nlat, nlon)
    stepper = from_dict(StepperConfig, config["stepper"]).get_stepper(
        info, device=device)
    training = config["stepper_training"]
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(
            n_forward_steps=training["n_forward_steps"],
            loss=from_dict(StepLossConfig, training["loss"])),
        from_dict(OptimizationConfig, config["optimization"]),
        from_dict(EMAConfig, config["ema"]))
    ts.init(torch.Generator(device).manual_seed(0))
    gen = torch.Generator(device).manual_seed(1)
    provider = info.mask_provider

    def draw(batch, n_times):
        data = {}
        for k in names:
            v = torch.randn(batch, n_times, nlat, nlon, generator=gen,
                            device=device)
            key = provider.mask_key_for(k)
            if k in step["out_names"] and key is not None:
                v = torch.where(provider.on_device(key, "wet", device), v,
                                torch.full((), float("nan"), device=device))
            data[k] = v
        return data

    batch = draw(OCEAN_BATCH, training["n_forward_steps"] + 1)
    series = draw(1, 21)
    ic = PrognosticState(data={k: series[k][:, :1]
                               for k in stepper.prognostic_names})
    forcing = {k: series[k] for k in stepper.forcing_window_names}

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        return stepper.predict(ic, {k: v[:, : n + 1]
                                    for k, v in forcing.items()})[0]

    rollout.module = stepper.module
    return train, rollout


def _ocean_info(nlat, nlon, days=5):
    """The dataset info of path O's synthetic ocean at ``nlat`` x
    ``nlon``: a random land mask of 30% of the grid with nested per-level
    masks, 19 levels down to 5500 m, ``days`` a step."""
    import datetime

    import numpy as np

    from ace_tpu_torch.core.coordinates import (
        DepthCoordinate,
        LatLonCoordinates,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.masking import MaskProvider

    rng = np.random.default_rng(0)
    levels = 19
    idepth = 5500.0 * (np.arange(levels + 1) / levels) ** 2
    ocean = rng.random((nlat, nlon)) > 0.3
    floor = idepth[1] + (idepth[-1] - idepth[1]) * rng.random((nlat, nlon))
    layer = np.stack([ocean & (floor > idepth[k]) for k in range(levels)],
                     -1).astype(np.float32)
    masks = {f"mask_{k}": layer[..., k] for k in range(levels)}
    masks["mask_2d"] = masks["mask_0"]
    return DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=np.linspace(-90 + 90 / nlat, 90 - 90 / nlat, nlat),
            lon=(np.arange(nlon) + 0.5) * 360 / nlon),
        vertical_coordinate=DepthCoordinate(
            idepth=idepth, mask=layer,
            deptho=np.where(ocean, floor, np.nan)),
        timestep=datetime.timedelta(days=days),
        mask_provider=MaskProvider(masks))


COUPLED_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "baselines", "cm4-piControl", "train-config.yaml")
# coupled steps of a rollout window (path C-E's windows; the evaluator
# YAML's are 20)
COUPLED_WINDOW = 2


def _coupled_runners(device, nlat=180, nlon=360, embed=None, layers=None,
                     ch_width=None, dilation=None, n_inner=20):
    """``(train, rollout)`` of the CM4 coupled training recipe
    (``COUPLED_CONFIG``: the SFNO frozen and coupled to Samudra, 4 coupled
    steps, the ocean fraction predicted, the ocean's loss, Adam with weight
    decay, EMA; statistics of the draws' scale in place of its files,
    weights from a seed) at ``nlat`` x ``nlon`` over ``_ocean_info``'s
    masks, data made in memory (``MemoryDataset``), through the port's
    ``CoupledTrainer``: ``train(n)`` ``n`` train steps at batch 1 on one
    batch (returns their metrics), as path C-R's batch loop runs them;
    ``rollout(n)`` ``n`` coupled rollouts of ``COUPLED_WINDOW`` coupled
    steps from the same state at batch 1, a window of path C-E (returns
    the last one's outputs). ``embed``, ``layers``, ``ch_width``,
    ``dilation`` and ``n_inner`` (atmosphere steps an ocean step) make a
    small copy."""
    import datetime

    import numpy as np
    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import (
        HybridSigmaPressureCoordinate,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.coupled.stepper import CoupledPrognosticState
    from ace_tpu_torch.coupled.train import CoupledTrainConfig, CoupledTrainer
    from ace_tpu_torch.data.dataset import MemoryDataset
    from ace_tpu_torch.data.time import TimeCoord
    from ace_tpu_torch.stepper.stepper import PrognosticState

    with open(COUPLED_CONFIG) as f:
        config = yaml.safe_load(f)
    config.update(experiment_dir=os.path.join("build", "profiles"),
                  train_loader={"atmosphere": {"data_path": "memory"},
                                "ocean": {"data_path": "memory"},
                                "batch_size": 1})
    config.pop("validation_loader")
    config["logging"]["log_to_wandb"] = False
    scales = {"PRESsfc": (1.0e5, 100.0)}
    names, shapes = {}, {}
    for component, sizes in (("atmosphere", {"embed_dim": embed,
                                             "num_layers": layers}),
                             ("ocean", {"ch_width": ch_width,
                                        "dilation": dilation})):
        step = config["stepper"][component]["stepper"]["step"]["config"]
        names[component] = sorted(set(step["in_names"])
                                  | set(step["out_names"]))
        step["normalization"] = {"network": {
            "means": {k: scales.get(k, (0.0, 1.0))[0]
                      for k in names[component]},
            "stds": {k: scales.get(k, (0.0, 1.0))[1]
                     for k in names[component]}}}
        step["builder"]["config"].update(
            {k: v for k, v in sizes.items() if v is not None})
        config["stepper_training"][component]["parameter_init"][
            "weights_path"] = None
    config["stepper"]["ocean"]["timedelta"] = f"{n_inner * 6}h"
    ocean_info = _ocean_info(nlat, nlon, days=n_inner / 4)
    nz = 8
    atmos_info = DatasetInfo(
        horizontal_coordinates=ocean_info.horizontal_coordinates,
        vertical_coordinate=HybridSigmaPressureCoordinate(
            ak=np.concatenate([np.linspace(100.0, 5000.0, nz // 2),
                               np.linspace(5000.0, 0.0, nz // 2 + 1)]),
            bk=np.linspace(0.0, 1.0, nz + 1)),
        timestep=datetime.timedelta(hours=6))
    n_outer = config["stepper_training"]["n_coupled_steps"]
    rng = np.random.default_rng(1)
    provider = ocean_info.mask_provider
    land = 1.0 - provider.masks["mask_2d"]
    datasets = []
    for component, info, n_times, seconds in (
            ("atmosphere", atmos_info, n_outer * n_inner + 1, 21600),
            ("ocean", ocean_info, n_outer + 1, n_inner * 21600)):
        fields = {}
        for k in names[component]:
            mean, std = scales.get(k, (0.0, 1.0))
            v = (mean + std * rng.standard_normal(
                (n_times, nlat, nlon))).astype(np.float32)
            if "fraction" in k:
                v = np.broadcast_to(land if k == "land_fraction"
                                    else np.clip(np.abs(v), 0, 1) * (1 - land),
                                    v.shape).astype(np.float32)
            key = provider.mask_key_for(k)
            if component == "ocean" and key is not None and k != "land_fraction":
                v = np.where(provider.masks[key] != 0, v, np.nan).astype(
                    np.float32)
            fields[k] = v
        datasets.append(MemoryDataset(fields, TimeCoord.from_range(
            "0151-01-06", n_times, seconds, "noleap"), info))
    trainer = CoupledTrainer(from_dict(CoupledTrainConfig, config),
                             device=device, datasets=tuple(datasets))
    trainer.init_weights()
    atmos_batch, ocean_batch = trainer._batch([0])
    coupled = trainer.coupled
    ic = CoupledPrognosticState(
        atmosphere_data=PrognosticState(data={
            k: atmos_batch[k][:, :1]
            for k in coupled.atmosphere.prognostic_names}),
        ocean_data=PrognosticState(data={
            k: ocean_batch[k][:, :1] for k in coupled.ocean.prognostic_names}))
    atmos_forcing = {k: v[:, :COUPLED_WINDOW * n_inner + 1]
                     for k, v in atmos_batch.items()}
    ocean_forcing = {k: v[:, :COUPLED_WINDOW + 1]
                     for k, v in ocean_batch.items()}

    def train(n):
        return [trainer.train_step(atmos_batch, ocean_batch)
                for _ in range(n)]

    def rollout(n):
        for _ in range(n):
            outputs = coupled.predict(ic, atmos_forcing, ocean_forcing)
        return outputs

    return train, rollout


FCN3_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "fcn3-train.yaml")
FCN3_BATCH = 4
# a rollout window of path N-I, at its batch of 2 initial conditions
FCN3_WINDOW = 5
# the profiler range each DISCO contraction's forward runs in (--fcn3)
DISCO_RANGE = "DiscoConvS2"


def _fcn3_runners(device, nlat=180, nlon=360, embed=None, layers=None,
                  scale_factor=None):
    """``(train, rollout)`` of FourCastNet3's recipe (``FCN3_CONFIG``: its
    network, step, loss and optimizer, the default EMA; statistics of unit
    scale but for the surface pressure's and the water's, in place of its
    files) at ``nlat`` x ``nlon`` on the Legendre-Gauss grid:
    ``train(n)`` ``n`` train steps on one batch of ``FCN3_BATCH`` (returns
    their metrics); ``rollout(n)`` ``n`` rollouts of ``FCN3_WINDOW`` steps
    at batch 2 (returns the last one's outputs). Each
    ``DiscoConvS2.forward`` runs in a profiler range ``DISCO_RANGE`` for
    ``disco_relabel``. Weights from a seed; ``embed``, ``layers`` and
    ``scale_factor`` make a small copy."""
    import datetime

    import numpy as np
    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import (
        LatLonCoordinates,
        gaussian_latitudes,
    )
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.ops.disco import DiscoConvS2
    from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    with open(FCN3_CONFIG) as f:
        config = yaml.safe_load(f)
    step = config["stepper"]["step"]["config"]
    levels = [f"{k}_{i}" for i in range(step["atmosphere_levels"])
              for k in (step["atmosphere_prognostic_names"]
                        + step["atmosphere_diagnostic_names"])]
    names = sorted(levels + step["surface_prognostic_names"]
                   + step["surface_diagnostic_names"] + step["forcing_names"])
    stds = {n: 1e-3 if n.startswith("specific_total_water") else 1.0
            for n in names}
    step["normalization"] = {"network": {
        "means": {n: 1.0e5 if n == "PRESsfc" else 0.0 for n in names},
        "stds": {**stds, "PRESsfc": 100.0}}}
    sizes = {"atmo_embed_dim": embed, "surf_embed_dim": embed,
             "aux_embed_dim": embed, "num_layers": layers,
             "scale_factor": scale_factor}
    step["builder"]["config"].update(
        {k: v for k, v in sizes.items() if v is not None})
    info = DatasetInfo(
        horizontal_coordinates=LatLonCoordinates(
            lat=gaussian_latitudes(nlat),
            lon=np.linspace(0, 360, nlon, endpoint=False)),
        timestep=datetime.timedelta(hours=6))
    stepper = from_dict(StepperConfig, config["stepper"]).get_stepper(
        info, device=device)
    training = config["stepper_training"]
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(
            n_forward_steps=training["n_forward_steps"],
            loss=from_dict(StepLossConfig, training["loss"])),
        from_dict(OptimizationConfig, config["optimization"]), EMAConfig())
    ts.init(torch.Generator(device).manual_seed(0))
    batch = flagship.synthetic_batch(
        stepper, FCN3_BATCH, n_forward_steps=training["n_forward_steps"],
        generator=torch.Generator(device).manual_seed(1))
    series = flagship.synthetic_batch(
        stepper, 2, n_forward_steps=FCN3_WINDOW,
        generator=torch.Generator(device).manual_seed(2))
    ic = PrognosticState(data={k: series[k][:, :1]
                               for k in stepper.prognostic_names})
    forcing = {k: series[k] for k in stepper.forcing_window_names}
    _ranged_disco()

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        for _ in range(n):
            outputs = stepper.predict(ic, forcing)[0]
        return outputs

    return train, rollout


def _ranged_disco():
    """Run each ``DiscoConvS2.forward`` and ``DiscoConvS2.mixed`` in a
    profiler range ``DISCO_RANGE`` (once per process)."""
    from ace_tpu_torch.ops.disco import DiscoConvS2

    for name in ("forward", "mixed"):
        method = getattr(DiscoConvS2, name)
        if hasattr(method, "ranged"):
            continue

        def ranged(self, *args, _method=method):
            with torch.profiler.record_function(DISCO_RANGE):
                return _method(self, *args)

        ranged.ranged = True
        setattr(DiscoConvS2, name, ranged)


# path L's local blocks and its missing variable
LOCAL_BLOCKS = [1, 3, 5, 7]
LOCAL_MISSING = "USWRFsfc"


def _local_runners(device, nlat=180, nlon=360, embed=None, layers=None):
    """``(train, rollout)`` of path L's network in the pretraining recipe
    (``flagship.build_train_stepper``'s loss, optimizer and EMA) at
    ``nlat`` x ``nlon``: the flagship's with local DISCO blocks at
    ``LOCAL_BLOCKS``, conditioned on 2 labels, ``LOCAL_MISSING``'s
    presence 0. ``train(n)``: ``n`` train steps on one batch of
    ``TRAIN_BATCH`` with labels of one and the data mask (returns their
    metrics); ``rollout(n)``: ``n`` rollouts of
    ``INFERENCE_STEPS_IN_MEMORY`` steps at batch 1 (returns the last
    one's outputs). Weights from a seed; ``embed`` and ``layers`` make a
    small copy."""
    import dataclasses

    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    layers = layers or flagship.LAYERS
    config, info = flagship.stepper_config(
        nlat, nlon, embed=embed or flagship.EMBED, layers=layers,
        checkpointing=1)
    selector = config.step.config["builder"]
    selector["config"]["local_blocks"] = [i for i in LOCAL_BLOCKS
                                          if i < layers]
    selector["conditional"] = True
    selector["allow_missing_variables"] = True
    info = dataclasses.replace(info, all_labels=("era5", "shield"))
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=config.step.config)).get_stepper(
        info, device=device)
    ts = flagship.train_recipe(stepper)
    ts.init(torch.Generator(device).manual_seed(0))
    batch = flagship.synthetic_batch(
        stepper, TRAIN_BATCH, generator=torch.Generator(device).manual_seed(1))
    batch[LOCAL_MISSING] = torch.full_like(batch[LOCAL_MISSING], float("nan"))
    labels = torch.ones(TRAIN_BATCH, 2, device=device)
    mask = {LOCAL_MISSING: torch.zeros(TRAIN_BATCH, device=device)}
    ic, forcing = flagship.synthetic_inputs(
        stepper, INFERENCE_STEPS_IN_MEMORY,
        generator=torch.Generator(device).manual_seed(2))
    _ranged_disco()

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3),
                              labels=labels, data_mask=mask)
                for _ in range(n)]

    def rollout(n):
        for _ in range(n):
            outputs = stepper.predict(ic, forcing)[0]
        return outputs

    return train, rollout


def disco_relabel(trace_path: str):
    """``relabel(event)`` for ``print_tables``: "DISCO contractions" for
    the device events launched by an operation inside a ``DISCO_RANGE``
    range (a DISCO contraction's forward) or inside the autograd engine's
    evaluation of the backward of such an operation (matched by its
    sequence number), None for the rest."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def spans(selected):
        out = collections.defaultdict(list)
        for e in selected:
            out[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        return out

    def inside(e, by_tid):
        return any(start <= e["ts"] < stop
                   for start, stop in by_tid.get(e["tid"], ()))

    forward = spans(e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] == DISCO_RANGE)
    sequence = {e["args"]["Sequence number"] for e in ops
                if "Sequence number" in e.get("args", {})
                and inside(e, forward)}
    backward = spans(e for e in ops
                     if e["name"].startswith("autograd::engine::evaluate_")
                     and e.get("args", {}).get("Sequence number") in sequence)
    ids = {e["args"]["External id"] for e in ops
           if "External id" in e.get("args", {})
           and (inside(e, forward) or inside(e, backward))}

    def relabel(event):
        if event.get("args", {}).get("External id") in ids:
            return "DISCO contractions"
        return None

    return relabel


def convolution_flop(rollout) -> float:
    """The operations (2 per multiply-add) of the convolutions in a
    1-step ``rollout(1)`` at batch 1, counted from each call's kernel and
    output shapes (forward hooks on the ``Conv2d`` modules, and on the
    transposed convolutions, whose output pixels each take one tap)."""
    from ace_tpu_torch.models.healpix import TransposedConvUpsample
    from ace_tpu_torch.models.samudra import Conv2d

    total = [0.0]

    def count(module, args, out):
        out_c, in_c, kh, kw = module.kernel.shape
        taps = 1 if isinstance(module, TransposedConvUpsample) else kh * kw
        total[0] += 2.0 * in_c * taps * out.numel()

    hooks = [m.register_forward_hook(count)
             for m in rollout.module.modules()
             if isinstance(m, (Conv2d, TransposedConvUpsample))]
    try:
        rollout(1)
    finally:
        for hook in hooks:
            hook.remove()
    return total[0]


HEALPIX_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "dlwp-hpx64-train.yaml")
HEALPIX_BATCH = 4
HEALPIX_WINDOW = 5
# a cuDNN convolution's kernels (forward, data and weight gradients; its
# GEMM and FFT algorithms too: HEALPixUNet has no matmul outside its
# convolutions), and the neighbour pad's gathers and scatters
# (index_select, index_copy, and index_add in their backward)
_CONVOLUTION = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd",
                "implicit", "gemm", "fft")
_PAD = ("indexselect", "index_select", "indexfunc", "index_copy",
        "index_add", "indexcopy", "vectorized_gather")


def healpix_family(event: dict) -> str | None:
    """Path H's families beyond ``FAMILIES``: the convolutions (with
    cuDNN's layout transposes, its GEMM and FFT algorithms), and the
    neighbour pad's gathers with their backward."""
    name = event["name"].lower()
    if any(p in name for p in _CONVOLUTION):
        return "convolutions (cuDNN, f32)"
    if any(p in name for p in _PAD):
        return "neighbour pad (gathers, their backward)"
    return None


def _healpix_runners(device, nside=64, builder=None):
    """``(train, rollout)`` of DLWP-HPX's recipe (``HEALPIX_CONFIG``: its
    network, step, loss and optimizer, the default EMA; statistics of unit
    scale in place of its files) at ``nside``: ``train(n)`` ``n`` train
    steps on one batch of ``HEALPIX_BATCH`` (returns their metrics);
    ``rollout(n)`` ``n`` rollouts of ``HEALPIX_WINDOW`` steps at batch 1
    (returns the last one's outputs). Weights from a seed; ``builder``
    makes a small copy."""
    import datetime

    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import HEALPixCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    with open(HEALPIX_CONFIG) as f:
        config = yaml.safe_load(f)
    step = config["stepper"]["step"]["config"]
    names = sorted(set(step["in_names"]) | set(step["out_names"]))
    step["normalization"] = {"network": {"means": dict.fromkeys(names, 0.0),
                                         "stds": dict.fromkeys(names, 1.0)}}
    if builder is not None:
        step["builder"]["config"] = builder
    info = DatasetInfo(
        horizontal_coordinates=HEALPixCoordinates.from_nside(nside),
        timestep=datetime.timedelta(hours=6))
    stepper = from_dict(StepperConfig, config["stepper"]).get_stepper(
        info, device=device)
    training = config["stepper_training"]
    ts = TrainStepper(
        stepper,
        StepperTrainConfig(
            n_forward_steps=training["n_forward_steps"],
            loss=from_dict(StepLossConfig, training["loss"])),
        from_dict(OptimizationConfig, config["optimization"]), EMAConfig())
    ts.init(torch.Generator(device).manual_seed(0))
    gen = torch.Generator(device).manual_seed(1)

    def draw(batch, n_times):
        return {k: torch.randn(batch, n_times, 12, nside, nside,
                               generator=gen, device=device) for k in names}

    batch = draw(HEALPIX_BATCH, training["n_forward_steps"] + 1)
    series = draw(1, HEALPIX_WINDOW + 1)
    ic = PrognosticState(data={k: series[k][:, :1]
                               for k in stepper.prognostic_names})
    forcing = {k: series[k] for k in stepper.forcing_window_names}

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        for _ in range(n):
            outputs = stepper.predict(ic, forcing)[0]
        return outputs

    rollout.module = stepper.module
    return train, rollout


# the Swin nets' families beyond ``FAMILIES``: the window attention's
# softmax, the layer norms (the post-norms, the CLN's channel norm, the
# patch layers'), the rolls of the shifted windows (the window partitions
# are strided copies)
_SWIN_FAMILIES = (("softmax", ("softmax",)),
                  ("layer norms", ("layer_norm", "layernorm")),
                  ("rolls", ("roll",)))
# GraphCast's: the gathers of sender and receiver features (and the sorted
# edges of the segment sums), the segment sums (and the gathers'
# gradients), the layer norms
_GRAPHCAST_FAMILIES = (
    ("gathers", ("index_elementwise", "indexselect", "index_select",
                 "vectorized_gather", "gather")),
    ("segment sums", ("segment_reduce", "segment")),
    ("layer norms", ("layer_norm", "layernorm")))


def _family_by(table):
    def relabel(event: dict) -> str | None:
        name = event["name"].lower()
        for label, patterns in table:
            if any(p in name for p in patterns):
                return label
        return None
    return relabel


swin_family = _family_by(_SWIN_FAMILIES)
graphcast_family = _family_by(_GRAPHCAST_FAMILIES)


def _swin_runners(device, nlat=180, nlon=360, builder=None):
    """``(train, rollout)`` of path W's network in the pretraining recipe
    (``flagship.train_recipe``: CRPS over 2 members, AdamW, EMA) at
    ``nlat`` x ``nlon``: the NoiseConditionedSwinTransformer at its
    builder's defaults (or ``builder``'s config) in the flagship's step.
    ``train(n)``: ``n`` train steps on one batch of ``TRAIN_BATCH``
    (returns their metrics); ``rollout(n)``: ``n`` rollouts of
    ``INFERENCE_STEPS_IN_MEMORY`` steps at batch 1. Weights from a seed."""
    from ace_tpu_torch.core.step import StepSelector
    from ace_tpu_torch.stepper.stepper import StepperConfig

    config, info = flagship.stepper_config(nlat, nlon)
    step = dict(config.step.config, builder={
        "type": "NoiseConditionedSwinTransformer", "config": builder or {}})
    stepper = StepperConfig(step=StepSelector(
        type="single_module", config=step)).get_stepper(info, device=device)
    ts = flagship.train_recipe(stepper)
    ts.init(torch.Generator(device).manual_seed(0))
    batch = flagship.synthetic_batch(
        stepper, TRAIN_BATCH, generator=torch.Generator(device).manual_seed(1))
    ic, forcing = flagship.synthetic_inputs(
        stepper, INFERENCE_STEPS_IN_MEMORY,
        generator=torch.Generator(device).manual_seed(2))

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        gen = torch.Generator(device).manual_seed(4)
        for _ in range(n):
            outputs = stepper.predict(ic, forcing, generator=gen)[0]
        return outputs

    rollout.stepper = stepper
    return train, rollout


def swin_flop(nlat=180, nlon=360, n_in=38, n_out=45) -> tuple[float, float]:
    """The matmul and convolution operations of the
    NoiseConditionedSwinTransformer at its builder's defaults (path W's
    network, the flagship recipe's 38 inputs and 45 outputs) a
    sample-step, forward and forward with backward, counted by
    ``torch.utils.flop_counter`` on the meta device (no data, no card)."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.models.registry import ModuleSelector

    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        np.linspace(-89.5, 89.5, nlat), np.arange(nlon) * 360.0 / nlon))
    counts = []
    with torch.device("meta"):
        net = from_dict(ModuleSelector, {
            "type": "NoiseConditionedSwinTransformer", "config": {}}).build(
            n_in, n_out, info)
        x = torch.zeros(1, nlat, nlon, n_in)
        noise = torch.zeros(1, nlat, nlon, net.noise_embed_dim)
        for backward in (False, True):
            with FlopCounterMode(display=False) as counter:
                out = net(x, noise=noise)
                if backward:
                    out.sum().backward()
            counts.append(float(counter.get_total_flops()))
    return counts[0], counts[1]


def graphcast_flop(graphs, latent=256, n_in=4, n_out=4, steps=4):
    """FloeNet's MLP operations a sample-step forward (2 per multiply-add,
    each ``GnnMLP`` ``in -> latent -> out`` over its rows: the grid and
    mesh nodes and the three edge sets of ``graphs``), and those of the
    edge and mesh embeddings, which the batch shares."""
    def mlp(rows, width_in, out=latent):
        return 2.0 * rows * (width_in * latent + latent * out)

    e1, e2, e3 = (len(graphs.g2m_senders), len(graphs.m2m_senders),
                  len(graphs.m2g_senders))
    grid, mesh = graphs.n_grid, graphs.n_mesh
    per_sample = (mlp(grid, n_in + 3) + mlp(e1, 3 * latent)
                  + mlp(mesh, 2 * latent) + mlp(grid, latent)
                  + steps * (mlp(e2, 3 * latent) + mlp(mesh, 2 * latent))
                  + mlp(e3, 3 * latent) + mlp(grid, 2 * latent)
                  + mlp(grid, latent, n_out))
    shared = mlp(mesh, 3) + mlp(e1, 4) + mlp(e2, 4) + mlp(e3, 4)
    return per_sample, shared


# path G-R's batch (the sea-ice recipe's)
GRAPHCAST_BATCH = 2
_ICE = {"siconc": (0.5, 0.3), "LSRCc": (0.0, 1e-6), "LSNKc": (0.0, 1e-6),
        "XPRTc": (0.0, 1e-7)}


def _graphcast_runners(device, nlat=180, nlon=360, builder=None):
    """``(train, rollout)`` of path G's recipe (the sea-ice recipe of
    ``tests/test_ice_train.py``: FloeNet at its builder's defaults, or
    ``builder``'s config; input masking, the ice corrector's budget
    correction, MSE, AdamW at 1e-3) at ``nlat`` x ``nlon`` over path O's
    random land mask (``_ocean_info``): ``train(n)``: ``n`` train steps on
    one batch of ``GRAPHCAST_BATCH``; ``rollout(n)``: ``n`` rollouts of
    ``INFERENCE_STEPS_IN_MEMORY`` steps at batch 1. Weights from a seed."""
    import dataclasses
    import datetime

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.loss import StepLossConfig
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.stepper.stepper import PrognosticState, StepperConfig
    from ace_tpu_torch.stepper.train import StepperTrainConfig, TrainStepper

    names = list(_ICE)
    config = from_dict(StepperConfig, {
        "input_masking": {"mask_value": 0, "fill_value": 0.0},
        "step": {"type": "single_module", "config": {
            "builder": {"type": "FloeNet", "config": builder or {}},
            "in_names": names, "out_names": names,
            "normalization": {"network": {
                "means": {k: v[0] for k, v in _ICE.items()},
                "stds": {k: v[1] for k, v in _ICE.items()}}},
            "corrector": {"type": "ice_corrector", "config": {
                "budget_correction": {"corrected_variables": {
                    "siconc": ["LSRCc", "LSNKc", "XPRTc"]}}}}}}})
    info = dataclasses.replace(_ocean_info(nlat, nlon),
                               vertical_coordinate=None,
                               timestep=datetime.timedelta(days=1))
    stepper = config.get_stepper(info, device=device)
    ts = TrainStepper(
        stepper, StepperTrainConfig(n_forward_steps=1, loss=from_dict(
            StepLossConfig, {"type": "MSE"})),
        OptimizationConfig(lr=1e-3, optimizer_type="AdamW"), EMAConfig())
    ts.init(torch.Generator(device).manual_seed(0))
    gen = torch.Generator(device).manual_seed(1)
    land = torch.as_tensor(info.mask_provider.masks["mask_2d"],
                           device=device) == 0

    def draw(batch, n_times):
        """The recipe's fields, NaN over land as in its files."""
        return {k: (torch.rand(batch, n_times, nlat, nlon, generator=gen,
                               device=device) * _ICE[k][1] + _ICE[k][0]
                    ).masked_fill(land, float("nan")) for k in names}

    batch = draw(GRAPHCAST_BATCH, 2)
    series = draw(1, INFERENCE_STEPS_IN_MEMORY + 1)
    ic = PrognosticState(data={k: series[k][:, :1]
                               for k in stepper.prognostic_names})
    forcing = {k: series[k] for k in stepper.forcing_window_names}

    def train(n):
        return [ts.train_step(batch, torch.Generator(device).manual_seed(3))
                for _ in range(n)]

    def rollout(n):
        for _ in range(n):
            outputs = stepper.predict(
                ic, forcing, n_forward=INFERENCE_STEPS_IN_MEMORY)[0]
        return outputs

    rollout.graphs = stepper.module.graphs
    return train, rollout


DOWNSCALING_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "baselines", "downscaling-hiro-global", "train.yaml")
DOWNSCALING_BATCH = 6
DOWNSCALING_PATCH = 16
DOWNSCALING_FACTOR = 32
DOWNSCALING_FINE = DOWNSCALING_PATCH * DOWNSCALING_FACTOR
# SongUNet's families beyond FAMILIES: cuDNN's convolutions (forward, data
# and weight gradients, their layout transposes), the group norms (forward
# and backward), the bottleneck attention's softmax, the SiLUs
_DOWNSCALING_FAMILIES = (
    ("convolutions (cuDNN, f32)", _CONVOLUTION[:-2] + ("xmma", "sm90")),
    ("group norms", ("group_norm", "groupnorm", "rowwisemoments",
                     "computefusedparams", "gammabeta")),
    ("softmax", ("softmax",)),
    ("SiLUs", ("silu",)))
downscaling_family = _family_by(_DOWNSCALING_FAMILIES)


def song_unet_flop(model) -> float:
    """The operations (2 per multiply-add) of the convolutions (the
    ``_Conv`` modules) of ``model``'s network in one forward of a
    ``DOWNSCALING_FINE``-sized sample at batch 1, counted from each call's
    kernel and output shapes (forward hooks)."""
    from ace_tpu_torch.downscaling.song_unet import _Conv

    total = [0.0]

    def count(module, args, out):
        out_c, in_c, kh, kw = module.kernel.shape
        total[0] += 2.0 * in_c * kh * kw * out[0].numel()

    net = model.net
    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, _Conv)]
    fine = net.img_resolution
    n_out = len(model.config.out_names)
    c_in = net.enc_plan[0].cin
    device = next(net.parameters()).device
    try:
        with torch.no_grad():
            net(torch.zeros(1, fine, fine, n_out, device=device),
                torch.zeros(1, fine, fine, c_in - n_out, device=device),
                torch.zeros(1, device=device))
    finally:
        for hook in hooks:
            hook.remove()
    return total[0]


def _downscaling_runners(device, module=None, batch=DOWNSCALING_BATCH,
                         patch=DOWNSCALING_PATCH, factor=DOWNSCALING_FACTOR):
    """``(train, sample)`` of path D's recipe (``DOWNSCALING_CONFIG``: its
    model, Adam and EMA; unit statistics in place of its files; a random
    static field), ``patch`` x ``patch`` coarse cells ``factor`` times
    finer: ``train(n)`` ``n`` train steps on one batch of ``batch``
    (dropout on, draws from a generator); ``sample(n)`` ``n`` Heun steps of
    the sampler (two denoiser calls each) at batch 1. Weights from a seed;
    ``module`` (a ``{type, config}``), ``batch``, ``patch`` and ``factor``
    make the small copy the CPU runs."""
    import numpy as np
    import yaml

    from ace_tpu_torch.core.config import from_dict
    from ace_tpu_torch.core.coordinates import LatLonCoordinates
    from ace_tpu_torch.core.dataset_info import DatasetInfo
    from ace_tpu_torch.core.optimization import EMAConfig, OptimizationConfig
    from ace_tpu_torch.downscaling.models import DiffusionModelConfig

    with open(DOWNSCALING_CONFIG) as f:
        data = yaml.safe_load(f)
    model_dict = dict(data["model"], downscale_factor=factor)
    if module is not None:
        model_dict["module"] = module
    names = set(model_dict["in_names"]) | set(model_dict["out_names"])
    unit = {"means": {k: 0.0 for k in names}, "stds": {k: 1.0 for k in names}}
    model_dict["normalization"] = {"coarse": unit, "fine": unit}
    info = DatasetInfo(horizontal_coordinates=LatLonCoordinates(
        lat=np.linspace(-60.0, 60.0, patch), lon=np.linspace(0.0, 90.0,
                                                             patch)))
    gen = torch.Generator(device).manual_seed(0)
    fine = patch * factor
    static = torch.randn(fine, fine, 1, generator=gen, device=device)
    model = from_dict(DiffusionModelConfig, model_dict).build(
        info, static_inputs=static.cpu().numpy(), device=device)
    model.init_params(gen)
    params = list(model.net.parameters())
    opt = from_dict(OptimizationConfig, data["optimization"]).build(1)
    opt.init(params)
    ema = from_dict(EMAConfig, data["ema"]).build()
    ema.init(params)
    coarse = {k: torch.randn(batch, patch, patch, generator=gen,
                             device=device) for k in model.config.in_names}
    target = {k: torch.randn(batch, fine, fine, generator=gen, device=device)
              for k in model.config.out_names}

    def train(n):
        losses = []
        for _ in range(n):
            loss = model.loss_fn(coarse, target, gen)
            grads = torch.autograd.grad(loss, params)
            opt.step(params, list(grads))
            ema(params)
            losses.append(loss.detach())
        return losses

    cond, _ = model._pack({k: v[:1] for k, v in coarse.items()}, None)
    denoiser = model._denoiser()
    x = torch.randn(1, fine, fine, len(model.config.out_names),
                    generator=gen, device=device)

    def sample(n):
        with torch.no_grad():
            for _ in range(n):
                d = denoiser(x, cond, 10.0)
                d = denoiser(d, cond, 5.0)
        return d

    sample.model = model
    return train, sample


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
