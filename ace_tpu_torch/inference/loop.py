"""The windowed inference loop (port of ace_tpu/inference/loop.py:37).

It pulls forcing windows from the host, rolls each out on the stepper's
device, threads the prognostic state (and one noise generator) from
window to window, computes derived variables, and feeds the writer and
the aggregator (with the targets of the same times, when ``target_names``
asks for them, as the trainer's inline inference does).

Host and device are double-buffered, as in the JAX package: window N's
forcing is copied to the device from pinned memory without waiting, its
rollout and derived variables are queued, and, when a writer wants the
outputs, so are their copies into pinned host buffers, closed by a CUDA
event. Only then does the host finish window N-1: it waits on that
window's event, writes, and queues the aggregator's reductions behind
window N's rollout. Without a writer (a ``NullDataWriter`` counts as
none) the outputs never leave the device: the aggregator reduces them
there, and nothing in the loop waits for the device. ``pipeline=False``
finishes each window before the next is read.

The noise comes from one ``torch.Generator`` on the stepper's device,
seeded 0, that runs on across windows (the JAX package splits a
``PRNGKey(0)`` per window: the two streams differ).

Under a multi-process ``placement`` (a data-parallel mesh) each process
rolls out its rows of the initial conditions (and ensemble members) with
its rows of each forcing window (``put_global``) and its rows of the
global batch's noise; each window's outputs are gathered into the global
batch on every process, whose derived variables, writer and aggregator
then see what one process would. Such a run takes the serial loop, as in
the JAX package: every process reaches each gather in step.
"""

import logging
import time as _time

import numpy as np
import torch

from ace_tpu_torch.core.derived_variables import compute_derived_for
from ace_tpu_torch.core.timing import GlobalTimer
from ace_tpu_torch.data.inference import InferenceGriddedData
from ace_tpu_torch.data.loading import BatchData
from ace_tpu_torch.data.time import TimeCoord
from ace_tpu_torch.stepper.stepper import PrognosticState, Stepper


def _start_host_copy(outputs: dict[str, torch.Tensor]):
    """Copies of ``outputs`` into pinned host memory that do not wait for
    the device, and the event that closes them (None on the CPU)."""
    if next(iter(outputs.values())).device.type != "cuda":
        return outputs, None
    host = {}
    for k, v in outputs.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_host_copy(host: dict[str, torch.Tensor], event
                      ) -> dict[str, np.ndarray]:
    if event is not None:
        event.synchronize()
    return {k: v.detach().cpu().numpy() for k, v in host.items()}


@torch.inference_mode()
def run_inference(
    stepper: Stepper,
    initial_condition: PrognosticState,
    forcing_data: InferenceGriddedData,
    writer=None,
    aggregator=None,
    forcing_deriver=None,
    n_ensemble: int = 1,
    pipeline: bool = True,
    target_names: list[str] | None = None,
    placement=None,
) -> dict:
    """Roll out over streaming forcing windows.

    ``initial_condition`` holds tensors on the stepper's device. The
    ``forward_prediction`` timer records only the queueing of the rollout:
    the wait for the device shows in ``data_writer`` (or at the end of the
    loop, without a writer). With ``target_names``, the dataset's values
    of those variables at the predicted times (and their derived
    variables) reach the aggregator as its targets, copied to the device
    as the forcing is. ``placement`` (a ``parallel.distributed.
    BatchPlacement``): ``initial_condition`` holds this process's rows.
    Returns ``total_steps``, ``total_steps_per_second`` (the device
    finished) and ``final_state`` (this process's rows).
    """
    from ace_tpu_torch.inference.data_writer import NullDataWriter

    if isinstance(writer, NullDataWriter):
        # a writer that writes nothing must not pull outputs to the host
        writer = None
    timer = GlobalTimer.get_instance()
    info = stepper.dataset_info
    # a hybrid sigma-pressure coordinate drives the atmosphere's derived
    # variables, a depth coordinate the ocean's
    vc = (info.atmosphere_vertical_coordinate
          if info.atmosphere_vertical_coordinate is not None
          else info.depth_coordinate)
    device = stepper.device
    state = stepper.get_initial_state(initial_condition)
    multiprocess = placement is not None and placement.multiprocess
    if multiprocess:
        pipeline = False
    generator = (placement.generator(0) if placement is not None
                 else torch.Generator(device).manual_seed(0))
    n_steps_done = 0
    t_start = _time.time()

    def derive(data, forcing):
        if vc is None:
            return data
        return compute_derived_for(
            data, vc, info.timestep,
            forcing_data={k: v[:, 1:] for k, v in forcing.items()},
        )

    target_windows = (forcing_data.target_windows(target_names)
                      if target_names else None)

    def finish(outputs, host_copy, target, out_time, k):
        """Host work for one window: the writer and the aggregator."""
        nonlocal n_steps_done
        if writer is not None:
            with timer.context("data_writer"):
                if host_copy is None:
                    host_copy = _start_host_copy(outputs)
                writer.append_batch(_finish_host_copy(*host_copy), out_time)
        if aggregator is not None:
            with timer.context("aggregator"):
                aggregator.record_batch(outputs, target, time=out_time)
        n_steps_done += out_time.values.shape[1]
        logging.info(
            f"window {k}: {n_steps_done}/{forcing_data.n_forward_steps} "
            "steps done"
        )

    pending = None
    for window, k in forcing_data.windows():
        with timer.context("data_loading"):
            forcing_np = window.data
            window_time = window.time
            if forcing_deriver is not None:
                forcing_np = forcing_deriver(window_time, dict(forcing_np))
            forcing_np = {k_: np.asarray(v) for k_, v in forcing_np.items()}
            if n_ensemble > 1:
                # forcing windows are per initial condition; tile them
                # member-major like the initial condition
                forcing_np = {k_: np.repeat(v, n_ensemble, axis=0)
                              for k_, v in forcing_np.items()}
                window_time = TimeCoord(
                    np.repeat(window_time.values, n_ensemble, axis=0),
                    window_time.calendar,
                )
            forcing = BatchData(forcing_np, window_time).to_device(device).data
            # the rollout's rows of the forcing
            local_forcing = ({k_: placement.put_global(v)
                              for k_, v in forcing_np.items()}
                             if multiprocess else forcing)
            target = None
            if target_windows is not None:
                target_np = {k_: np.asarray(v)[:, 1:] for k_, v in
                             next(target_windows)[0].data.items()}
                if n_ensemble > 1:
                    target_np = {k_: np.repeat(v, n_ensemble, axis=0)
                                 for k_, v in target_np.items()}
                target = BatchData(target_np, window_time).to_device(
                    device).data
        with timer.context("forward_prediction"):
            # the rollout length is explicit: a model without forcing
            # variables cannot infer it from an empty window
            outputs, state = stepper.predict(
                state, local_forcing, generator=generator,
                n_forward=window_time.values.shape[1] - 1,
            )
            if multiprocess:
                outputs = placement.gather(outputs)
            outputs = derive(outputs, forcing)
            if target is not None:
                target = derive(target, forcing)
            host_copy = (_start_host_copy(outputs)
                         if pipeline and writer is not None else None)
        out_time = TimeCoord(window_time.values[:, 1:], window_time.calendar)
        if not pipeline:
            finish(outputs, host_copy, target, out_time, k)
            continue
        if pending is not None:
            finish(*pending)
        pending = (outputs, host_copy, target, out_time, k)
    if pending is not None:
        finish(*pending)
    if device.type == "cuda":
        # the rate counts the device's work, not only its queueing
        torch.cuda.synchronize(device)
    elapsed = _time.time() - t_start
    total_steps = n_steps_done * forcing_data.n_initial_conditions
    summary = {
        "total_steps": total_steps,
        "total_steps_per_second": total_steps / max(elapsed, 1e-9),
        "final_state": state,
    }
    logging.info(
        f"inference: {total_steps} steps at "
        f"{summary['total_steps_per_second']:.2f} steps/s"
    )
    if writer is not None:
        writer.flush()
    return summary
