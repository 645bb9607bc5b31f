"""Autoregressive rollout over a step (port of
ace_tpu/stepper/stepper.py).

Where the JAX package compiles the rollout as one ``lax.scan``, the port
runs a Python loop under ``torch.inference_mode()``: each step's outputs
stay on the device and are stacked once at the end, and nothing in the
loop waits for the device, so the host runs ahead and the device stays
busy. The caller syncs when it reads the results.
"""

import dataclasses
import logging
from typing import Any

import torch

from ace_tpu_torch.core.config import from_dict, to_dict
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.masking import StaticSpatialMaskingConfig
from ace_tpu_torch.core.step import StepArgs, StepperState, StepSelector
from ace_tpu_torch.core.step.single_module import SingleModuleStep
from ace_tpu_torch.core.training_history import TrainingHistory
from ace_tpu_torch.core.typing_ import TensorDict, TensorMapping

TIME_DIM = 1


@dataclasses.dataclass
class PrognosticState:
    """Prognostic fields with a size-``n_ic_timesteps`` time dim, usable
    as an initial condition."""

    data: TensorDict  # [batch, n_ic_timesteps, ...]
    stepper_state: StepperState = dataclasses.field(default_factory=dict)


class Stepper:
    """Rollout engine: threads prognostic state, per-sample stepper state
    and the noise generator through the forward steps."""

    def __init__(self, step: SingleModuleStep, input_masker=None):
        self.step = step
        self.has_params = False
        # the chain of training jobs behind the weights (saved with them)
        self.training_history = TrainingHistory()
        # output spatial masking from the dataset's "mask_*" fields: NaN
        # in each output's masked cells
        provider = step.dataset_info.mask_provider
        self.output_masker = (
            provider.build_output_masker() if provider is not None
            else _identity)
        # input spatial masking (``StepperConfig.input_masking``): refills
        # the masked cells of each step's inputs
        self.input_masker = input_masker or _identity
        if input_masker is None and provider is not None and provider.masks:
            logging.warning(
                "dataset has mask_* fields: outputs are NaN-filled in "
                "masked regions but no input_masking is configured; NaN "
                "will feed the network after the first step; set "
                "stepper.input_masking to refill masked inputs"
            )

    @property
    def device(self) -> torch.device:
        return self.step.device

    @property
    def module(self) -> torch.nn.Module:
        return self.step.module

    @property
    def prognostic_names(self) -> list[str]:
        return self.step.prognostic_names

    @property
    def out_names(self) -> list[str]:
        return self.step.output_names

    @property
    def forcing_window_names(self) -> list[str]:
        """All variables the forcing window must provide."""
        input_only = set(self.step.input_names) - set(self.step.output_names)
        return sorted(input_only | set(self.step.next_step_input_names))

    @property
    def n_ic_timesteps(self) -> int:
        return self.step.n_ic_timesteps

    @property
    def dataset_info(self) -> DatasetInfo:
        return self.step.dataset_info

    def init_params(self, generator: torch.Generator | None = None):
        """Draw the weights with ``generator`` (on the stepper's device)."""
        with torch.no_grad():
            self.step.init_params(generator)
        self.has_params = True

    def load_state_dict(self, state_dict: dict[str, torch.Tensor]):
        """Load the module's weights (``utils/convert.py`` makes them from
        a JAX parameter tree)."""
        self.module.load_state_dict(state_dict)
        self.has_params = True

    def get_initial_state(self, ic: PrognosticState) -> PrognosticState:
        """Seed stepper state (corrector references) from the IC if absent."""
        if ic.stepper_state:
            return ic
        ic_squeezed = {
            k: v[:, -1] if v.dim() > 3 else v for k, v in ic.data.items()
        }
        return PrognosticState(
            data=ic.data,
            stepper_state=self.step.init_stepper_state(ic_squeezed),
        )

    def predict_fn(self, ic_data: TensorMapping, forcing: TensorMapping,
                   stepper_state: StepperState,
                   generator: torch.Generator | None,
                   n_forward: int | None = None,
                   ) -> tuple[TensorDict, TensorDict, StepperState]:
        """The rollout loop.

        Args:
            ic_data: prognostic fields, each [batch, n_ic, ...spatial].
            forcing: forcing fields, each [batch, n_forward+1, ...spatial]
                (index 0 aligns with the IC).
            stepper_state: per-sample state (from ``get_initial_state``).
            generator: draws each step's noise (None: zero noise).
            n_forward: rollout length; required when the model has no
                forcing variables (otherwise inferred from them).

        Returns:
            (outputs, diagnostics, final_stepper_state); outputs are
            [batch, n_forward, ...spatial] for every output variable.
        """
        step = self.step
        prognostic_names = step.prognostic_names
        input_only = sorted(set(step.input_names) - set(step.output_names))
        nsf = set(step.next_step_forcing_names)
        nsi = step.next_step_input_names
        if n_forward is None:
            if not forcing:
                raise ValueError(
                    "n_forward is required when the model has no forcing "
                    "variables"
                )
            n_forward = next(iter(forcing.values())).shape[1] - 1

        state = {k: ic_data[k][:, -1] for k in prognostic_names}
        outputs: dict[str, list] = {}
        diagnostics: dict[str, list] = {}
        for t in range(n_forward):
            forcing_t = {
                k: forcing[k][:, t + 1 if k in nsf else t] for k in input_only
            }
            next_t = {k: forcing[k][:, t + 1] for k in nsi}
            out = step.step(StepArgs(
                input=self.input_masker({**state, **forcing_t}),
                next_step_input_data=self.input_masker(next_t),
                stepper_state=stepper_state,
                generator=generator,
            ))
            stepper_state = out.stepper_state
            masked = self.output_masker(out.output)
            state = {k: masked[k] for k in prognostic_names}
            for k, v in masked.items():
                outputs.setdefault(k, []).append(v)
            for k, v in out.corrector_diagnostics.items():
                diagnostics.setdefault(k, []).append(v)

        def stack(series):
            return {k: torch.stack(v, dim=TIME_DIM) for k, v in series.items()}

        return stack(outputs), stack(diagnostics), stepper_state

    def predict(self, initial_condition: PrognosticState,
                forcing: TensorMapping,
                generator: torch.Generator | None = None,
                n_forward: int | None = None,
                ) -> tuple[TensorDict, PrognosticState]:
        """Inference rollout with the loaded weights.

        ``forcing`` tensors are [batch, n_forward + n_ic, ...spatial] on
        the stepper's device. ``generator`` draws the noise; by default a
        generator on the stepper's device seeded with 0 (the JAX package's
        default ``PRNGKey(0)``). Returns the outputs [batch, n_forward,
        ...] and the final PrognosticState, all on the device; nothing here
        waits for the device, so reading them is the caller's one sync.
        """
        if not self.has_params:
            raise ValueError(
                "Stepper has no params; call init_params or load_state_dict"
            )
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        missing = set(self.forcing_window_names) - set(forcing)
        if missing:
            raise ValueError(f"forcing data missing variables {sorted(missing)}")
        forcing_subset = {k: forcing[k] for k in self.forcing_window_names}
        with torch.inference_mode():
            ic = self.get_initial_state(initial_condition)
            outputs, _, final_state = self.predict_fn(
                ic.data, forcing_subset, ic.stepper_state, generator,
                n_forward=n_forward,
            )
        next_ic = PrognosticState(
            data={
                k: outputs[k][:, -self.n_ic_timesteps:]
                for k in self.prognostic_names
            },
            stepper_state=final_state,
        )
        return outputs, next_ic


def _identity(data: TensorMapping) -> TensorDict:
    return dict(data)


@dataclasses.dataclass
class StepperConfig:
    """Top-level stepper configuration (port of
    ace_tpu/stepper/stepper.py:259). ``input_masking`` refills the
    statically masked cells of every step's inputs."""

    step: StepSelector
    input_masking: StaticSpatialMaskingConfig | None = None

    def get_stepper(self, dataset_info: DatasetInfo, device=None) -> Stepper:
        """Build the stepper on ``device`` (CUDA by default)."""
        step = self.step.get_step(dataset_info, device=device)
        input_masker = None
        if self.input_masking is not None:
            normalizer = getattr(step, "normalizer", None)
            input_masker = self.input_masking.build(
                dataset_info.mask_provider,
                means=getattr(normalizer, "means", None),
            )
        return Stepper(step, input_masker=input_masker)

    def get_state(self) -> dict:
        state = {"step": self.step.get_state()}
        if self.input_masking is not None:
            state["input_masking"] = to_dict(self.input_masking)
        return state

    @classmethod
    def from_state(cls, state: dict) -> "StepperConfig":
        input_masking = None
        if state.get("input_masking") is not None:
            input_masking = from_dict(StaticSpatialMaskingConfig,
                                      state["input_masking"])
        return cls(step=StepSelector.from_state(state["step"]),
                   input_masking=input_masking)


@dataclasses.dataclass
class CheckpointStepperConfig:
    """Define the stepper by loading its configuration from a saved
    checkpoint (port of ace_tpu/stepper/stepper.py:313). Weight
    initialization is separate."""

    checkpoint_path: str

    def to_stepper_config(self) -> "StepperConfig":
        import json

        from ace_tpu_torch.stepper.checkpoint import load_msgpack

        payload = load_msgpack(self.checkpoint_path)
        return StepperConfig.from_state(
            json.loads(payload["stepper"]["config"])
        )

    def get_stepper(self, dataset_info: DatasetInfo, device=None
                    ) -> "Stepper":
        return self.to_stepper_config().get_stepper(dataset_info,
                                                    device=device)


@dataclasses.dataclass
class StepperOverrideConfig:
    """Inference-time overrides of a serialized stepper's configuration
    (port of ace_tpu/stepper/stepper.py:345). "keep" leaves the stored
    value untouched."""

    ocean: Any = "keep"
    prescribed_prognostic_names: Any = "keep"
    # override the serialized MultiCall configuration: None disables
    # multi-call diagnostics at inference; a dict replaces/wraps with a
    # new MultiCallConfig (reference: single_module.py:1868)
    multi_call: Any = "keep"

    def apply(self, stepper_config_state: dict) -> dict:
        state = dict(stepper_config_state)
        step = dict(state.get("step", {}))
        step_cfg = dict(step.get("config", {}))
        # ocean/prescribed overrides act on the inner (module) step
        # config, which for a multi_call wrapper is the wrapped step
        inner_cfg = step_cfg
        if step.get("type") == "multi_call":
            wrapped = dict(step_cfg.get("wrapped_step", {}))
            inner_cfg = dict(wrapped.get("config", {}))
            wrapped["config"] = inner_cfg
            step_cfg["wrapped_step"] = wrapped
        if self.ocean != "keep":
            inner_cfg["ocean"] = self.ocean
        if self.prescribed_prognostic_names != "keep":
            inner_cfg["prescribed_prognostic_names"] = (
                list(self.prescribed_prognostic_names)
            )
        if self.multi_call != "keep":
            if step.get("type") == "multi_call":
                if self.multi_call is None:
                    step_cfg["config"] = None
                    step_cfg["include_multi_call_in_loss"] = False
                else:
                    step_cfg["config"] = self.multi_call
            elif self.multi_call is not None:
                step = {
                    "type": "multi_call",
                    "config": {
                        "wrapped_step": {
                            "type": step.get("type"),
                            "config": step_cfg,
                        },
                        "config": self.multi_call,
                        "include_multi_call_in_loss": False,
                    },
                }
                state["step"] = step
                return state
        step["config"] = step_cfg
        state["step"] = step
        return state
