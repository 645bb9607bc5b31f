"""Read and write the JAX package's checkpoints (port of
ace_tpu/stepper/checkpoint.py:30-90).

An ``ace_tpu`` checkpoint is one msgpack file written by flax's
serializer: the stepper config and dataset info as JSON strings, and the
parameter tree with arrays in flax's ndarray extension type. The port
encodes and decodes that layout with the ``msgpack`` package (needed only
here), rebuilds the stepper from the embedded config and maps the
parameters through ``utils/convert.py``, so that either package loads a
file the other wrote. Training checkpoints (optimizer state, EMA) wait for
the trainer's slice.
"""

import json
import os
import uuid

import numpy as np
import torch

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.stepper.stepper import Stepper, StepperConfig
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)

# flax.serialization's msgpack extension codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray_from_bytes(data: bytes):
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raw = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape
    )


def _ext_hook(code, data):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Reassemble arrays that flax split into chunks (leaves over 1 GiB)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path: str) -> dict:
    """Decode a checkpoint written by ``ace_tpu.stepper.checkpoint`` (or by
    :func:`save_msgpack`)."""
    import msgpack

    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(payload)


def _ndarray_to_bytes(array) -> bytes:
    import msgpack

    if isinstance(array, torch.Tensor):
        array = array.detach().cpu()
        if array.dtype == torch.bfloat16:
            raw = array.contiguous().view(torch.int16).numpy()
            return msgpack.packb((raw.shape, "bfloat16", raw.tobytes("C")),
                                 use_bin_type=True)
        array = array.numpy()
    array = np.asarray(array)
    return msgpack.packb((array.shape, array.dtype.name,
                          array.tobytes("C")), use_bin_type=True)


def _ext_pack(value):
    import msgpack

    if isinstance(value, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(value))
    if isinstance(value, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(value)))
    if isinstance(value, complex):
        return msgpack.ExtType(_EXT_COMPLEX,
                               msgpack.packb((value.real, value.imag)))
    return value


def save_msgpack(path: str, payload: dict):
    """Write ``payload`` in flax's msgpack layout, atomically (a temporary
    file, then a rename). Flax splits leaves over 1 GiB into chunks; no
    parameter of the port's models is that large, so none is split."""
    import msgpack

    blob = msgpack.packb(payload, default=_ext_pack, strict_types=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def get_stepper_state(stepper: Stepper, config: StepperConfig) -> dict:
    """The stepper's checkpoint entry: config, dataset info and the
    parameters in flax's tree (``{"params": ...}``), as ``ace_tpu``'s
    ``get_stepper_state`` lays them out. The port keeps no training
    history yet, so it writes an empty one."""
    return {
        "config": json.dumps(config.get_state()),
        "dataset_info": json.dumps(stepper.dataset_info.get_state()),
        "params": {"params": state_dict_to_flax_params(
            stepper.module.state_dict())},
        "training_history": json.dumps([]),
    }


def save_stepper(path: str, stepper: Stepper, config: StepperConfig):
    save_msgpack(path, {"stepper": get_stepper_state(stepper, config)})


def build_stepper_from_state(state: dict, device=None
                             ) -> tuple[Stepper, StepperConfig]:
    config = StepperConfig.from_state(json.loads(state["config"]))
    dataset_info = DatasetInfo.from_state(json.loads(state["dataset_info"]))
    stepper = config.get_stepper(dataset_info, device=device)
    stepper.load_state_dict(flax_params_to_state_dict(state["params"]))
    return stepper, config


def load_stepper(path: str, override=None, device=None) -> Stepper:
    """Rebuild a stepper from a checkpoint file, on ``device`` (CUDA by
    default), optionally applying a ``StepperOverrideConfig`` to the
    stored config (port of ace_tpu/stepper/checkpoint.py:80)."""
    state = load_msgpack(path)["stepper"]
    if override is not None:
        state = dict(state)
        state["config"] = json.dumps(
            override.apply(json.loads(state["config"])))
    stepper, _ = build_stepper_from_state(state, device=device)
    return stepper
