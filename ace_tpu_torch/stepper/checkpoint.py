"""Load the JAX package's checkpoints (port of the reading side of
ace_tpu/stepper/checkpoint.py).

An ``ace_tpu`` checkpoint is one msgpack file written by flax's
serializer: the stepper config and dataset info as JSON strings, and the
parameter tree with arrays in flax's ndarray extension type. The port
decodes it with the ``msgpack`` package (needed only here), rebuilds the
stepper from the embedded config and maps the parameters through
``utils/convert.py``.
"""

import json

import numpy as np
import torch

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.stepper.stepper import Stepper, StepperConfig
from ace_tpu_torch.utils.convert import flax_params_to_state_dict

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
    """Decode a checkpoint written by ``ace_tpu.stepper.checkpoint``."""
    import msgpack

    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(payload)


def build_stepper_from_state(state: dict, device=None
                             ) -> tuple[Stepper, StepperConfig]:
    config = StepperConfig.from_state(json.loads(state["config"]))
    dataset_info = DatasetInfo.from_state(json.loads(state["dataset_info"]))
    stepper = config.get_stepper(dataset_info, device=device)
    stepper.load_state_dict(flax_params_to_state_dict(state["params"]))
    return stepper, config


def load_stepper(path: str, device=None) -> Stepper:
    """Rebuild a stepper from an ``ace_tpu`` checkpoint file, on
    ``device`` (CUDA by default)."""
    stepper, _ = build_stepper_from_state(load_msgpack(path)["stepper"],
                                          device=device)
    return stepper
