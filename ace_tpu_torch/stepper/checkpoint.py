"""Read and write the JAX package's checkpoints (port of
ace_tpu/stepper/checkpoint.py).

An ``ace_tpu`` checkpoint is one msgpack file written by flax's
serializer: the stepper config, dataset info and training history as JSON
strings, and the parameter tree with arrays in flax's ndarray extension
type; a training checkpoint adds the optimizer state (optax's
``serialization.to_state_dict`` tree), the EMA's parameter tree and the
trainer's counters (``extra``, JSON). The port encodes and decodes that
layout with the ``msgpack`` package (needed only here), rebuilds the
stepper from the embedded config, lays the optimizer's moments out as
optax's chain and maps parameters, moments and EMA through
``utils/convert.py``, so that either package loads a file the other
wrote. This is the one module that knows the file's layout.
"""

import json
import os
import uuid

import numpy as np
import torch

from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.core.training_history import TrainingHistory
from ace_tpu_torch.stepper.stepper import Stepper, StepperConfig
from ace_tpu_torch.utils.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_variables,
)

# flax.serialization's msgpack extension codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


_BIN_LENGTH_BYTES = {0xC4: 1, 0xC5: 2, 0xC6: 4}


def _ndarray_from_bytes(data: bytes):
    """The array of flax's ndarray extension ``(shape, dtype name,
    bytes)``, as a view of ``data`` (the header is unpacked, the bytes
    are not copied)."""
    import msgpack

    unpacker = msgpack.Unpacker(raw=True)
    unpacker.feed(data[:1024])
    if unpacker.read_array_header() != 3:
        raise ValueError("not a flax ndarray extension")
    shape, dtype_name = unpacker.unpack(), unpacker.unpack()
    offset = unpacker.tell()
    size = _BIN_LENGTH_BYTES[data[offset]]
    n = int.from_bytes(data[offset + 1:offset + 1 + size], "big")
    offset += 1 + size
    if dtype_name == b"bfloat16":
        raw = np.frombuffer(data, dtype=np.uint16, count=n // 2,
                            offset=offset).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    dtype = np.dtype(dtype_name.decode())
    return np.frombuffer(data, dtype=dtype, count=n // dtype.itemsize,
                         offset=offset).reshape(shape)


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


# an ndarray extension from this size on is read into its own buffer
_DIRECT_READ_BYTES = 1 << 16


class _Reader:
    """A streaming msgpack decoder of what flax writes (maps, arrays,
    strings, binaries, numbers, nil, booleans, extensions), giving what
    ``msgpack.Unpacker(ext_hook=_ext_hook, raw=False)`` gives, except that
    the data of a large ndarray extension is read from the file straight
    into the array's own buffer: one copy, where the unpacker's buffer
    and the extension's bytes take two more."""

    def __init__(self, f):
        self.f = f

    def take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError("the checkpoint ends inside an object")
        return data

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map(t & 0x0F)
        if t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.uint(1 << (t - 0xC4)))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (t - 0xC7))
            return self.ext(int.from_bytes(self.take(1), "big", signed=True),
                            n)
        if t in (0xCA, 0xCB):
            return float(np.frombuffer(self.take(4 if t == 0xCA else 8),
                                       ">f4" if t == 0xCA else ">f8")[0])
        if 0xCC <= t <= 0xCF:
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:
            return int.from_bytes(self.take(1 << (t - 0xD0)), "big",
                                  signed=True)
        if 0xD4 <= t <= 0xD8:
            code = int.from_bytes(self.take(1), "big", signed=True)
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.take(self.uint(1 << (t - 0xD9))).decode()
        if t in (0xDC, 0xDD):
            n = self.uint(2 if t == 0xDC else 4)
            return [self.read() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map(self.uint(2 if t == 0xDE else 4))
        raise ValueError(f"msgpack type byte {t:#x} is not in a checkpoint")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, n: int):
        if code != _EXT_NDARRAY or n < _DIRECT_READ_BYTES:
            return _ext_hook(code, self.take(n))
        start = self.f.tell()
        if self.take(1) != b"\x93":
            raise ValueError("not a flax ndarray extension")
        shape, dtype_name = self.read(), self.read()
        size = _BIN_LENGTH_BYTES[self.take(1)[0]]
        nbytes = self.uint(size)
        if self.f.tell() - start + nbytes != n:
            raise ValueError("a flax ndarray extension of the wrong length")
        dtype = np.dtype(np.uint16 if dtype_name == "bfloat16"
                         else dtype_name)
        out = np.empty(nbytes // dtype.itemsize, dtype)
        if self.f.readinto(memoryview(out).cast("B")) != nbytes:
            raise ValueError("the checkpoint ends inside an array")
        out = out.reshape(shape)
        if dtype_name == "bfloat16":
            return torch.from_numpy(out).view(torch.bfloat16)
        return out


def load_msgpack(path: str) -> dict:
    """Decode a checkpoint written by ``ace_tpu.stepper.checkpoint`` (or by
    :func:`save_msgpack`), streamed: the file's bytes are not held beside
    its arrays."""
    with open(path, "rb") as f:
        payload = _Reader(f).read()
    return _unchunk(payload)


def _host_array(array) -> tuple[np.ndarray, str]:
    """A contiguous host array of ``array``'s bytes and flax's name of its
    dtype (numpy has no bfloat16: such tensors go as their int16 bits)."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().contiguous()
        if array.dtype == torch.bfloat16:
            return array.view(torch.int16).numpy(), "bfloat16"
        array = array.numpy()
    array = np.asarray(array)
    if not array.flags.c_contiguous:
        array = array.copy(order="C")
    return array, array.dtype.name


def _ndarray_to_bytes(array) -> bytes:
    import msgpack

    raw, dtype_name = _host_array(array)
    return msgpack.packb((raw.shape, dtype_name, raw.tobytes("C")),
                         use_bin_type=True)


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


# arrays from this size on are written from their own buffer
_DIRECT_BYTES = 1 << 20


def _write_array(f, array):
    """Write ``array`` as ``packer.pack`` would (flax's ndarray extension
    holding ``(shape, dtype name, bytes)``), with the data straight from
    the array's buffer instead of three copies of it. Used for arrays of
    at least ``_DIRECT_BYTES``, for which msgpack's encoding is always the
    32-bit extension and the 32-bit binary."""
    import msgpack

    raw, dtype_name = _host_array(array)
    head = (b"\x93" + msgpack.packb(list(raw.shape))
            + msgpack.packb(dtype_name)
            + b"\xc6" + raw.nbytes.to_bytes(4, "big"))
    f.write(b"\xc9" + (len(head) + raw.nbytes).to_bytes(4, "big")
            + bytes([_EXT_NDARRAY]) + head)
    f.write(memoryview(raw.reshape(-1)).cast("B"))


def _write_packed(f, packer, tree):
    """Stream ``tree`` into ``f``: the bytes ``msgpack.packb`` would give
    for the whole tree, one leaf at a time (a training checkpoint of the
    flagship is ~13 GB; no more than one leaf is held in host memory as
    bytes, and a large one is written from its own buffer)."""
    if isinstance(tree, dict):
        f.write(packer.pack_map_header(len(tree)))
        for key, value in tree.items():
            f.write(packer.pack(key))
            _write_packed(f, packer, value)
    elif (isinstance(tree, (np.ndarray, torch.Tensor))
          and tree.nbytes >= _DIRECT_BYTES):
        _write_array(f, tree)
    else:
        f.write(packer.pack(tree))


def save_msgpack(path: str, payload: dict):
    """Write ``payload`` in flax's msgpack layout, atomically (a temporary
    file, then a rename). Flax splits leaves over 1 GiB into chunks; no
    parameter of the port's models is that large, so none is split."""
    import msgpack

    packer = msgpack.Packer(default=_ext_pack, strict_types=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        _write_packed(f, packer, payload)
    os.replace(tmp, path)


def get_stepper_state(stepper: Stepper, config: StepperConfig) -> dict:
    """The stepper's checkpoint entry: config, dataset info, the
    parameters in flax's tree (``{"params": ...}``, or one such tree under
    each module's key for a multi-module step) and the training
    history, as ``ace_tpu``'s ``get_stepper_state`` lays them out."""
    return {
        "config": json.dumps(config.get_state()),
        "dataset_info": json.dumps(stepper.dataset_info.get_state()),
        "params": state_dict_to_flax_variables(stepper.module.state_dict()),
        "training_history": json.dumps(stepper.training_history.get_state()),
    }


def save_stepper(path: str, stepper: Stepper, config: StepperConfig):
    save_msgpack(path, {"stepper": get_stepper_state(stepper, config)})


def build_stepper_from_state(state: dict, device=None
                             ) -> tuple[Stepper, StepperConfig]:
    config = StepperConfig.from_state(json.loads(state["config"]))
    dataset_info = DatasetInfo.from_state(json.loads(state["dataset_info"]))
    stepper = config.get_stepper(dataset_info, device=device)
    stepper.load_state_dict(flax_params_to_state_dict(state["params"]))
    if "training_history" in state:
        stepper.training_history = TrainingHistory.from_state(
            json.loads(state["training_history"]))
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


def _optax_state(optimization, names: list[str]) -> dict:
    """The state optax keeps for the JAX package's optimizer of
    ``optimization``'s config, as ``serialization.to_state_dict`` lays it
    out: the chain (clipping, weight decay, Adam, the learning-rate
    schedule) as nested ``"0"``, ``"1"``, ... entries, the stateless links
    empty, and Adam's ``{count, mu, nu}``, the moments in flax's parameter
    tree (``names`` are the parameters' ``state_dict`` names, in the
    moments' order); the counts as int32. With gradient accumulation the
    chain is the ``inner_opt_state`` of ``optax.MultiSteps``'s state (its
    step counts and the running mean ``acc_grads``); with frozen
    parameters it is followed by ``optax.masked``'s empty state."""
    config = optimization.config

    def tree(tensors):
        return state_dict_to_flax_variables(dict(zip(names, tensors)))

    adam = {"count": np.asarray(optimization.adam_count, np.int32),
            "mu": tree(optimization.mu), "nu": tree(optimization.nu)}
    schedule = {"count": np.asarray(optimization.schedule_count, np.int32)}
    if config.optimizer_type == "AdamW":
        # chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)
        state = {"0": adam, "1": {}, "2": schedule}
    else:
        state = {"0": adam, "1": schedule}
        if dict(config.kwargs).get("weight_decay"):
            state = {"0": {}, "1": state}
    if config.max_grad_norm is not None:
        state = {"0": {}, "1": state}
    if optimization.every_k > 1:
        state = {
            "mini_step": np.asarray(optimization.mini_step, np.int32),
            "gradient_step": np.asarray(optimization.schedule_count,
                                        np.int32),
            "inner_opt_state": state,
            "acc_grads": tree(optimization.acc),
            "skip_state": {},
        }
    if optimization.frozen is not None:
        state = {"0": state, "1": {"inner_state": {}}}
    return state


def _find(node, keys: set):
    """The first dict in ``node`` (depth first) that holds ``keys``, and
    its parent."""
    if isinstance(node, dict):
        if keys <= set(node):
            return node, None
        for value in node.values():
            found, parent = _find(value, keys)
            if found is not None:
                return found, parent if parent is not None else node
    return None, None


def _adam_state(tree: dict) -> dict:
    """From the optax state of either package's file: Adam's ``count`` (an
    int) and moments ``mu`` and ``nu`` (``state_dict``s on the host), the
    schedule's ``schedule_count``, and under ``optax.MultiSteps`` its
    ``mini_step`` and running mean ``acc`` (else None)."""
    adam, chain = _find(tree, {"mu", "nu", "count"})
    if adam is None:
        raise ValueError("no Adam state {count, mu, nu} in the tree")
    count = int(np.asarray(adam["count"]))
    # the schedule's state is the chain's link that holds a count alone
    schedule = [v for v in (chain or {}).values()
                if isinstance(v, dict) and set(v) == {"count"}]
    out = {"count": count,
           "schedule_count": (int(np.asarray(schedule[0]["count"]))
                              if schedule else count),
           "mu": flax_params_to_state_dict(adam["mu"]),
           "nu": flax_params_to_state_dict(adam["nu"]),
           "mini_step": None, "acc": None}
    multi, _ = _find(tree, {"mini_step", "acc_grads"})
    if multi is not None:
        out["mini_step"] = int(np.asarray(multi["mini_step"]))
        out["acc"] = flax_params_to_state_dict(multi["acc_grads"])
    return out


def save_train_checkpoint(path: str, stepper: Stepper, config: StepperConfig,
                          optimization=None,
                          parameter_names: list[str] | None = None,
                          ema_state: dict[str, torch.Tensor] | None = None,
                          extra: dict | None = None):
    """A training checkpoint (port of ace_tpu/stepper/checkpoint.py:96):
    the stepper, and optionally the optimizer state of ``optimization``
    (an ``Optimization``, whose moments follow ``parameter_names``) as
    optax's tree, the EMA's weights (a ``state_dict``) and the trainer's
    counters (``extra``, stored as JSON)."""
    payload: dict = {"stepper": get_stepper_state(stepper, config)}
    if optimization is not None:
        if parameter_names is None:
            raise ValueError("the optimizer state needs parameter_names")
        payload["optimizer"] = _optax_state(optimization, parameter_names)
    if ema_state is not None:
        payload["ema"] = state_dict_to_flax_variables(ema_state)
    if extra:
        payload["extra"] = json.dumps(extra)
    save_msgpack(path, payload)


def read_train_checkpoint(path: str) -> dict:
    """A training checkpoint's parts on the host, without building its
    stepper: ``stepper_state`` (the raw stepper entry), ``params`` (the
    module's ``state_dict``), and where the file has them ``optimizer``
    (Adam's ``count`` and its moments ``mu`` and ``nu`` as ``state_dict``s),
    ``ema_state`` (a ``state_dict``) and ``extra``."""
    payload = load_msgpack(path)
    out: dict = {
        "stepper_state": payload["stepper"],
        "params": flax_params_to_state_dict(payload["stepper"]["params"]),
    }
    if "optimizer" in payload:
        out["optimizer"] = _adam_state(payload["optimizer"])
    if "ema" in payload:
        out["ema_state"] = flax_params_to_state_dict(payload["ema"])
    if "extra" in payload:
        out["extra"] = json.loads(payload["extra"])
    return out


def load_train_checkpoint(path: str, device=None) -> dict:
    """Read a training checkpoint of either package (port of
    ace_tpu/stepper/checkpoint.py:117): :func:`read_train_checkpoint`'s
    parts, with ``stepper`` (built on ``device``, CUDA by default) and its
    ``config`` in place of the raw stepper entry."""
    out = read_train_checkpoint(path)
    stepper, config = build_stepper_from_state(out.pop("stepper_state"),
                                               device=device)
    del out["params"]
    return {"stepper": stepper, "config": config, **out}
