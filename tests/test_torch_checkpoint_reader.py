"""The port's checkpoint decoder (``stepper/checkpoint.load_msgpack``)
against flax's: a tree of every kind of leaf flax writes, large arrays
(read straight into their buffers) and small ones, written by flax and by
the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ace_tpu_torch.stepper import checkpoint


def _tree(rng):
    big = 1 << 15  # float32 elements: 128 KiB, read into its own buffer
    return {
        "params": {
            "w": rng.standard_normal((big // 64, 64)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "half": rng.standard_normal((256, 256)).astype(np.float16),
            "idx": np.arange(12, dtype=np.int64).reshape(3, 4),
            "wide": rng.standard_normal(big).astype(np.float64),
        },
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((128, 512)),
                                       jnp.bfloat16)),
        "bf16_small": np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16)),
        "scalar": np.float32(2.5),
        "count": np.int32(-3),
        "complex": 1.0 - 2.0j,
        "text": "ace", "none": None, "flag": True, "x": 0.25,
        "ints": [0, 127, 128, -1, -33, 1 << 40, -(1 << 40)],
        "nested": {"empty": {}, "list": [1, "two", {"three": 3.0}]},
        "bytes": b"\x00\x01\xff",
    }


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(b, torch.Tensor):
        b = b.view(torch.int16).numpy()
        a = np.asarray(a).view(np.int16)
    if isinstance(a, (np.ndarray, np.generic)):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.shape(a) == np.shape(b) and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("writer", ["flax", "port"])
def test_the_decoder_reads_what_flax_reads(tmp_path, writer):
    tree = _tree(np.random.default_rng(0))
    path = str(tmp_path / "ckpt.msgpack")
    if writer == "flax":
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(tree))
    else:
        checkpoint.save_msgpack(path, tree)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = checkpoint.load_msgpack(path)
    assert _same(want, got)
    # the large arrays were read into buffers of their own
    assert got["params"]["w"].flags.writeable
    assert got["params"]["wide"].flags.writeable


def test_the_decoder_refuses_a_cut_file(tmp_path):
    path = tmp_path / "ckpt.msgpack"
    data = serialization.msgpack_serialize(_tree(np.random.default_rng(1)))
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError):
        checkpoint.load_msgpack(str(path))
