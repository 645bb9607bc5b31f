"""Parameter conversion between the JAX package's flax trees and the
port's ``state_dict``."""

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _is_spectral_filter(path, value) -> bool:
    """The dhconv filter's weight: ``filter/weight`` of a block, 4-D
    (other 4-D leaves, such as convolution kernels, keep their layout)."""
    return tuple(path[-2:]) == ("filter", "weight") and value.dim() == 4


def flax_params_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Turn a flax parameter tree (as ``ace_tpu`` stores it in a
    checkpoint, with or without the top-level ``"params"`` collection)
    into the port's ``state_dict``.

    Tree paths become dotted keys. A 2-D ``kernel`` (flax ``Dense``,
    ``[in, out]``) becomes ``weight`` transposed to ``nn.Linear``'s
    ``[out, in]``; the spectral filter's ``weight`` (flax ``[in, out, l,
    2]``) becomes the port's ``[2, l, in, out]``; every other leaf keeps
    its name and layout. Values keep their dtype.
    """
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, leaf in _flatten(params):
        value = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf, copy=True)
        )
        name = path[-1]
        if name == "kernel" and value.dim() == 2:
            name, value = "weight", value.t().contiguous()
        elif _is_spectral_filter(path, value):
            value = value.permute(3, 2, 0, 1).contiguous()
        state[".".join(path[:-1] + (name,))] = value
    return state


def state_dict_to_flax_params(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_params_to_state_dict`: dotted keys become
    a nested tree, a 2-D ``weight`` (``nn.Linear``'s ``[out, in]``)
    becomes a ``kernel`` ``[in, out]``, and the spectral filter's ``[2, l,
    in, out]`` weight flax's ``[in, out, l, 2]``. Values become numpy
    arrays on the host, in their dtype. Also maps gradients: pass
    ``{name: p.grad}`` to compare them with ``jax.grad`` in the flax
    layout."""
    tree: dict = {}
    for key, value in state.items():
        *path, name = key.split(".")
        array = value.detach().cpu()
        if name == "weight" and array.dim() == 2:
            name, array = "kernel", array.t()
        elif _is_spectral_filter(path + [name], array):
            array = array.permute(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = array.contiguous().numpy()
    return tree
