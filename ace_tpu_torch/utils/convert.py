"""Conversion between the JAX package's flax parameter trees and the
port's ``state_dict``: parameters, gradients and the optimizer's
moments. The downscaling networks (SongUNetV2, the compact UNet, SwinIR)
map by the same rules: their modules carry flax's names, and the compact
UNet's attention kernels (3-D, ``DenseGeneral``'s) keep flax's layout."""

import numpy as np
import torch


# the subtrees of a step with several modules, each a flax variable tree
# (``{"params": ...}``), as the JAX package keys them; the port's
# ``nn.ModuleDict`` uses the same keys, so that ``main.block_0.x`` is flax's
# ``main/params/block_0/x``
MODULE_KEYS = frozenset({"main", "radiation", "secondary",
                         "secondary_decoder"})


def _is_module_tree(params: dict) -> bool:
    """A multi-module step's parameter tree: module keys, each over its
    own ``{"params": ...}``."""
    return bool(params) and set(params) <= MODULE_KEYS and all(
        isinstance(v, dict) and set(v) == {"params"} for v in params.values())


def _module_prefix(key: str) -> str | None:
    """The module key a ``state_dict`` key starts with, if any."""
    head = key.split(".", 1)[0]
    return head if head in MODULE_KEYS and "." in key else None


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


# a convolution's 4-D ``kernel`` (the port keeps flax's name): flax's [kh,
# kw, in, out] to F.conv2d's [out, in, kh, kw], and back
_CONV_TO_PORT = (3, 2, 0, 1)
_CONV_TO_FLAX = (2, 3, 1, 0)

# a spectral filter's ``filter/weight`` by its number of axes: the
# permutation from flax's layout to the port's. 4-D: the dhconv weight
# [in, out, l, 2] -> [2, l, in, out] (and a separable diagonal weight
# [in, l, m, 2] -> [2, m, in, l]); 5-D: the diagonal weight [in, out, l,
# m, 2] -> [2, l, m, in, out]. A separable dhconv weight (3-D) keeps
# flax's layout, as every other leaf does (CP factors, LayerNorm2d's [H,
# W, 1], position embeddings).
_FILTER_TO_PORT = {4: (3, 2, 0, 1), 5: (4, 2, 3, 0, 1)}
_FILTER_TO_FLAX = {
    n: tuple(perm.index(i) for i in range(n))
    for n, perm in _FILTER_TO_PORT.items()
}


# the names of a spectral filter's module: an SFNO block's ``filter``,
# FourCastNet3's global block's ``global_conv``. Other 4-D ``weight``
# leaves keep flax's layout: FourCastNet3's grouped DISCO weights
# (``local_conv/weight``, an encoder's or decoder's ``conv/weight``, [K,
# G, cin, cout])
_FILTER_MODULES = frozenset({"filter", "global_conv"})


def _is_spectral_filter(path, value) -> bool:
    """A spectral filter's weight in another layout than flax's: the
    ``weight`` of a ``_FILTER_MODULES`` module, 4-D or 5-D."""
    return (len(path) >= 2 and path[-1] == "weight"
            and path[-2] in _FILTER_MODULES
            and value.dim() in _FILTER_TO_PORT)


def flax_params_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Turn a flax parameter tree (as ``ace_tpu`` stores it in a
    checkpoint, with or without the top-level ``"params"`` collection)
    into the port's ``state_dict``.

    Tree paths become dotted keys. A 2-D ``kernel`` (flax ``Dense``,
    ``[in, out]``) becomes ``weight`` transposed to ``nn.Linear``'s
    ``[out, in]``, a 4-D one (flax ``Conv``, ``[kh, kw, in, out]``)
    keeps its name in ``F.conv2d``'s ``[out, in, kh, kw]``; a spectral filter's 4-D or 5-D ``weight`` (flax ``[in,
    out, l, 2]``, ``[in, out, l, m, 2]``) becomes the port's ``[2, l, in,
    out]``, ``[2, l, m, in, out]`` (``_FILTER_TO_PORT``); every other leaf
    keeps its name and layout. Values keep their dtype.
    """
    if set(params) == {"params"}:
        params = params["params"]
    if _is_module_tree(params):
        # a multi-module step: each module's subtree under its key
        params = {k: v["params"] for k, v in params.items()}
    state = {}
    for path, leaf in _flatten(params):
        value = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf, copy=True)
        )
        name = path[-1]
        if name == "kernel" and value.dim() == 2:
            name, value = "weight", value.t().contiguous()
        elif name == "kernel" and value.dim() == 4:
            value = value.permute(_CONV_TO_PORT).contiguous()
        elif _is_spectral_filter(path, value):
            value = value.permute(_FILTER_TO_PORT[value.dim()]).contiguous()
        state[".".join(path[:-1] + (name,))] = value
    return state


def state_dict_to_flax_params(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_params_to_state_dict`: dotted keys become
    a nested tree, a 2-D ``weight`` (``nn.Linear``'s ``[out, in]``)
    becomes a ``kernel`` ``[in, out]``, a convolution's 4-D ``kernel``
    flax's ``[kh, kw, in, out]``, and a spectral filter's weight flax's
    layout. Values become numpy
    arrays on the host, in their dtype (bfloat16 ones CPU tensors). Also
    maps gradients (``{name: p.grad}``, to compare them with ``jax.grad``
    in the flax layout) and the optimizer's moments."""
    tree: dict = {}
    for key, value in state.items():
        *path, name = key.split(".")
        array = value.detach().cpu()
        if name == "weight" and array.dim() == 2:
            name, array = "kernel", array.t()
        elif _is_spectral_filter(path + [name], array):
            array = array.permute(_FILTER_TO_FLAX[array.dim()])
        elif name == "kernel" and array.dim() == 4:
            array = array.permute(_CONV_TO_FLAX)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        # numpy has no bfloat16: such leaves stay tensors (the checkpoint
        # writer stores them under flax's "bfloat16" dtype name)
        array = array.contiguous()
        node[name] = array if array.dtype == torch.bfloat16 else array.numpy()
    return tree


def state_dict_to_flax_variables(state: dict[str, torch.Tensor]) -> dict:
    """:func:`state_dict_to_flax_params` as the JAX package's step holds
    the tree: ``{"params": ...}`` for one network, and for a multi-module
    step (keys under ``MODULE_KEYS``) each module's subtree as its own
    ``{"params": ...}`` under its key."""
    tree = state_dict_to_flax_params(state)
    if state and all(_module_prefix(k) for k in state):
        return {k: {"params": v} for k, v in tree.items()}
    return {"params": tree}


def flax_name(key: str, value: torch.Tensor) -> str:
    """The "/"-joined name ``ace_tpu`` gives the leaf that the port's
    ``state_dict`` entry ``key`` holds (``params/block_0/filter/weight``;
    a 2-D ``weight`` is flax's ``kernel``): the names that fine-tuning's
    wildcard rules are written against."""
    *path, name = key.split(".")
    if name == "weight" and value.dim() == 2:
        name = "kernel"
    if _module_prefix(key):
        return "/".join([path[0], "params", *path[1:], name])
    return "/".join(["params", *path, name])


def flax_view(key: str, value: torch.Tensor) -> torch.Tensor:
    """``value`` (the ``state_dict`` entry ``key``) as a view in flax's
    layout: a 2-D weight transposed, a convolution's and a spectral
    filter's weight permuted back to flax's axes; writing into the view writes into
    ``value``."""
    path = key.split(".")
    if path[-1] == "weight" and value.dim() == 2:
        return value.t()
    if _is_spectral_filter(path, value):
        return value.permute(_FILTER_TO_FLAX[value.dim()])
    if path[-1] == "kernel" and value.dim() == 4:
        return value.permute(_CONV_TO_FLAX)
    return value
