"""Patch decomposition and recomposition for downscaling over large grids
(port of ace_tpu/downscaling/patching.py)."""

import dataclasses
from itertools import product

import torch

from ace_tpu_torch.core.typing_ import TensorDict


@dataclasses.dataclass
class HorizontalSlice:
    y: slice
    x: slice


@dataclasses.dataclass
class Patch:
    """The input slice (shifted to stay in bounds) and the output slice
    that trims the prediction so that overlaps stay consistent."""

    input_slice: HorizontalSlice
    output_slice: HorizontalSlice


def _divide_into_slices(full_size: int, patch_size: int,
                        overlap: int) -> list[slice]:
    slices = [slice(0, patch_size)]
    stop = slices[-1].stop
    while stop < full_size:
        next_start = stop - overlap
        slices.append(slice(next_start, next_start + patch_size))
        stop = slices[-1].stop
    return slices


def _get_patch_slices(full_size: int, patch_slice: slice):
    if patch_slice.stop > full_size:
        oob = patch_slice.stop - full_size
        return (slice(patch_slice.start - oob, full_size), slice(oob, None))
    return patch_slice, slice(None, None)


def get_patches(yx_extent, yx_patch_extent, overlap: int,
                drop_partial_patches: bool = True, y_offset: int = 0,
                x_offset: int = 0) -> list[Patch]:
    """The patches covering ``yx_extent``."""
    y_slices = _divide_into_slices(yx_extent[0], yx_patch_extent[0], overlap)
    x_slices = _divide_into_slices(yx_extent[1], yx_patch_extent[1], overlap)
    y_slices = [slice(s.start + y_offset, s.stop + y_offset)
                for s in y_slices]
    x_slices = [slice(s.start + x_offset, s.stop + x_offset)
                for s in x_slices]
    if drop_partial_patches:
        if y_slices[-1].stop > yx_extent[0]:
            y_slices.pop()
        if x_slices[-1].stop > yx_extent[1]:
            x_slices.pop()
    patches = []
    for y_sl, x_sl in product(y_slices, x_slices):
        y_in, y_out = _get_patch_slices(yx_extent[0], y_sl)
        x_in, x_out = _get_patch_slices(yx_extent[1], x_sl)
        patches.append(Patch(HorizontalSlice(y_in, x_in),
                             HorizontalSlice(y_out, x_out)))
    return patches


def scale_patch(patch: Patch, factor: int) -> Patch:
    """A coarse-grid patch scaled to the fine grid."""

    def _scale(s: slice) -> slice:
        return slice(None if s.start is None else s.start * factor,
                     None if s.stop is None else s.stop * factor)

    return Patch(
        HorizontalSlice(_scale(patch.input_slice.y),
                        _scale(patch.input_slice.x)),
        HorizontalSlice(_scale(patch.output_slice.y),
                        _scale(patch.output_slice.x)),
    )


def composite_patch_predictions(predictions: list[TensorDict],
                                patches: list[Patch]) -> TensorDict:
    """Full-extent fields from patch predictions ``[..., H_patch,
    W_patch]``, overlaps averaged."""
    if len(predictions) != len(patches):
        raise ValueError("number of predictions must match patches")
    y_size = max(p.input_slice.y.stop for p in patches)
    x_size = max(p.input_slice.x.stop for p in patches)
    out: TensorDict = {}
    for name in predictions[0]:
        first = predictions[0][name]
        total = torch.zeros((*first.shape[:-2], y_size, x_size),
                            dtype=torch.float32, device=first.device)
        count = torch.zeros((y_size, x_size), dtype=torch.float32,
                            device=first.device)
        for pred, patch in zip(predictions, patches):
            in_sl, out_sl = patch.input_slice, patch.output_slice
            adj_y = slice(in_sl.y.start + (out_sl.y.start or 0), in_sl.y.stop)
            adj_x = slice(in_sl.x.start + (out_sl.x.start or 0), in_sl.x.stop)
            total[..., adj_y, adj_x] += pred[name][..., out_sl.y, out_sl.x]
            count[adj_y, adj_x] += 1.0
        out[name] = total / count
    return out
