"""Host-side rendering of aggregator diagnostics to images/videos
(reference: fme/ace/aggregator/plotting.py — plot_imshow, HEALPix face
folding, paneled plots; fme/ace/aggregator/inference/video.py videos).

The reference sends these to wandb as Image/Video media. Without a wandb
backend the equivalent surface here is PNG/GIF files in the experiment
directory (plus wandb media when a real wandb run is configured). All
rendering is numpy/matplotlib on host — nothing here touches the TPU.

A copy of ``ace_tpu/aggregator/plotting.py`` (numpy on the host; tests hold it equal to
the original).
"""

import math

import numpy as np


def get_cmap_limits(data: np.ndarray, diverging: bool = False):
    """(reference: plotting.py:12) symmetric limits for diverging maps."""
    vmin = float(np.nanmin(data))
    vmax = float(np.nanmax(data))
    if diverging:
        limit = max(abs(vmin), abs(vmax))
        vmin, vmax = -limit, limit
    return vmin, vmax


def _is_healpix_data(data: np.ndarray) -> bool:
    return data.ndim == 3 and data.shape[0] == 12


def _roll_lon_by_n_pixels(data: np.ndarray, pixels: int = 5) -> np.ndarray:
    """(reference: plotting.py:25) shift the dateline off the plot edge."""
    if _is_healpix_data(data):
        return data
    return np.roll(data, pixels, axis=-1)


def fold_healpix_data(data: np.ndarray, fill_value: float) -> np.ndarray:
    """Panel the 12 HEALPix faces into the reference's diagonal layout
    (reference: plotting.py:75 fold_healpix_data)."""
    if not _is_healpix_data(data):
        raise ValueError(
            "first dimension must be 12 (face) for healpix data, "
            f"got shape {data.shape}"
        )
    blank = np.full_like(data[0], fill_value)
    panels = [
        [blank, blank, blank, data[3]],
        [blank, blank, data[2], data[7]],
        [blank, data[1], data[6], data[10]],
        [data[0], data[5], data[9], blank],
        [data[4], data[8], blank, blank],
        [data[11], blank, blank, blank],
    ]
    return np.concatenate(
        [np.concatenate(row, axis=1) for row in panels], axis=0
    )


def fold_if_healpix_data(data: np.ndarray, fill_value: float) -> np.ndarray:
    if _is_healpix_data(data):
        return fold_healpix_data(data, fill_value)
    return data


def _render_array(
    data: np.ndarray,
    vmin: float | None = None,
    vmax: float | None = None,
    cmap: str | None = None,
    flip_lat: bool = True,
    roll_lon: bool = True,
    use_colorbar: bool = True,
) -> np.ndarray:
    """Produce the plottable 2D array with the reference's conventions:
    lon roll, HEALPix folding, latitude flip (north up), and an inline
    colorbar strip (reference: plotting.py:32 plot_imshow)."""
    min_ = float(np.nanmin(data)) if vmin is None else vmin
    max_ = float(np.nanmax(data)) if vmax is None else vmax
    if roll_lon:
        data = _roll_lon_by_n_pixels(data)
    data = fold_if_healpix_data(data, fill_value=0.5 * (min_ + max_))
    if flip_lat:
        data = np.flip(data, axis=-2)
    if use_colorbar:
        height, width = data.shape
        colorbar_width = max(1, int(0.025 * width))
        range_ = np.linspace(min_, max_, height)
        range_ = np.repeat(range_[:, np.newaxis], colorbar_width, axis=1)
        range_ = np.flipud(range_)
        padding = np.full((height, colorbar_width), np.nan)
        data = np.concatenate((data, padding, range_), axis=1)
    return data


def plot_imshow(
    data: np.ndarray,
    vmin: float | None = None,
    vmax: float | None = None,
    cmap: str | None = None,
    flip_lat: bool = True,
    roll_lon: bool = True,
    use_colorbar: bool = True,
):
    """Render a 2D (or [12, H, W] HEALPix) field to a matplotlib Figure
    whose pixel size equals the array size (reference: plotting.py:32)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.figure import Figure

    arr = _render_array(data, vmin, vmax, cmap, flip_lat, roll_lon,
                        use_colorbar)
    figsize = np.array(arr.T.shape) / plt.rcParams["figure.dpi"]
    fig = Figure(figsize=figsize)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.imshow(arr, cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_axis_off()
    return fig


def plot_paneled_data(
    data: list[list[np.ndarray]],
    diverging: bool,
    roll_lon: bool = True,
):
    """Stitch rows of 2D arrays into one figure with shared limits
    (reference: plotting.py:119 plot_paneled_data)."""
    vmin = math.inf
    vmax = -math.inf
    for row in data:
        for arr in row:
            vmin = min(vmin, float(np.nanmin(arr)))
            vmax = max(vmax, float(np.nanmax(arr)))
    if diverging:
        limit = max(abs(vmin), abs(vmax))
        vmin, vmax = -limit, limit
    cmap = "RdBu_r" if diverging else None
    fill = 0.5 * (vmin + vmax)
    rows = []
    for row in data:
        folded = [fold_if_healpix_data(arr, fill) for arr in row]
        rows.append(np.concatenate(folded, axis=1))
    stitched = np.concatenate(rows, axis=0)
    return plot_imshow(stitched, vmin=vmin, vmax=vmax, cmap=cmap,
                       roll_lon=roll_lon)


def save_figure(fig, path: str):
    fig.savefig(path, dpi=fig.dpi)


def _colorize(frames: np.ndarray, diverging: bool) -> np.ndarray:
    """[T, H, W] float -> [T, H, W, 3] uint8 via a matplotlib colormap,
    with shared limits across frames."""
    import matplotlib

    cmap = matplotlib.colormaps["RdBu_r" if diverging else "viridis"]
    vmin, vmax = get_cmap_limits(frames, diverging)
    span = vmax - vmin if vmax > vmin else 1.0
    normed = np.clip((frames - vmin) / span, 0.0, 1.0)
    rgba = cmap(normed)
    return (rgba[..., :3] * 255).astype(np.uint8)


def save_video_gif(path: str, frames: np.ndarray, diverging: bool = False,
                   fps: int = 8, flip_lat: bool = True):
    """Render a [T, H, W] (or [T, 12, H, W] HEALPix) sequence to an
    animated GIF (the reference logs wandb.Video built from the same
    per-timestep maps, video.py:290)."""
    from PIL import Image as PILImage

    frames = np.asarray(frames, np.float64)
    if frames.ndim == 4 and frames.shape[1] == 12:
        fill = float(np.nanmean(frames))
        frames = np.stack(
            [fold_healpix_data(f, fill) for f in frames]
        )
    if flip_lat:
        frames = np.flip(frames, axis=-2)
    rgb = _colorize(frames, diverging)
    images = [PILImage.fromarray(f) for f in rgb]
    images[0].save(
        path, save_all=True, append_images=images[1:],
        duration=int(1000 / fps), loop=0,
    )
