"""First-order conservative regridding between rectilinear lat-lon grids
(a copy of ace_tpu/ops/conservative_regrid.py: numpy on the host; the
tests hold it equal to the original).

On a rectilinear grid the conservative weight matrix factorizes into two
1-D overlap matrices: latitude overlaps measured in sin(lat) (exact cell
areas on the sphere) and longitude overlaps in degrees with periodic
wrap, so the regrid is two small dense matmuls.

Semantics match xesmf ``method="conservative"``:
- cell boundaries are midpoints between cell centers, clamped to the
  poles in latitude and periodic in longitude;
- each output cell's value is the area-weighted mean of the overlapping
  input cells, so the global area-weighted mean is conserved exactly;
- ``skipna``/``na_thres`` renormalize over valid (non-NaN) inputs: an
  output cell is valid when the valid-area fraction exceeds
  ``1 - na_thres`` (xesmf's rule; ``na_thres=1.0`` means NaN only where
  every contributing input is NaN).
"""

import numpy as np


def cell_bounds(centers: np.ndarray, lo=None, hi=None) -> np.ndarray:
    """Midpoint cell boundaries for monotonically increasing centers,
    optionally clamped to [lo, hi] at the edges (else edge cells are
    symmetric about their centers)."""
    centers = np.asarray(centers, dtype=np.float64)
    mid = 0.5 * (centers[1:] + centers[:-1])
    first = centers[0] - (mid[0] - centers[0]) if len(centers) > 1 else lo
    last = centers[-1] + (centers[-1] - mid[-1]) if len(centers) > 1 else hi
    b = np.concatenate([[first], mid, [last]])
    if lo is not None:
        b[0] = max(b[0], lo)
    if hi is not None:
        b[-1] = min(b[-1], hi)
    return b


def _overlap_matrix(b_in: np.ndarray, b_out: np.ndarray) -> np.ndarray:
    """[n_out, n_in] overlap lengths between 1-D cell boundary sets."""
    lo = np.maximum(b_out[:-1, None], b_in[None, :-1])
    hi = np.minimum(b_out[1:, None], b_in[None, 1:])
    return np.maximum(hi - lo, 0.0)


def latitude_weights(lat_in: np.ndarray, lat_out: np.ndarray) -> np.ndarray:
    """Conservative latitude weight matrix [n_out, n_in] in sin(lat)
    measure (proportional to spherical cell area). Accepts ascending or
    descending latitudes; weights are returned in the original orders."""
    lat_in = np.asarray(lat_in, dtype=np.float64)
    lat_out = np.asarray(lat_out, dtype=np.float64)
    flip_in = len(lat_in) > 1 and lat_in[0] > lat_in[-1]
    flip_out = len(lat_out) > 1 and lat_out[0] > lat_out[-1]
    li = lat_in[::-1] if flip_in else lat_in
    lo = lat_out[::-1] if flip_out else lat_out
    b_in = np.sin(np.deg2rad(cell_bounds(li, -90.0, 90.0)))
    b_out = np.sin(np.deg2rad(cell_bounds(lo, -90.0, 90.0)))
    w = _overlap_matrix(b_in, b_out)
    if flip_in:
        w = w[:, ::-1]
    if flip_out:
        w = w[::-1, :]
    return w


def longitude_weights(lon_in: np.ndarray, lon_out: np.ndarray) -> np.ndarray:
    """Conservative longitude weight matrix [n_out, n_in] in degrees,
    periodic over 360. Input/output longitudes may use any 360-degree
    branch (e.g. [-180, 180) or [0, 360))."""
    lon_in = np.mod(np.asarray(lon_in, dtype=np.float64), 360.0)
    lon_out = np.mod(np.asarray(lon_out, dtype=np.float64), 360.0)
    order_in = np.argsort(lon_in)
    order_out = np.argsort(lon_out)
    si, so = lon_in[order_in], lon_out[order_out]
    b_in = cell_bounds(np.concatenate([[si[-1] - 360.0], si, [si[0] + 360.0]]))[1:-1]
    b_out = cell_bounds(np.concatenate([[so[-1] - 360.0], so, [so[0] + 360.0]]))[1:-1]
    # three input copies cover any wrap of the output cells
    w = (
        _overlap_matrix(b_in - 360.0, b_out)
        + _overlap_matrix(b_in, b_out)
        + _overlap_matrix(b_in + 360.0, b_out)
    )
    out = np.zeros((len(lon_out), len(lon_in)))
    out[np.ix_(order_out, order_in)] = w
    return out


class ConservativeRegridder:
    """Conservative regridder between two rectilinear lat-lon grids.

    Apply to arrays shaped ``[..., nlat_in, nlon_in]``. With
    ``skipna=True``, NaN inputs are excluded and the result renormalized
    over the valid overlap area; cells whose valid fraction is below
    ``1 - na_thres`` become NaN.
    """

    def __init__(self, lat_in, lon_in, lat_out, lon_out):
        wlat = latitude_weights(lat_in, lat_out)
        wlon = longitude_weights(lon_in, lon_out)
        area_out = wlat.sum(axis=1)[:, None] * wlon.sum(axis=1)[None, :]
        if np.any(area_out <= 0):
            raise ValueError("output grid has cells outside the input domain")
        self._wlat = wlat
        self._wlon = wlon
        self._area_out = area_out
        self.lat_out = np.asarray(lat_out, dtype=np.float64)
        self.lon_out = np.asarray(lon_out, dtype=np.float64)

    def _apply_raw(self, x: np.ndarray) -> np.ndarray:
        y = np.einsum("ji,...ik->...jk", self._wlat, x)
        return np.einsum("lk,...jk->...jl", self._wlon, y)

    def __call__(self, x: np.ndarray, skipna: bool = False,
                 na_thres: float = 1.0) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if not skipna:
            return (self._apply_raw(x) / self._area_out).astype(np.float32)
        valid = np.isfinite(x)
        num = self._apply_raw(np.where(valid, x, 0.0))
        den = self._apply_raw(valid.astype(np.float64))
        frac = den / self._area_out
        # xesmf rule: keep cells whose valid fraction >= 1 - na_thres
        # (and strictly positive so all-NaN neighborhoods stay NaN)
        thresh = max(1.0 - float(na_thres), 0.0)
        ok = (frac > 0) & (frac >= thresh - 1e-12)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.where(ok, num / np.where(den > 0, den, 1.0), np.nan)
        return out.astype(np.float32)
