"""The port's histogram, ENSO and IPO index, seasonal, near-zero-fraction,
trend and video aggregators, and the multiplexer with every flag on,
against ``ace_tpu``'s on the same windows and times (8x16 and 17x32
grids). Histogram counts and edges must be equal; the other outputs are
float32 sums taken in another order on each side, held within
``RTOL``."""

import numpy as np
import pytest
import torch

from ace_tpu.aggregator import enso as jax_enso
from ace_tpu.aggregator import histogram as jax_histogram
from ace_tpu.aggregator import seasonal as jax_seasonal
from ace_tpu.aggregator import trend as jax_trend
from ace_tpu.aggregator import video as jax_video
from ace_tpu.aggregator.inference import (
    InferenceAggregatorConfig as JaxAggregatorConfig,
)
from ace_tpu.core import coordinates as jax_coords
from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.data import time as jax_time
from ace_tpu.data.dataset import XarrayDataConfig as JaxXarrayDataConfig
from ace_tpu.testing import SyntheticData
from ace_tpu_torch.aggregator import enso, histogram, seasonal, trend, video
from ace_tpu_torch.aggregator.inference import InferenceAggregatorConfig
from ace_tpu_torch.core import coordinates
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.data import time as port_time
from ace_tpu_torch.data.dataset import XarrayDataConfig

torch.set_num_threads(2)

# float32 sums in another order on each side
RTOL = 1e-5
B, NLAT, NLON = 2, 8, 16
NAMES = ["surface_temperature", "PRATEsfc"]


def _windows(n_windows=3, n_time=4, step_seconds=6 * 3600, seed=0,
             start="2001-11-20T00:00", nlat=NLAT, nlon=NLON):
    """Windows of (gen, target, JAX time, port time); the precipitation
    has zeros and negative values for the near-zero fraction."""
    rng = np.random.RandomState(seed)
    total = n_windows * n_time
    values = jax_time.TimeCoord.from_range(start, total, step_seconds).values
    out = []
    for w in range(n_windows):
        sl = slice(w * n_time, (w + 1) * n_time)
        tv = np.stack([values[sl] + b * 86400 * 10 ** 6 for b in range(B)])
        gen, tgt = {}, {}
        for k in NAMES:
            g = rng.randn(B, n_time, nlat, nlon).astype(np.float32)
            t = rng.randn(B, n_time, nlat, nlon).astype(np.float32)
            if k == "PRATEsfc":
                g = np.where(g > 0.5, 0.0, g * 1e-5).astype(np.float32)
            else:
                g, t = g * (1 + w) + 280.0, t + 280.0
            gen[k], tgt[k] = g, t
        out.append((gen, tgt, jax_time.TimeCoord(tv),
                    port_time.TimeCoord(tv)))
    return out


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def input_scale(key: str) -> float:
    """The size of the values summed into the output ``key`` (named by
    its variable, last in the key): float32 sums round at that size, and
    an output that is a difference of such sums (a variance, a trend, an
    anomaly, an RMSE of series) keeps that rounding, whatever its own
    size. Squared for the variance."""
    name = key.replace("/", "-").rsplit("-", 1)[-1]
    size = {"surface_temperature": 300.0}.get(name, 1.0)
    return size ** 2 if "gen_var" in key else size


def _assert_close(out: dict, ref: dict, exact=False, scale=input_scale):
    """Within ``RTOL`` of the larger of each array's largest value and the
    size of the values summed into it (``scale`` of its key)."""
    assert set(out) == set(ref), set(out) ^ set(ref)
    for k, r in ref.items():
        o = np.asarray(out[k])
        r = np.asarray(r)
        assert o.shape == r.shape, k
        if exact:
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            size = max(float(np.nanmax(np.abs(r))) if r.size else 0.0,
                       scale(k))
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=RTOL * size,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["grow_right", "grow_left", "on_edges",
                                  "constant"])
def test_dynamic_histogram_counts_equal_ace_tpu(case):
    """Range doubling to either side and values on the bin edges: the
    port gives the same counts and edges, and the
    interpolated percentiles are equal."""
    rng = np.random.RandomState(3)
    batches = [rng.randn(1000).astype(np.float32)]
    if case == "grow_right":
        batches += [rng.randn(500).astype(np.float32) * 5 + 8,
                    np.asarray([40.0, np.nan, np.inf], np.float32)]
    elif case == "grow_left":
        batches += [rng.randn(500).astype(np.float32) * 3 - 9,
                    np.asarray([-70.0], np.float32)]
    elif case == "on_edges":
        ref = jax_histogram.DynamicHistogram(n_bins=30)
        ref.add(batches[0])
        batches.append(ref.bin_edges.astype(np.float32))
        batches.append(np.float32(ref.bin_edges[[0, -1]]))
    else:
        batches = [np.full(50, 2.5, np.float32), np.full(5, 2.5, np.float32)]
    hists = (jax_histogram.DynamicHistogram(n_bins=30),
             histogram.DynamicHistogram(n_bins=30))
    for values in batches:
        for h in hists:
            h.add(values)
    ref, out = hists
    np.testing.assert_array_equal(out.bin_edges, ref.bin_edges)
    np.testing.assert_array_equal(out.counts, ref.counts)
    assert out.counts.sum() == sum(np.isfinite(b).sum() for b in batches)
    for q in (0.1, 5.0, 50.0, 97.5, 99.9999):
        assert out.percentile(q) == ref.percentile(q)


def test_histogram_aggregator_matches_ace_tpu():
    ref = jax_histogram.HistogramAggregator(
        percentiles=[99.0, 90.0], two_tailed_variables=["PRATEsfc"])
    out = histogram.HistogramAggregator(
        percentiles=[99.0, 90.0], two_tailed_variables=["PRATEsfc"])
    for gen, tgt, _, _ in _windows():
        ref.record_batch(gen, tgt)
        out.record_batch(_t(gen), _t(tgt))
    _assert_close(out.get_diagnostics(), ref.get_diagnostics(), exact=True)
    _assert_close(out.get_logs(), ref.get_logs(), exact=True)
    assert out.host_seconds > 0


def _nino_coords(module):
    """A grid with latitudes inside the Nino3.4 band."""
    return module.LatLonCoordinates(lat=np.linspace(-80, 80, 17),
                                    lon=np.linspace(0, 360, 32,
                                                    endpoint=False))


@pytest.mark.parametrize("with_time", [True, False])
def test_enso_index_matches_ace_tpu(with_time):
    """Daily windows over eight months: the monthly climatology, the
    running monthly mean and the correlation with the target index."""
    ref = jax_enso.EnsoIndexAggregator(_nino_coords(jax_coords))
    out = enso.EnsoIndexAggregator(_nino_coords(coordinates))
    for gen, tgt, jt, pt in _windows(n_windows=4, n_time=60,
                                     step_seconds=86400, nlat=17, nlon=32,
                                     start="2001-01-01T00:00"):
        ref.record_batch(gen, tgt, time=jt if with_time else None)
        out.record_batch(_t(gen), _t(tgt), time=pt if with_time else None)
    _assert_close(out.get_diagnostics(), ref.get_diagnostics())
    _assert_close(out.get_logs(), ref.get_logs())
    assert "enso/index_correlation" in out.get_logs()


def test_ipo_index_matches_ace_tpu():
    ref = jax_enso.IpoIndexAggregator(_nino_coords(jax_coords))
    out = enso.IpoIndexAggregator(_nino_coords(coordinates))
    for gen, tgt, jt, pt in _windows(nlat=17, nlon=32):
        ref.record_batch(gen, tgt, time=jt)
        out.record_batch(_t(gen), _t(tgt), time=pt)
    # the tripole's regions cancel: the index is a difference of
    # regional means of ~280
    _assert_close(out.get_diagnostics(), ref.get_diagnostics(),
                  scale=lambda k: 300.0)


def test_seasonal_and_near_zero_match_ace_tpu():
    """Windows that cross from SON into DJF, samples ten days apart."""
    ref, out = jax_seasonal.SeasonalAggregator(), seasonal.SeasonalAggregator()
    weights = np.cos(np.deg2rad(np.linspace(-80, 80, NLAT)))[:, None] * (
        np.ones(NLON))
    nz_ref = (jax_seasonal.NearZeroFractionAggregator(),
              jax_seasonal.NearZeroFractionAggregator(area_weights=weights))
    nz_out = (seasonal.NearZeroFractionAggregator(),
              seasonal.NearZeroFractionAggregator(area_weights=weights))
    for gen, tgt, jt, pt in _windows(n_time=20, step_seconds=86400):
        ref.record_batch(gen, jt, tgt)
        out.record_batch(_t(gen), pt, _t(tgt))
        for r, o in zip(nz_ref, nz_out):
            r.record_batch(gen)
            o.record_batch(_t(gen))
    _assert_close(out.get_diagnostics(), ref.get_diagnostics())
    _assert_close(out.get_logs(), ref.get_logs())
    assert {"DJF", "SON"} <= {k.split("-")[1] for k in out.get_diagnostics()}
    for r, o in zip(nz_ref, nz_out):
        _assert_close(o.get_logs(), r.get_logs())


def test_trend_matches_ace_tpu():
    ref, out = jax_trend.TrendAggregator(), trend.TrendAggregator()
    for gen, tgt, jt, pt in _windows(step_seconds=30 * 86400):
        ref.record_batch(gen, jt, tgt)
        out.record_batch(_t(gen), pt, _t(tgt))
    _assert_close(out.get_diagnostics(), ref.get_diagnostics())
    _assert_close(out.get_logs(), ref.get_logs())


@pytest.mark.parametrize("extended, drain_bytes", [
    (False, None), (True, None), (True, 1)])
def test_video_matches_ace_tpu(extended, drain_bytes):
    """Three windows of four steps into a video of ten (the last window
    is cut); with ``drain_bytes`` 1 every window drains at once."""
    ref = jax_video.VideoAggregator(10, enable_extended_videos=extended)
    out = video.VideoAggregator(10, enable_extended_videos=extended)
    if drain_bytes is not None:
        ref.DRAIN_BYTES = out.DRAIN_BYTES = drain_bytes
    for gen, tgt, _, _ in _windows():
        ref.record_batch(gen, tgt)
        out.record_batch(_t(gen), _t(tgt))
    assert out.forced_drains == (3 if drain_bytes else 0)
    _assert_close(out.get_diagnostics(), ref.get_diagnostics())
    _assert_close(out.get_logs(), ref.get_logs())


ALL_FLAGS = {
    "log_histograms": True, "log_enso_index": True,
    "log_seasonal_means": True, "log_near_zero_fraction": True,
    "log_video": True, "log_extended_video": True, "log_trends": True,
    "log_annual_means": True, "log_step_means": [{"step": 2}],
}


@pytest.fixture(scope="module")
def infos(tmp_path_factory):
    data = SyntheticData(tmp_path_factory.mktemp("aggregators") / "data",
                         NAMES, n_time=4, nlat=NLAT, nlon=NLON)
    return (JaxXarrayDataConfig(data_path=str(data.data_dir)).build()
            .dataset_info,
            from_dict(XarrayDataConfig, {"data_path": str(data.data_dir)})
            .build().dataset_info)


def test_every_aggregator_of_the_multiplexer_matches_ace_tpu(infos,
                                                             tmp_path):
    """``InferenceEvaluatorAggregator`` with every flag on: the same log
    keys and values and the same diagnostics files."""
    jax_info, info = infos
    ref = jax_from_dict(JaxAggregatorConfig, ALL_FLAGS).build(
        jax_info, n_timesteps=12)
    out = from_dict(InferenceAggregatorConfig, ALL_FLAGS).build(
        info, n_timesteps=12)
    for gen, tgt, jt, pt in _windows(step_seconds=40 * 86400):
        ref.record_batch(gen, tgt, time=jt)
        out.record_batch(_t(gen), _t(tgt), time=pt)
    logs, ref_logs = out.get_logs(), ref.get_logs()
    assert {k.split("/")[0] for k in logs} >= {
        "histogram", "enso", "seasonal", "near_zero_fraction", "video",
        "trend", "annual", "mean_step_2", "zonal_mean"} - {"zonal_mean"}
    _assert_close(logs, ref_logs)
    out.flush_diagnostics(str(tmp_path / "torch"))
    ref.flush_diagnostics(str(tmp_path / "jax"))
    from ace_tpu.data.store import open_file_dataset

    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for name in ("histogram", "enso", "seasonal", "trend", "video"):
        assert f"{name}_diagnostics.nc" in names
    for name in names:
        o, r = (open_file_dataset(str(tmp_path / side / name))
                for side in ("torch", "jax"))
        _assert_close({k: o[k].read(()) for k in o.keys()},
                      {k: r[k].read(()) for k in r.keys()},
                      exact=name == "histogram_diagnostics.nc")
