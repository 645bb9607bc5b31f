"""The port's GraphCast graphs and GNN (``ace_tpu_torch/models/graphcast.py``)
and LandNet against ``ace_tpu``: every copied graph function and
``build_graphs``' arrays exactly; the fast ``radius_query`` and
``containing_triangle`` equal to ``ace_tpu``'s brute force (and to the
port's brute-force copies) on several grids, a 1° grid among them, and on
points placed on mesh edges and vertices, where the closest face is a
tie decided by rounding; GraphCast with and without a mask, FloeNet and
LandNet through the registries, within 1e-5 of the reference's largest
value, with GraphCast's gradients within 1e-3 of each gradient's norm;
the segment sum and the gathers' gradients. Small sizes (``meshes`` up to
4, latent width 8); ``ace_tpu``'s networks run eagerly on weights made
from the port's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.core.config import from_dict as jax_from_dict
from ace_tpu.core.coordinates import LatLonCoordinates as JaxLatLon
from ace_tpu.core.dataset_info import DatasetInfo as JaxDatasetInfo
from ace_tpu.models import graphcast as jax_gc
from ace_tpu.models.registry import ModuleSelector as JaxModuleSelector
from ace_tpu_torch.core.config import from_dict
from ace_tpu_torch.core.coordinates import LatLonCoordinates
from ace_tpu_torch.core.dataset_info import DatasetInfo
from ace_tpu_torch.models import graphcast as gc
from ace_tpu_torch.models.layers import init_weights
from ace_tpu_torch.models.registry import ModuleSelector
from ace_tpu_torch.utils.convert import state_dict_to_flax_params

torch.set_num_threads(2)

OUT_TOL = 1e-5
GRAD_TOL = 1e-3


def _grid(nlat, nlon, offset=0.0):
    lat = np.linspace(-90 + 90 / nlat, 90 - 90 / nlat, nlat)
    lon = np.linspace(0, 360, nlon, endpoint=False) + offset
    return np.meshgrid(lat, lon, indexing="ij")


def _one_degree():
    lat2d, lon2d = _grid(180, 360, 0.5)
    return jax_gc.latlon_to_xyz(lat2d.ravel(), lon2d.ravel())


def _edge_and_vertex_points(mesh, seed=0):
    """Points on the mesh's vertices, on its edges (random fractions and
    midpoints, projected to the sphere) and on the chords themselves."""
    v = mesh.vertices.astype(np.float64)
    s, r = jax_gc.faces_to_edges(mesh.faces)
    t = np.random.default_rng(seed).random(len(s))[:, None]
    on_edges = v[s] * (1 - t) + v[r] * t
    mid = (v[s] + v[r]) / 2
    unit = [p / np.linalg.norm(p, axis=1, keepdims=True)
            for p in (on_edges, mid)]
    return np.concatenate([v, *unit, mid])


# ---- exact: the copied numpy functions ----


def test_mesh_functions_equal_ace_tpu():
    """The icosahedron, each subdivision, the hierarchy, the multimesh,
    the edges and the largest edge."""
    ref, got = jax_gc.get_mesh_hierarchy(3), gc.get_mesh_hierarchy(3)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.vertices, a.vertices)
        assert b.vertices.dtype == a.vertices.dtype == np.float32
        np.testing.assert_array_equal(b.faces, a.faces)
    for a, b in zip(jax_gc.merge_meshes(ref[1:]).faces,
                    gc.merge_meshes(got[1:]).faces):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jax_gc.faces_to_edges(ref[-1].faces),
                    gc.faces_to_edges(got[-1].faces)):
        np.testing.assert_array_equal(b, a)
    assert gc.max_edge_distance(got[-1]) == jax_gc.max_edge_distance(ref[-1])


def test_geometry_and_features_equal_ace_tpu():
    """The coordinate maps, the node and edge features and the receivers'
    local frames, on a grid and a mesh."""
    lat2d, lon2d = _grid(12, 24)
    lat, lon = lat2d.ravel(), lon2d.ravel()
    xyz = gc.latlon_to_xyz(lat, lon)
    np.testing.assert_array_equal(xyz, jax_gc.latlon_to_xyz(lat, lon))
    mesh = gc.get_mesh_hierarchy(2)[-1]
    for a, b in zip(gc.xyz_to_latlon(mesh.vertices),
                    jax_gc.xyz_to_latlon(mesh.vertices)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gc.node_features(lat, lon),
                                  jax_gc.node_features(lat, lon))
    mlat, mlon = gc.xyz_to_latlon(mesh.vertices)
    s, r = gc.faces_to_edges(mesh.faces)
    for fn in ("edge_features", "_receiver_local_relative_positions"):
        np.testing.assert_array_equal(
            getattr(gc, fn)(mesh.vertices, mlat, mlon, s, r),
            getattr(jax_gc, fn)(mesh.vertices, mlat, mlon, s, r))
    gs = np.arange(len(xyz)) % len(mesh.vertices)
    args = (xyz, lat, lon, mesh.vertices, mlat, mlon, np.arange(len(xyz)), gs)
    np.testing.assert_array_equal(gc._bipartite_edge_feats(*args),
                                  jax_gc._bipartite_edge_feats(*args))


# ---- exact: the graph queries ----

QUERY_CASES = {
    # (grid points, mesh level, the radius query's mesh chunk: below the
    # mesh's nodes, its pairs come in several chunks, as at meshes 5-6)
    "8x16-level2": (lambda: gc.latlon_to_xyz(*(g.ravel() for g in _grid(
        8, 16))), 2, 4096),
    "45x90-shifted-level3-chunked": (
        lambda: gc.latlon_to_xyz(*(g.ravel() for g in _grid(45, 90, 2.0))),
        3, 100),
    "1-degree-level1": (_one_degree, 1, 4096),
    # a seeded sample of the 1° grid: ace_tpu's brute force takes 4 min
    # for all of it at this level
    "1-degree-sample-level4-chunked": (lambda: _one_degree()[np.sort(
        np.random.default_rng(1).choice(64800, 1500, replace=False))], 4,
        1000),
    "edges-and-vertices-level3": (lambda: _edge_and_vertex_points(
        gc.get_mesh_hierarchy(3)[-1])[::2], 3, 4096),
}


@pytest.mark.parametrize("name", list(QUERY_CASES))
def test_fast_queries_return_ace_tpus_arrays(name):
    """The grid-to-mesh pairs (same pairs, same order) and each point's
    closest face equal ``ace_tpu``'s brute force, and the port's
    brute-force copies equal it too."""
    points, level, chunk = QUERY_CASES[name]
    xyz = points()
    mesh = gc.get_mesh_hierarchy(level)[-1]
    radius = gc.max_edge_distance(mesh)
    ref = jax_gc.radius_query(xyz, mesh.vertices, radius, chunk=chunk)
    for got in (gc.radius_query(xyz, mesh.vertices, radius, chunk=chunk),
                gc.radius_query_brute(xyz, mesh.vertices, radius,
                                      chunk=chunk)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    ref_tri = jax_gc.containing_triangle(xyz, mesh)
    np.testing.assert_array_equal(gc.containing_triangle(xyz, mesh), ref_tri)
    np.testing.assert_array_equal(gc.containing_triangle_brute(xyz, mesh),
                                  ref_tri)


def test_edge_points_are_ties_decided_by_rounding():
    """On the edge points, many closest faces are exact ties in exact
    arithmetic: the second-closest face lies within a few ulps of the
    closest, so the tie-break (lowest index) and the rounding both count."""
    mesh = gc.get_mesh_hierarchy(3)[-1]
    xyz = _edge_and_vertex_points(mesh)[:2000]
    tri = mesh.vertices.astype(np.float64)[mesh.faces]
    d = gc._closest_distance(xyz[:, None], tri[None, :, 0], tri[None, :, 1],
                             tri[None, :, 2])
    two = np.sort(d, axis=1)[:, :2]
    assert int((two[:, 1] - two[:, 0] <= 4 * np.spacing(two[:, 0])).sum()) \
        > 500


ARRAYS = [f.name for f in dataclasses.fields(gc.GraphCastGraphs)
          if f.name not in ("n_grid", "n_mesh")]


def test_radius_query_near_the_radius_takes_the_brute_forces_pairs(
        monkeypatch):
    """Pairs whose squared distance lies within ``_RADIUS_BAND`` of the
    radius's square hand their grid points to the brute force: with the
    band wide enough to take every pair, the result is still
    ``ace_tpu``'s, in its order."""
    xyz = gc.latlon_to_xyz(*(g.ravel() for g in _grid(12, 24, 1.0)))
    mesh = gc.get_mesh_hierarchy(2)[-1]
    radius = gc.max_edge_distance(mesh)
    monkeypatch.setattr(gc, "_RADIUS_BAND", 10.0)
    for a, b in zip(gc.radius_query(xyz, mesh.vertices, radius, chunk=100),
                    jax_gc.radius_query(xyz, mesh.vertices, radius,
                                        chunk=100)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_build_graphs_arrays_equal_ace_tpu(masked):
    """Every array of ``build_graphs`` (features, senders, receivers) at
    two mesh levels, with and without a mask."""
    lat2d, lon2d = _grid(16, 32)
    mask = (np.random.default_rng(2).random(lat2d.shape) > 0.3
            if masked else None)
    ref = jax_gc.build_graphs(lat2d, lon2d, meshes=3, M0=1, mask=mask)
    got = gc.build_graphs(lat2d, lon2d, meshes=3, M0=1, mask=mask)
    assert (got.n_grid, got.n_mesh) == (ref.n_grid, ref.n_mesh)
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---- 1e-5: the networks ----


def _weights(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("scale") or "pos_embed" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(seed + 1)))
    return {"params": state_dict_to_flax_params(module.state_dict())}


def _assert_tree_shapes(params, jmodule, x):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), x)
    assert (jax.tree_util.tree_map(lambda v: tuple(v.shape), params)
            == jax.tree_util.tree_map(lambda v: tuple(v.shape),
                                      dict(shapes)))


def _close(got, ref, tol=OUT_TOL):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


NLAT, NLON, N_IN, N_OUT = 8, 16, 5, 3


def _draw(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_graphcast_matches_ace_tpu(masked):
    """The encoder, two processor steps and the decoder, every option at
    its non-default where it has one (no residual, tanh-form GELU) in the
    masked case: the output within 1e-5 (zeros off the mask) and, masked,
    every gradient within ``GRAD_TOL`` of ``jax.grad``'s norm (the
    unmasked net's gradients are held through the training entries,
    ``tests/test_torch_swin_graphcast_path.py``)."""
    lat2d, lon2d = _grid(NLAT, NLON)
    mask = (np.random.default_rng(3).random(lat2d.shape) > 0.3
            if masked else None)
    kw = dict(img_shape=(NLAT, NLON), in_chans=N_IN, out_chans=N_OUT,
              lat2d=lat2d, lon2d=lon2d, latent_dimension=8, meshes=2, M0=1,
              processor_steps=2, mask=mask)
    if masked:
        kw.update(residual=False, activation="gelu", radius_fraction=1.3)
    module, jmodule = gc.GraphCast(**kw), jax_gc.GraphCast(**kw)
    params = _weights(module)
    x = _draw((2, NLAT, NLON, N_IN))
    _assert_tree_shapes(params, jmodule, jnp.asarray(x))
    target = _draw((2, NLAT, NLON, N_OUT), 1)

    def jax_loss(p):
        out = jmodule.apply(p, jnp.asarray(x))
        return jnp.mean((out - jnp.asarray(target)) ** 2), out

    out = module(torch.from_numpy(x))
    if not masked:
        _close(out, jmodule.apply(params, jnp.asarray(x)))
        assert "g2m_senders" not in module.state_dict()
        return
    (_, ref), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    _close(out, ref)
    assert not out.detach().numpy()[:, ~mask].any()
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    grads = state_dict_to_flax_params(
        {k: p.grad for k, p in module.named_parameters()})
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref_grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(
            {"params": grads})[0]:
        r = np.asarray(flat_ref[path])
        assert np.linalg.norm(g - r) <= GRAD_TOL * max(np.linalg.norm(r),
                                                       1e-12), path
    assert "g2m_senders" not in module.state_dict()


def _registry_nets(builder):
    lat2d, lon2d = _grid(NLAT, NLON)
    lat, lon = lat2d[:, 0], lon2d[0]
    net = from_dict(ModuleSelector, builder).build(
        N_IN, N_OUT, DatasetInfo(
            horizontal_coordinates=LatLonCoordinates(lat, lon)),
        device="cpu")
    jnet = jax_from_dict(JaxModuleSelector, builder).build(
        N_IN, N_OUT, JaxDatasetInfo(horizontal_coordinates=JaxLatLon(lat,
                                                                     lon)))
    return net, jnet


@pytest.mark.parametrize("builder", [
    {"type": "FloeNet", "config": {"latent_dimension": 8, "meshes": 3,
                                   "M0": 4, "activation": "SiLU",
                                   "processor_steps": 1, "is_ocean": True}},
    {"type": "GraphCast", "config": {"latent_dimension": 8, "meshes": 2,
                                     "M0": 0, "bias": False,
                                     "layernorm": False}},
    {"type": "LandNet", "config": {}},
    {"type": "LandNet", "config": {"hidden_dims": [16, 8, 8],
                                   "use_positional_embedding": True}},
], ids=["floenet-ice-test", "graphcast-no-bias-no-norm", "landnet",
        "landnet-pos-embed"])
def test_registry_nets_match_ace_tpu(builder):
    """FloeNet (the ice test's config; ``is_ocean`` accepted and unused,
    as in ``ace_tpu``), GraphCast without bias and layer norms, and
    LandNet with and without its positional embedding, built through both
    registries: within 1e-5."""
    net, jnet = _registry_nets(builder)
    params = _weights(net)
    x = _draw((2, NLAT, NLON, N_IN))
    _assert_tree_shapes(params, jnet, jnp.asarray(x))
    _close(net(torch.from_numpy(x)), jnet.apply(params, jnp.asarray(x)))


def test_landnet_positional_embedding_is_standard_normal():
    """``pos_embed`` ``[1, H, W, dim]`` is drawn standard normal from the
    generator (flax's ``normal(1.0)``)."""
    net, _ = _registry_nets({"type": "LandNet", "config": {
        "hidden_dims": [256], "use_positional_embedding": True}})
    init_weights(net, torch.Generator().manual_seed(0))
    pe = net.pos_embed.detach()
    assert pe.shape == (1, NLAT, NLON, 256)
    assert abs(float(pe.mean())) < 0.02
    assert float(pe.std()) == pytest.approx(1.0, abs=0.02)


def test_segment_sum_and_gather_equal_jax():
    """Values summed by receiver (receivers in any order, some segments
    empty) equal ``jax.ops.segment_sum``'s of each sample bit for bit
    (each node's edges added in their order), the same bits on a second
    run; the gather's gradient is ``jax.vjp``'s of ``jnp.take``."""
    rng = np.random.default_rng(4)
    values = _draw((3, 5000, 6))
    receivers = rng.integers(0, 400, 5000)
    receivers[receivers == 7] = 8
    ref = jax.vmap(lambda e: jax.ops.segment_sum(
        e, jnp.asarray(receivers), num_segments=401))(jnp.asarray(values))
    module = torch.nn.Module()
    seg = gc.Segments(module, "receivers", receivers, 401)
    index, order, lengths = seg.tensors(module)
    got = gc.segment_sum(torch.from_numpy(values), order, lengths)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(gc.segment_sum(torch.from_numpy(values), order,
                                      lengths), got)
    assert not got[:, 7].any() and not got[:, 400].any()
    x = torch.from_numpy(_draw((3, 401, 6), 1)).requires_grad_()
    cot = _draw((3, 5000, 6), 2)
    out = gc.gather(x, index, order, lengths)
    out.backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda v: jnp.take(v, jnp.asarray(receivers), axis=1),
                     jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(out.detach().numpy(), np.take(
        x.detach().numpy(), receivers, axis=1))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-5)
