"""GraphCast-style grid -> mesh -> grid GNN, the FloeNet backbone (port of
ace_tpu/models/graphcast.py).

The graphs are built once on the host in numpy: the icosphere hierarchy,
the multimesh, the grid-to-mesh radius query and the mesh-to-grid
containing triangles, with the JAX package's expressions, so the node
and edge enumerations and the features equal its arrays. Its two
queries compare every grid point with every mesh node or face (87
minutes for the containing triangles of a 1° grid against the 81,920
faces of ``meshes: 6``); the port's (``radius_query``,
``containing_triangle``) first take candidates from a k-d tree with a
provable slack, then evaluate the JAX package's float64 formulas on the
candidates only, and return the same arrays in the same order. The
brute-force copies (``radius_query_brute``; ``containing_triangle_brute``
in torch, float64, one exactly rounded op at a time, so that it runs on
the card too) stay beside them for the tests and ``chip_smoke.py``.

Message passing runs as gather -> MLP -> segment sum. Each edge index is
kept with its stable sort and its nodes' counts (built once with the
graphs), and the segment sum (``segment_sum``) reduces the sorted edges
with ``torch.segment_reduce``, whose every output element is one loop
over its segment: no atomics, so two runs give the same bits on the card
(``index_add_`` adds with atomics there) and each node's edges are added
in their order, as the JAX package's scatter-add does on the CPU. The
gathers' gradients go through the same sum (``gather``). The graph
arrays are non-persistent buffers, out of the ``state_dict`` as they are
out of the JAX package's parameters.
"""

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ace_tpu_torch.models.layers import LayerNorm, Linear


# ---------- icosphere hierarchy (copies of the JAX package's) ----------


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] unit vectors
    faces: np.ndarray  # [F, 3] int


def _icosahedron() -> TriMesh:
    """Regular icosahedron with DeepMind GraphCast's vertex ordering,
    normalization and orientation, in float32."""
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    verts = []
    for c1 in (1.0, -1.0):
        for c2 in (phi, -phi):
            verts.append((c1, c2, 0.0))
            verts.append((0.0, c1, c2))
            verts.append((c2, 0.0, c1))
    vertices = np.asarray(verts, dtype=np.float32)
    vertices /= np.linalg.norm([1.0, phi])
    faces = np.array([
        (0, 1, 2), (0, 6, 1), (8, 0, 2), (8, 4, 0), (3, 8, 2),
        (3, 2, 7), (7, 2, 1), (0, 4, 6), (4, 11, 6), (6, 11, 5),
        (1, 5, 7), (4, 10, 11), (4, 8, 10), (10, 8, 3), (10, 3, 9),
        (11, 10, 9), (11, 9, 5), (5, 9, 7), (9, 3, 7), (1, 6, 5),
    ], dtype=np.int64)
    angle_between_faces = 2.0 * np.arcsin(phi / np.sqrt(3.0))
    theta = (np.pi - angle_between_faces) / 2.0
    rot_y = np.array([
        [np.cos(theta), 0.0, np.sin(theta)],
        [0.0, 1.0, 0.0],
        [-np.sin(theta), 0.0, np.cos(theta)],
    ])
    vertices = (vertices @ rot_y).astype(np.float32)
    return TriMesh(vertices, faces)


def _subdivide(mesh: TriMesh) -> TriMesh:
    """Split each triangle into 4; parent vertices keep their indices."""
    verts = list(mesh.vertices)
    midpoint: dict[tuple[int, int], int] = {}

    def mid(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in midpoint:
            v = (mesh.vertices[a] + mesh.vertices[b]) / 2.0
            v = v / np.linalg.norm(v)
            midpoint[key] = len(verts)
            verts.append(v.astype(np.float32))
        return midpoint[key]

    faces = []
    for a, b, c in mesh.faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return TriMesh(np.asarray(verts), np.asarray(faces, np.int64))


def get_mesh_hierarchy(splits: int) -> list[TriMesh]:
    meshes = [_icosahedron()]
    for _ in range(splits):
        meshes.append(_subdivide(meshes[-1]))
    return meshes


def merge_meshes(meshes: Sequence[TriMesh]) -> TriMesh:
    """Multimesh: the finest vertices, the union of all levels' faces."""
    for m in meshes[:-1]:
        assert np.allclose(m.vertices, meshes[-1].vertices[: len(m.vertices)])
    faces = np.concatenate([m.faces for m in meshes], axis=0)
    return TriMesh(meshes[-1].vertices, faces)


def faces_to_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Directed edges of a triangulation, one per face side."""
    senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    return senders, receivers


def max_edge_distance(mesh: TriMesh) -> float:
    s, r = faces_to_edges(mesh.faces)
    return float(
        np.linalg.norm(mesh.vertices[s] - mesh.vertices[r], axis=1).max()
    )


# ---------- geometry ----------


def latlon_to_xyz(lat_deg, lon_deg):
    """Colatitude form (bit-identical to the JAX package's)."""
    phi = np.deg2rad(lon_deg)
    theta = np.deg2rad(90.0 - lat_deg)
    return np.stack([
        np.cos(phi) * np.sin(theta),
        np.sin(phi) * np.sin(theta),
        np.cos(theta),
    ], axis=-1)


def xyz_to_latlon(xyz):
    lat = np.rad2deg(np.arcsin(np.clip(xyz[..., 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(xyz[..., 1], xyz[..., 0])) % 360.0
    return lat, lon


# the mesh-node chunk of the JAX package's radius query: its pairs come
# ordered by (mesh chunk, grid index, mesh index)
RADIUS_CHUNK = 4096


def radius_query_brute(grid_xyz: np.ndarray, mesh_xyz: np.ndarray,
                       radius: float, chunk: int = RADIUS_CHUNK):
    """(grid_idx, mesh_idx) pairs with chordal distance <= radius: every
    grid point against every mesh node (a copy of the JAX package's
    ``radius_query``)."""
    grid_idx, mesh_idx = [], []
    for start in range(0, len(mesh_xyz), chunk):
        block = mesh_xyz[start : start + chunk]
        d2 = (
            np.sum(grid_xyz**2, axis=1)[:, None]
            - 2.0 * grid_xyz @ block.T
            + np.sum(block**2, axis=1)[None, :]
        )
        g, m = np.nonzero(d2 <= radius**2)
        grid_idx.append(g)
        mesh_idx.append(m + start)
    return np.concatenate(grid_idx), np.concatenate(mesh_idx)


# pairs whose squared distance lies this close to the radius's square are
# decided by the brute-force expression itself (its matrix product may
# round a dot product differently from the candidates' elementwise one)
_RADIUS_BAND = 1e-12


def radius_query(grid_xyz: np.ndarray, mesh_xyz: np.ndarray, radius: float,
                 chunk: int = RADIUS_CHUNK):
    """``radius_query_brute``'s pairs, in its order, from a k-d tree's
    candidates. The tree takes every pair within ``radius + 1e-9`` (the
    float64 expression ``|g|^2 - 2 g.m + |m|^2`` is within 1e-15 of the
    true squared distance of unit vectors), the candidates are held to
    the brute force's threshold ``d2 <= radius**2`` on the same
    expression, and the grid points of pairs within ``_RADIUS_BAND`` of
    it take all their pairs from ``radius_query_brute``."""
    from scipy.spatial import cKDTree

    grid_xyz = np.asarray(grid_xyz)
    mesh64 = np.asarray(mesh_xyz, np.float64)
    pairs = cKDTree(grid_xyz).sparse_distance_matrix(
        cKDTree(mesh64), radius + 1e-9, output_type="ndarray")
    g = pairs["i"].astype(np.int64)
    m = pairs["j"].astype(np.int64)
    sg = np.sum(grid_xyz**2, axis=1)
    sm = np.sum(np.asarray(mesh_xyz)**2, axis=1)
    dot = ((grid_xyz[g, 0] * mesh64[m, 0] + grid_xyz[g, 1] * mesh64[m, 1])
           + grid_xyz[g, 2] * mesh64[m, 2])
    d2 = sg[g] - 2.0 * dot + sm[m]
    r2 = radius**2
    keep = d2 <= r2
    near = np.abs(d2 - r2) <= _RADIUS_BAND
    if near.any():
        # the grid points of a near pair: all their pairs from the brute force
        rows = np.unique(g[near])
        redo = np.isin(g, rows)
        bg, bm = radius_query_brute(grid_xyz[rows], mesh_xyz, radius, chunk)
        g = np.concatenate([g[keep & ~redo], rows[bg]])
        m = np.concatenate([m[keep & ~redo], bm])
    else:
        g, m = g[keep], m[keep]
    order = np.lexsort((m, g, m // chunk))
    return g[order], m[order]


def _closest_distance(p, a, b, c):
    """The JAX package's per-region point-triangle distance (Ericson, RTC
    5.1.5) in float64: ``p`` ``[G, 1, 3]`` against triangles ``a, b, c``
    broadcasting to ``[G, F, 3]``; returns ``[G, F]``."""
    ab, ac, bc = b - a, c - a, c - b

    def dot(u, v):
        return np.einsum("gfc,gfc->gf", u, v)

    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = dot(ab, ap), dot(ac, ap)
    d3, d4 = dot(ab, bp), dot(ac, bp)
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ab = np.nan_to_num(d1 / (d1 - d3))
        t_ac = np.nan_to_num(d2 / (d2 - d6))
        t_bc = np.nan_to_num((d4 - d3) / ((d4 - d3) + (d5 - d6)))
        denom = va + vb + vc
        v_in = np.nan_to_num(vb / denom)
        w_in = np.nan_to_num(vc / denom)
    conds = [
        (d1 <= 0) & (d2 <= 0),
        (d3 >= 0) & (d4 <= d3),
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),
        (d6 >= 0) & (d5 <= d6),
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),
        (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
    ]
    cands = [
        a,
        b,
        a + t_ab[..., None] * ab,
        c,
        a + t_ac[..., None] * ac,
        b + t_bc[..., None] * bc,
    ]
    closest = a + v_in[..., None] * ab + w_in[..., None] * ac
    for cond, cand in zip(reversed(conds), reversed(cands)):
        closest = np.where(cond[..., None], cand, closest)
    return np.linalg.norm(closest - p, axis=-1)


def containing_triangle(grid_xyz: np.ndarray, mesh: TriMesh,
                        chunk: int = 8192) -> np.ndarray:
    """The face index of the mesh triangle closest to each grid point,
    ties to the lowest face index: the JAX package's
    ``containing_triangle`` from candidate faces only.

    A unit vector's central projection meets one face (the mesh is a
    closed convex polyhedron around the origin), at a distance of at most
    ``1 - h`` for the face's plane at distance ``h`` from the origin; so
    the closest face is at most ``max(1 - h)`` away. A face whose centroid
    lies farther than that plus its farthest vertex from the centroid
    cannot be the closest. The candidates (all faces within that reach of
    the point, from a k-d tree over the centroids, plus 1e-9) go through
    the JAX package's float64 distance, sorted by face index so that the
    argmin's ties go to the lowest index, as there."""
    from scipy.spatial import cKDTree

    tri = mesh.vertices.astype(np.float64)[mesh.faces]  # [F, 3, 3]
    centroid = tri.mean(axis=1)
    reach_vertex = np.linalg.norm(tri - centroid[:, None], axis=-1).max()
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    plane = np.abs(np.einsum("fc,fc->f", normal, tri[:, 0]))
    reach = reach_vertex + float((1.0 - plane).max()) + 1e-9
    lists = cKDTree(centroid).query_ball_point(grid_xyz, reach)
    counts = np.array([len(c) for c in lists])
    if counts.min() == 0:
        raise AssertionError("containing_triangle: a point has no candidate")
    k = int(counts.max())
    # each point's candidates ascending, padded with its lowest (a
    # repeat changes neither the minimum nor the first index reaching it)
    cand = np.empty((len(grid_xyz), k), np.int64)
    for i, c in enumerate(lists):
        c = sorted(c)
        cand[i, :len(c)] = c
        cand[i, len(c):] = c[0]
    out = np.zeros(len(grid_xyz), np.int64)
    for start in range(0, len(grid_xyz), chunk):
        idx = cand[start:start + chunk]
        t = tri[idx]  # [G, K, 3, 3]
        p = grid_xyz[start:start + chunk][:, None, :]
        d = _closest_distance(p, t[:, :, 0], t[:, :, 1], t[:, :, 2])
        out[start:start + chunk] = idx[np.arange(len(idx)), np.argmin(d, 1)]
    return out


# the orders in which a sum of three float64 terms can be taken
_SUM3_ORDERS = {"(0+1)+2": ((0, 1), 2), "(0+2)+1": ((0, 2), 1),
                "(1+2)+0": ((1, 2), 0)}


def _sum3(w, order):
    (i, j), k = _SUM3_ORDERS[order]
    return (w[..., i] + w[..., j]) + w[..., k]


def numpy_sum3_orders() -> tuple[str, str]:
    """The orders in which this machine's numpy sums three terms in the
    distance's two reductions: ``einsum("gfc,gfc->gf")`` (its SIMD loop
    pairs the first and third terms where vectors hold two doubles) and
    ``np.linalg.norm(axis=-1)``, found on random data. The torch copy
    sums in the same orders, so it rounds as numpy does."""
    x, y = np.random.default_rng(0).standard_normal((2, 64, 5, 3))
    probes = ((np.einsum("gfc,gfc->gf", x, y), x * y, lambda v: v),
              (np.linalg.norm(x, axis=-1), x * x, np.sqrt))
    found = []
    for got, terms, finish in probes:
        match = [o for o in _SUM3_ORDERS
                 if np.array_equal(got, finish(_sum3(terms, o)))]
        if not match:
            raise AssertionError("numpy sums three terms in an order this "
                                 "copy does not know")
        found.append(match[0])
    return found[0], found[1]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded square root, as numpy's: CUDA's float64 ``sqrt``
    is one, torch's vectorized CPU one is not (it differs in the last
    bit), so on the CPU numpy takes it."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def containing_triangle_brute(grid_xyz, mesh: TriMesh, device="cpu",
                              chunk: int = 256) -> np.ndarray:
    """The JAX package's brute-force ``containing_triangle`` (every grid
    point against every face) in torch, float64, on ``device``: each
    elementwise op rounds once, as numpy's, and the dot products and norms
    sum their three terms in numpy's orders (``numpy_sum3_orders``), so it
    returns the JAX package's indices, near-ties included; on the card it
    takes seconds where numpy takes an hour."""
    dot_order, norm_order = numpy_sum3_orders()
    tri = torch.as_tensor(mesh.vertices.astype(np.float64)[mesh.faces],
                          device=device)
    a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
    ab, ac, bc = b - a, c - a, c - b

    def dot(u, v):
        return _sum3(u * v, dot_order)

    def nan_to_num(x):
        return torch.nan_to_num(x)

    grid = torch.as_tensor(np.asarray(grid_xyz, np.float64), device=device)
    out = []
    for start in range(0, len(grid), chunk):
        p = grid[start:start + chunk][:, None, :]
        ap, bp, cp = p - a, p - b, p - c
        d1, d2 = dot(ab, ap), dot(ac, ap)
        d3, d4 = dot(ab, bp), dot(ac, bp)
        d5, d6 = dot(ab, cp), dot(ac, cp)
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        t_ab = nan_to_num(d1 / (d1 - d3))
        t_ac = nan_to_num(d2 / (d2 - d6))
        t_bc = nan_to_num((d4 - d3) / ((d4 - d3) + (d5 - d6)))
        denom = va + vb + vc
        v_in = nan_to_num(vb / denom)
        w_in = nan_to_num(vc / denom)
        conds = [
            (d1 <= 0) & (d2 <= 0),
            (d3 >= 0) & (d4 <= d3),
            (vc <= 0) & (d1 >= 0) & (d3 <= 0),
            (d6 >= 0) & (d5 <= d6),
            (vb <= 0) & (d2 >= 0) & (d6 <= 0),
            (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
        ]
        cands = [
            lambda: a,
            lambda: b,
            lambda: a + t_ab[..., None] * ab,
            lambda: c,
            lambda: a + t_ac[..., None] * ac,
            lambda: b + t_bc[..., None] * bc,
        ]
        closest = (a + v_in[..., None] * ab) + w_in[..., None] * ac
        for cond, cand in zip(reversed(conds), reversed(cands)):
            closest = torch.where(cond[..., None], cand(), closest)
        diff = closest - p
        d = _sqrt(_sum3(diff * diff, norm_order))
        out.append(torch.argmin(d, dim=1).cpu())
        del ap, bp, cp, closest, diff, d
    return torch.cat(out).numpy().astype(np.int64)


def _receiver_local_relative_positions(xyz, lat_deg, lon_deg, senders,
                                       receivers):
    """Sender positions in each receiver's local frame (receiver rotated
    to lat=0, lon=0), minus the receiver position."""
    phi = np.deg2rad(lon_deg)[receivers]
    theta = np.deg2rad(90.0 - lat_deg)[receivers]
    rel = xyz[senders]
    cosp, sinp = np.cos(-phi), np.sin(-phi)
    x = rel[:, 0] * cosp - rel[:, 1] * sinp
    y = rel[:, 0] * sinp + rel[:, 1] * cosp
    z = rel[:, 2]
    alpha = np.pi / 2.0 - theta
    cosa, sina = np.cos(alpha), np.sin(alpha)
    x2 = x * cosa + z * sina
    z2 = -x * sina + z * cosa
    rotated = np.stack([x2, y, z2], axis=-1)
    return rotated - np.array([1.0, 0.0, 0.0])


def node_features(lat_deg, lon_deg) -> np.ndarray:
    """[cos(theta), cos(phi), sin(phi)]."""
    phi = np.deg2rad(lon_deg)
    theta = np.deg2rad(90.0 - lat_deg)
    return np.stack(
        [np.cos(theta), np.cos(phi), np.sin(phi)], axis=-1
    ).astype(np.float32)


def edge_features(xyz, lat_deg, lon_deg, senders, receivers) -> np.ndarray:
    """[norm, dx, dy, dz] normalized by the largest norm."""
    rel = _receiver_local_relative_positions(
        xyz, lat_deg, lon_deg, senders, receivers
    )
    norm = np.linalg.norm(rel, axis=-1, keepdims=True)
    scale = max(float(norm.max()), 1e-12)
    return np.concatenate([norm / scale, rel / scale], axis=-1).astype(
        np.float32
    )


@dataclasses.dataclass
class GraphCastGraphs:
    """All static graph arrays, built on the host."""

    n_grid: int
    n_mesh: int
    grid_node_feats: np.ndarray
    mesh_node_feats: np.ndarray
    g2m_senders: np.ndarray
    g2m_receivers: np.ndarray
    g2m_edge_feats: np.ndarray
    m2m_senders: np.ndarray
    m2m_receivers: np.ndarray
    m2m_edge_feats: np.ndarray
    m2g_senders: np.ndarray
    m2g_receivers: np.ndarray
    m2g_edge_feats: np.ndarray


def build_graphs(lat2d: np.ndarray, lon2d: np.ndarray, meshes: int = 6,
                 M0: int = 4, radius_fraction: float = 1.0,
                 mask: np.ndarray | None = None) -> GraphCastGraphs:
    """The JAX package's ``build_graphs`` with the fast queries: ``mask``
    selects the active grid points; mesh nodes keep full coverage."""
    hierarchy = get_mesh_hierarchy(meshes)[min(M0, meshes):]
    fine = hierarchy[-1]
    if mask is None:
        mask = np.ones(lat2d.shape, bool)
    grid_lat = lat2d[mask].ravel()
    grid_lon = lon2d[mask].ravel()
    grid_xyz = latlon_to_xyz(grid_lat, grid_lon)
    mesh_lat, mesh_lon = xyz_to_latlon(fine.vertices)

    radius = max_edge_distance(fine) * radius_fraction
    g2m_s, g2m_r = radius_query(grid_xyz, fine.vertices, radius)

    merged = merge_meshes(hierarchy)
    m2m_s, m2m_r = faces_to_edges(merged.faces)

    tri = containing_triangle(grid_xyz, fine)
    m2g_s = fine.faces[tri].ravel()
    m2g_r = np.repeat(np.arange(len(grid_xyz)), 3)

    return GraphCastGraphs(
        n_grid=len(grid_xyz),
        n_mesh=len(fine.vertices),
        grid_node_feats=node_features(grid_lat, grid_lon),
        mesh_node_feats=node_features(mesh_lat, mesh_lon),
        g2m_senders=g2m_s,
        g2m_receivers=g2m_r,
        g2m_edge_feats=_bipartite_edge_feats(
            grid_xyz, grid_lat, grid_lon, fine.vertices, mesh_lat,
            mesh_lon, g2m_s, g2m_r,
        ),
        m2m_senders=m2m_s,
        m2m_receivers=m2m_r,
        m2m_edge_feats=edge_features(
            fine.vertices, mesh_lat, mesh_lon, m2m_s, m2m_r
        ),
        m2g_senders=m2g_s,
        m2g_receivers=m2g_r,
        m2g_edge_feats=_bipartite_edge_feats(
            fine.vertices, mesh_lat, mesh_lon, grid_xyz, grid_lat,
            grid_lon, m2g_s, m2g_r,
        ),
    )


def _bipartite_edge_feats(s_xyz, s_lat, s_lon, r_xyz, r_lat, r_lon,
                          senders, receivers):
    xyz = np.concatenate([s_xyz, r_xyz], axis=0)
    lat = np.concatenate([s_lat, r_lat], axis=0)
    lon = np.concatenate([s_lon, r_lon], axis=0)
    return edge_features(
        xyz, lat, lon, senders, receivers + len(s_xyz)
    )


# ---------- message passing ----------


class Segments:
    """An edge array's index (senders or receivers) as segments: the
    stable sort of the edges by index and each node's count, as
    non-persistent buffers of ``module`` named ``{name}_order`` and
    ``{name}_lengths`` beside ``{name}`` itself."""

    def __init__(self, module: nn.Module, name: str, index: np.ndarray,
                 n_nodes: int, device=None):
        self.name = name
        self.n_nodes = n_nodes
        module.register_buffer(name, torch.as_tensor(index, device=device),
                               persistent=False)
        module.register_buffer(
            f"{name}_order", torch.as_tensor(
                np.argsort(index, kind="stable"), device=device),
            persistent=False)
        module.register_buffer(
            f"{name}_lengths", torch.as_tensor(
                np.bincount(index, minlength=n_nodes), device=device),
            persistent=False)

    def tensors(self, module):
        return (getattr(module, self.name),
                getattr(module, f"{self.name}_order"),
                getattr(module, f"{self.name}_lengths"))


def segment_sum(values: torch.Tensor, order: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """``values`` ``[B, E, C]`` summed by segment into ``[B, n, C]``: the
    edges taken in ``order`` (sorted by index, stably), then
    ``torch.segment_reduce``, which adds each segment's values in turn
    (each output element one thread's loop: no atomics). So the sum has
    the same bits every run, on the card and on the CPU, and adds each
    node's edges in their order, as ``jax.ops.segment_sum`` does on the
    CPU."""
    sorted_values = values.transpose(0, 1)[order]
    # ``unsafe``: no check of the lengths on the host (two reads that wait
    # for the device); they are the index's counts by construction
    return torch.segment_reduce(sorted_values, "sum", lengths=lengths,
                                axis=0, unsafe=True).transpose(0, 1)


class _Gather(torch.autograd.Function):
    """``x[:, index]`` whose gradient is summed by ``segment_sum`` (the
    library's gather gradient adds with atomics on the CPU)."""

    @staticmethod
    def forward(ctx, x, index, order, lengths):
        ctx.save_for_backward(order, lengths)
        return x[:, index]

    @staticmethod
    def backward(ctx, grad):
        order, lengths = ctx.saved_tensors
        return segment_sum(grad, order, lengths), None, None, None


def gather(x: torch.Tensor, index, order, lengths) -> torch.Tensor:
    """``x[:, index]`` for ``x`` ``[B, N, C]`` with a deterministic
    gradient (``index``'s segments: ``order``, ``lengths``)."""
    return _Gather.apply(x, index, order, lengths)


def _tanh_gelu(x):
    return F.gelu(x, approximate="tanh")


# flax.linen's activations by name (``nn.gelu`` is the tanh form)
ACTIVATIONS = {"silu": F.silu, "swish": F.silu, "relu": F.relu,
               "gelu": _tanh_gelu, "tanh": torch.tanh, "elu": F.elu,
               "sigmoid": torch.sigmoid, "softplus": F.softplus}


class GnnMLP(nn.Module):
    """Linear -> activation -> LayerNorm (flax's, eps 1e-6) -> Linear."""

    def __init__(self, n_in, hidden, out, use_layernorm=True, use_bias=True,
                 activation="silu", device=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        self.fc0 = Linear(n_in, hidden, bias=use_bias, device=device,
                          init="lecun_normal")
        self.norm = LayerNorm(hidden, device=device) if use_layernorm \
            else None
        self.fc1 = Linear(hidden, out, bias=use_bias, device=device,
                          init="lecun_normal")

    def forward(self, x):
        h = self.act(self.fc0(x))
        if self.norm is not None:
            h = self.norm(h)
        return self.fc1(h)


class GraphCast(nn.Module):
    """GraphCast encoder-processor-decoder (port of
    ace_tpu/models/graphcast.py:395). ``forward(x, noise=None,
    generator=None, deterministic=True)`` maps ``[B, H, W, in_chans]`` to
    ``[B, H, W, out_chans]``; with ``mask`` (bool ``[H, W]``) only the
    active grid points are nodes and the others come out zero."""

    def __init__(self, img_shape, in_chans, out_chans, lat2d, lon2d,
                 latent_dimension=256, activation="silu", meshes=6, M0=4,
                 use_bias=True, radius_fraction=1.0, layernorm=True,
                 processor_steps=4, residual=True, mask=None, device=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.out_chans = out_chans
        self.residual = residual
        self.processor_steps = processor_steps
        g = build_graphs(np.asarray(lat2d), np.asarray(lon2d), meshes=meshes,
                         M0=M0, radius_fraction=radius_fraction,
                         mask=None if mask is None else np.asarray(mask))
        self.graphs = g
        self.n_grid, self.n_mesh = g.n_grid, g.n_mesh
        for name in ("grid_node_feats", "mesh_node_feats", "g2m_edge_feats",
                     "m2m_edge_feats", "m2g_edge_feats"):
            self.register_buffer(name, torch.as_tensor(getattr(g, name),
                                                       device=device),
                                 persistent=False)
        # each edge index with its segments, for the gathers' gradients
        # (senders) and the sums (receivers)
        self.segments = {
            name: Segments(self, name, getattr(g, name), n, device)
            for name, n in (("g2m_senders", g.n_grid),
                            ("g2m_receivers", g.n_mesh),
                            ("m2m_senders", g.n_mesh),
                            ("m2m_receivers", g.n_mesh),
                            ("m2g_senders", g.n_mesh),
                            ("m2g_receivers", g.n_grid))}
        flat_idx = (None if mask is None
                    else np.nonzero(np.asarray(mask).ravel())[0])
        self.register_buffer(
            "flat_idx", None if flat_idx is None else torch.as_tensor(
                flat_idx, device=device), persistent=False)
        latent = latent_dimension

        def mlp(n_in, out=latent, norm=layernorm):
            return GnnMLP(n_in, latent, out, use_layernorm=norm,
                          use_bias=use_bias, activation=activation,
                          device=device)

        self.grid_node_embed = mlp(in_chans + 3)
        self.mesh_node_embed = mlp(3)
        self.g2m_edge_embed = mlp(4)
        self.g2m_message = mlp(3 * latent)
        self.g2m_node_update = mlp(2 * latent)
        self.grid_update = mlp(latent)
        self.m2m_edge_embed = mlp(4)
        self.m2g_edge_embed = mlp(4)
        for i in range(processor_steps):
            self.add_module(f"m2m_message_{i}", mlp(3 * latent))
            self.add_module(f"m2m_node_update_{i}", mlp(2 * latent))
        self.m2g_message = mlp(3 * latent)
        self.grid_node_update = mlp(2 * latent)
        self.out_head = mlp(latent, out=out_chans, norm=False)

    def _add(self, x, update):
        return x + update if self.residual else update

    def _edge_pass(self, edges, graph, message, update, nodes_s, nodes_r):
        """One pass over ``graph``'s edges ("g2m", "m2m", "m2g"): each
        edge's message from (edge, sender, receiver), the edges updated,
        summed by receiver and the receivers updated."""
        senders = self.segments[f"{graph}_senders"].tensors(self)
        receivers = self.segments[f"{graph}_receivers"].tensors(self)
        msg = message(torch.cat([edges, gather(nodes_s, *senders),
                                 gather(nodes_r, *receivers)], dim=-1))
        edges = self._add(edges, msg)
        agg = segment_sum(edges, *receivers[1:])
        return edges, self._add(nodes_r, update(torch.cat([nodes_r, agg],
                                                          dim=-1)))

    def forward(self, x, noise=None, generator=None, deterministic=True):
        b, hh, ww, c = x.shape
        flat = x.reshape(b, hh * ww, c)
        if self.flat_idx is not None:
            flat = flat[:, self.flat_idx]

        def batched(t):
            return t.expand(b, *t.shape)

        # encoder (GraphCast SI Eqs 6-10)
        vg = self.grid_node_embed(torch.cat(
            [flat, batched(self.grid_node_feats)], dim=-1))
        vm = batched(self.mesh_node_embed(self.mesh_node_feats))
        e_g2m = batched(self.g2m_edge_embed(self.g2m_edge_feats))
        e_g2m, vm = self._edge_pass(e_g2m, "g2m", self.g2m_message,
                                    self.g2m_node_update, vg, vm)
        vg = self._add(vg, self.grid_update(vg))
        e_m2m = batched(self.m2m_edge_embed(self.m2m_edge_feats))
        e_m2g = batched(self.m2g_edge_embed(self.m2g_edge_feats))

        # processor (SI Eqs 11-13)
        for i in range(self.processor_steps):
            e_m2m, vm = self._edge_pass(
                e_m2m, "m2m", getattr(self, f"m2m_message_{i}"),
                getattr(self, f"m2m_node_update_{i}"), vm, vm)

        # decoder (SI Eqs 14-17)
        _, vg = self._edge_pass(e_m2g, "m2g", self.m2g_message,
                                self.grid_node_update, vm, vg)
        out = self.out_head(vg)
        if self.flat_idx is not None:
            full = out.new_zeros(b, hh * ww, self.out_chans)
            full[:, self.flat_idx] = out
            out = full
        return out.reshape(b, hh, ww, self.out_chans)
