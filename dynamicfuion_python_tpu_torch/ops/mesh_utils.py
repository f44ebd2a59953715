"""Mesh and topology utilities (port of
``dynamicfuion_python_tpu/ops/mesh_utils.py``): joining triangle meshes,
mesh -> adjacency lists -> edges -> adjacency matrix, greedy radius-search
averaging, and the regular image-grid graph over valid pixels.

Host-side graph bookkeeping, as in the JAX package: numpy (and scipy's
KD-tree) in and out, on any machine, with no device involved.
"""

from __future__ import annotations

import numpy as np


def join_triangle_meshes(meshes: list[tuple[np.ndarray, np.ndarray]]):
    """Concatenate (vertices, triangles) pairs with index offsetting."""
    verts, tris, offset = [], [], 0
    for v, t in meshes:
        verts.append(np.asarray(v))
        tris.append(np.asarray(t) + offset)
        offset += len(v)
    return np.concatenate(verts), np.concatenate(tris)


def mesh_to_adjacency_array(
    triangles: np.ndarray, vertex_count: int, max_degree: int
) -> np.ndarray:
    """Triangles -> -1-padded per-vertex neighbor lists (sorted ascending),
    the reference's mesh->adjacency conversion."""
    neighbor_sets = [set() for _ in range(vertex_count)]
    for a, b, c in np.asarray(triangles):
        neighbor_sets[a].update((b, c))
        neighbor_sets[b].update((a, c))
        neighbor_sets[c].update((a, b))
    out = np.full((vertex_count, max_degree), -1, np.int32)
    for i, nbrs in enumerate(neighbor_sets):
        lst = sorted(nbrs)[:max_degree]
        out[i, : len(lst)] = lst
    return out


def adjacency_array_to_edges(adjacency: np.ndarray) -> np.ndarray:
    """-1-padded adjacency lists -> unique undirected edge pairs [E, 2]
    with source < target (``AdjacencyArrayToEdges``)."""
    src = np.repeat(np.arange(len(adjacency)), adjacency.shape[1])
    dst = adjacency.reshape(-1)
    ok = dst >= 0
    pairs = np.stack([src[ok], dst[ok]], 1)
    pairs = np.sort(pairs, axis=1)
    return np.unique(pairs, axis=0).astype(np.int32)


def edges_to_adjacency_matrix(edges: np.ndarray, node_count: int) -> np.ndarray:
    """Edge endpoint array -> dense symmetric 0/1 adjacency matrix
    (``geometry/conversions.py:19``)."""
    mat = np.zeros((node_count, node_count), np.int32)
    edges = np.asarray(edges).reshape(-1, 2)
    edges = edges[(edges >= 0).all(axis=1)]
    mat[edges[:, 0], edges[:, 1]] = 1
    mat[edges[:, 1], edges[:, 0]] = 1
    return mat


def radius_search_averaging(
    points: np.ndarray, radius: float
) -> np.ndarray:
    """Greedy radius-search downsampling: repeatedly take the first
    unconsumed point, average it with all unconsumed points within
    ``radius``, consume them (``warp_field/radius_search_averaging.py:5-38``
    semantics)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    tree = cKDTree(pts)
    consumed = np.zeros(len(pts), bool)
    out = []
    for i in range(len(pts)):
        if consumed[i]:
            continue
        nbrs = [j for j in tree.query_ball_point(pts[i], radius) if not consumed[j]]
        out.append(pts[nbrs].mean(axis=0))
        consumed[nbrs] = True
    return np.asarray(out, np.float32)


def construct_regular_graph(
    point_image: np.ndarray,
    x_nodes: int,
    y_nodes: int,
    edge_threshold: float,
    max_point_to_node_distance: float,
    max_depth: float,
):
    """Regular-grid graph over a point image (``construct_regular_graph``):
    nodes on an x_nodes x y_nodes pixel lattice (valid depth only), 8-ish
    neighbor edges filtered by 3D length, plus per-pixel anchors to the 4
    enclosing lattice nodes.

    Returns (node_positions f32[N,3], edges int32[N,8], pixel_anchors
    int32[H,W,4], pixel_weights f32[H,W,4]).
    """
    h, w = point_image.shape[:2]
    ys = np.linspace(0, h - 1, y_nodes).astype(int)
    xs = np.linspace(0, w - 1, x_nodes).astype(int)
    lattice = -np.ones((y_nodes, x_nodes), np.int64)
    nodes = []
    for iy, y in enumerate(ys):
        for ix, x in enumerate(xs):
            p = point_image[y, x]
            if 0 < p[2] <= max_depth:
                lattice[iy, ix] = len(nodes)
                nodes.append(p)
    nodes = np.asarray(nodes, np.float32).reshape(-1, 3)

    edges = np.full((len(nodes), 8), -1, np.int32)
    for iy in range(y_nodes):
        for ix in range(x_nodes):
            ni = lattice[iy, ix]
            if ni < 0:
                continue
            slot = 0
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)):
                jy, jx = iy + dy, ix + dx
                if 0 <= jy < y_nodes and 0 <= jx < x_nodes and lattice[jy, jx] >= 0:
                    nj = lattice[jy, jx]
                    if np.linalg.norm(nodes[ni] - nodes[nj]) <= edge_threshold:
                        edges[ni, slot] = nj
                        slot += 1

    anchors = np.full((h, w, 4), -1, np.int32)
    weights = np.zeros((h, w, 4), np.float32)
    cell_h = (h - 1) / (y_nodes - 1)
    cell_w = (w - 1) / (x_nodes - 1)
    vg, ug = np.mgrid[0:h, 0:w]
    fy = vg / cell_h
    fx = ug / cell_w
    iy0 = np.clip(fy.astype(int), 0, y_nodes - 2)
    ix0 = np.clip(fx.astype(int), 0, x_nodes - 2)
    ty = fy - iy0
    tx = fx - ix0
    corner_nodes = np.stack(
        [
            lattice[iy0, ix0],
            lattice[iy0, ix0 + 1],
            lattice[iy0 + 1, ix0],
            lattice[iy0 + 1, ix0 + 1],
        ],
        -1,
    )
    corner_w = np.stack(
        [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], -1
    ).astype(np.float32)
    valid_px = (point_image[..., 2] > 0) & (point_image[..., 2] <= max_depth)
    near = np.ones((h, w), bool)
    if len(nodes):
        d = np.linalg.norm(
            point_image[..., None, :] - nodes[np.maximum(corner_nodes, 0)], axis=-1
        )
        keep = (corner_nodes >= 0) & (d <= max_point_to_node_distance)
        cw = np.where(keep, corner_w, 0.0)
        sums = cw.sum(-1, keepdims=True)
        cw = np.where(sums > 0, cw / np.maximum(sums, 1e-30), 0.0)
        anchors = np.where(keep & valid_px[..., None], corner_nodes, -1).astype(
            np.int32
        )
        weights = np.where(valid_px[..., None], cw, 0.0).astype(np.float32)
    return nodes, edges, anchors, weights
