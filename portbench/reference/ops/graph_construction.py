"""Deformation-graph construction from meshes (host-side numpy, runs once
per graph build). Port of ``dynamicfuion_python_tpu/ops/graph_construction.py``:

  - mesh from a depth image: each pixel square becomes up to two triangles
    whose edges are all shorter than a limit;
  - erosion: iteratively drop faces any of whose vertices touch fewer than
    ``min_neighbors`` surviving faces; the mask marks vertices of surviving
    faces;
  - node sampling: greedy Poisson-disk, accept a vertex as node iff no
    previously accepted node lies within ``node_coverage``;
  - geodesic node edges: per node, the first ``max_neighbor_count`` other
    nodes in ascending shortest-path distance over the mesh, Gaussian
    weights normalized per node, reach limited to 2 * node_coverage;
  - geodesic vertex anchors, node/edge cleanup and anchor renumbering;
  - Euclidean KNN node edges and shortest-path pixel anchors (scipy's
    KD-tree and Dijkstra, as in the JAX package).

Everything stays in numpy on the host, never on a device: graph data is then
the same on every machine, and no cell or grid index comes from a device's
floating-point division.
"""

from __future__ import annotations

import numpy as np


def mesh_from_depth_image(
    point_image: np.ndarray,
    max_triangle_edge_distance: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Point image f32[H, W, 3] (z == 0 invalid) -> grid-connected mesh.

    Each pixel square becomes up to two triangles (00-01-10 and 01-11-10
    pixel order) whose edges must all be at most
    ``max_triangle_edge_distance`` long; the winding makes normals face the
    camera. Returns (vertices f32[V, 3], vertex_pixels i32[V, 2] as
    (v_row, u_col), faces i32[F, 3]).
    """
    pts = np.asarray(point_image, np.float32)
    h, w = pts.shape[:2]
    valid = pts[..., 2] > 0

    p00, p01, p10, p11 = pts[:-1, :-1], pts[1:, :-1], pts[:-1, 1:], pts[1:, 1:]
    v00, v01, v10, v11 = valid[:-1, :-1], valid[1:, :-1], valid[:-1, 1:], valid[1:, 1:]

    def edge_ok(a, b):
        return np.linalg.norm(a - b, axis=-1) <= max_triangle_edge_distance

    tri_a = v00 & v01 & v10 & edge_ok(p00, p01) & edge_ok(p00, p10) & edge_ok(p01, p10)
    tri_b = v01 & v11 & v10 & edge_ok(p01, p11) & edge_ok(p01, p10) & edge_ok(p11, p10)

    used = np.zeros((h, w), bool)
    ya, xa = np.nonzero(tri_a)
    used[ya, xa] = used[ya + 1, xa] = used[ya, xa + 1] = True
    yb, xb = np.nonzero(tri_b)
    used[yb + 1, xb] = used[yb + 1, xb + 1] = used[yb, xb + 1] = True

    vert_index = np.full((h, w), -1, np.int64)
    vy, vx = np.nonzero(used)
    vert_index[vy, vx] = np.arange(len(vy))
    vertices = pts[vy, vx]
    vertex_pixels = np.stack([vy, vx], 1).astype(np.int32)
    faces_a = np.stack([vert_index[ya, xa], vert_index[ya + 1, xa], vert_index[ya, xa + 1]], 1)
    faces_b = np.stack([vert_index[yb + 1, xb], vert_index[yb + 1, xb + 1], vert_index[yb, xb + 1]], 1)
    faces = np.concatenate([faces_a, faces_b]).astype(np.int32)
    return vertices, vertex_pixels, faces


def vertex_erosion_mask(
    vertex_positions: np.ndarray,
    triangles: np.ndarray,
    iteration_count: int,
    min_neighbors: int,
) -> np.ndarray:
    """bool[V]: True for vertices surviving ``iteration_count`` erosions."""
    v = len(vertex_positions)
    faces = np.asarray(triangles, np.int64)
    for _ in range(iteration_count):
        counts = np.bincount(faces.reshape(-1), minlength=v)
        keep = (counts[faces] >= min_neighbors).all(axis=1)
        faces = faces[keep]
    mask = np.zeros(v, bool)
    if len(faces):
        mask[np.unique(faces)] = True
    return mask


def sample_nodes(
    vertex_positions: np.ndarray,
    vertex_mask: np.ndarray | None,
    node_coverage: float,
    use_only_non_eroded: bool = True,
    random_shuffle: bool = False,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy coverage sampling -> (node positions f32[N,3], vertex idx i32[N])."""
    pts = np.asarray(vertex_positions, np.float32)
    order = np.arange(len(pts))
    if random_shuffle:
        np.random.default_rng(seed).shuffle(order)
    cov_sq = node_coverage * node_coverage
    chosen: list[int] = []
    chosen_pts = np.empty((0, 3), np.float32)
    # grid hash for O(1) coverage queries
    cell = node_coverage
    grid: dict[tuple, list[int]] = {}
    for vi in order:
        if use_only_non_eroded and vertex_mask is not None and not vertex_mask[vi]:
            continue
        p = pts[vi]
        key = tuple((p // cell).astype(np.int64))
        covered = False
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for ci in grid.get((key[0] + dx, key[1] + dy, key[2] + dz), ()):
                        if ((p - pts[ci]) ** 2).sum() <= cov_sq:
                            covered = True
                            break
                    if covered:
                        break
                if covered:
                    break
            if covered:
                break
        if not covered:
            grid.setdefault(key, []).append(vi)
            chosen.append(vi)
    idx = np.asarray(chosen, np.int32)
    return pts[idx], idx


def compute_pixel_anchors_shortest_path(
    point_image: np.ndarray,  # f32[H, W, 3] camera-space points (z = 0 invalid)
    node_positions: np.ndarray,  # f32[N, 3]
    node_edges: np.ndarray,  # int32[N, Ke] (-1 pad) node adjacency
    anchor_count: int,
    node_coverage: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Shortest-path pixel anchors: each valid pixel seeds at its
    Euclidean-nearest node and ranks nodes by (distance to the seed) +
    (graph-geodesic distance seed -> node over the node adjacency). Weights
    exp(-d^2 / (2 sigma^2)), normalized (uniform over the kept anchors when
    they sum to 0); anchors beyond 2 * node_coverage are dropped (-1).
    Returns (anchors int32[H, W, K], weights f32[H, W, K])."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    from scipy.spatial import cKDTree

    nodes = np.asarray(node_positions, np.float32)
    n = len(nodes)
    edges = np.asarray(node_edges)
    src = np.repeat(np.arange(n), edges.shape[1])
    dst = edges.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    lengths = np.linalg.norm(nodes[src] - nodes[dst], axis=1)
    node_dist = dijkstra(csr_matrix((lengths, (src, dst)), shape=(n, n)), directed=False)  # inf: unreachable

    h, w = point_image.shape[:2]
    pts = np.asarray(point_image, np.float32).reshape(-1, 3)
    valid = pts[:, 2] > 0
    anchors = np.full((h * w, anchor_count), -1, np.int32)
    weights = np.zeros((h * w, anchor_count), np.float32)
    if valid.any() and n > 0:
        seed_d, seed = cKDTree(nodes).query(pts[valid], k=1)
        total = seed_d[:, None] + node_dist[seed]  # [P, N]
        k = min(anchor_count, n)
        order = np.argsort(total, axis=1, kind="stable")[:, :k]
        dist = np.take_along_axis(total, order, axis=1)
        keep = np.isfinite(dist) & (dist <= 2.0 * node_coverage)
        a = np.where(keep, order, -1).astype(np.int32)
        wts = np.where(keep, np.exp(-(dist**2) / (2.0 * node_coverage**2)), 0.0)
        sums = wts.sum(1, keepdims=True)
        counts = np.maximum((a >= 0).sum(1, keepdims=True), 1)
        wts = np.where(sums > 0, wts / np.maximum(sums, 1e-30), np.where(a >= 0, 1.0 / counts, 0.0))
        anchors[valid, :k] = a
        weights[valid, :k] = wts.astype(np.float32)
    return anchors.reshape(h, w, anchor_count), weights.reshape(h, w, anchor_count)


def compute_edges_euclidean(
    node_positions: np.ndarray, max_neighbor_count: int, node_coverage: float
) -> tuple[np.ndarray, np.ndarray]:
    """Euclidean KNN node edges int32[N, K] (-1 pad when there are fewer
    other nodes) and their normalized Gaussian weights f32[N, K]."""
    from scipy.spatial import cKDTree

    pts = np.asarray(node_positions, np.float32)
    k = min(max_neighbor_count + 1, len(pts))
    dist, idx = cKDTree(pts).query(pts, k=k)
    dist, idx = dist[:, 1:], idx[:, 1:]  # drop each node itself
    edges = idx.astype(np.int32)
    w = np.exp(-(dist**2) / (2.0 * node_coverage**2)).astype(np.float32)
    w /= np.maximum(w.sum(1, keepdims=True), 1e-30)
    if edges.shape[1] < max_neighbor_count:
        pad = max_neighbor_count - edges.shape[1]
        edges = np.pad(edges, ((0, 0), (0, pad)), constant_values=-1)
        w = np.pad(w, ((0, 0), (0, pad)))
    return edges, w


def _vertex_adjacency(vertex_count: int, triangles: np.ndarray):
    """CSR adjacency of the mesh's vertices: (row starts i64[V + 1],
    neighbors i64[2 * edges]), each row's neighbors in ascending order."""
    faces = np.asarray(triangles, np.int64)
    src = np.concatenate([faces[:, 0], faces[:, 0], faces[:, 1], faces[:, 1], faces[:, 2], faces[:, 2]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0], faces[:, 2], faces[:, 0], faces[:, 1]])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    counts = np.bincount(pairs[:, 0], minlength=vertex_count)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return starts, pairs[:, 1]


def _edge_lengths(pts: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """f64 length of each directed mesh edge, computed once per undirected
    edge as ``np.linalg.norm`` computes the length of one f32 vector,
    ``sqrt(x.dot(x))``: the arithmetic of a vertex-by-vertex Dijkstra, bit
    for bit (a vectorized norm sums the squares in another order and
    differs in a few percent of the edges)."""
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keys = lo * len(pts) + hi
    unique, inverse = np.unique(keys, return_inverse=True)
    diffs = pts[unique // len(pts)] - pts[unique % len(pts)]
    squared = np.fromiter((x.dot(x) for x in diffs), np.float32, count=len(unique))
    return np.sqrt(squared).astype(np.float64)[inverse]


def compute_edges_shortest_path(
    vertex_positions: np.ndarray,
    triangles: np.ndarray,
    node_vertex_indices: np.ndarray,
    max_neighbor_count: int,
    node_coverage: float,
    enforce_total_num_neighbors: bool = False,
    vertex_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Geodesic node edges.

    Per node, the mesh vertices in ascending (shortest-path distance, vertex
    index) order, the order a vertex-by-vertex Dijkstra pops them in; the
    first ``max_neighbor_count`` other nodes become its edges, with weights
    exp(-d^2 / (2 coverage^2)) normalized per node (uniform when they sum to
    0). Paths end at 2 * node_coverage unless
    ``enforce_total_num_neighbors``; a vertex outside ``vertex_mask`` is
    never entered. The distances are scipy's Dijkstra over the f64 edge
    lengths of :func:`_edge_lengths`.

    Returns (edges i32[N, K] -1-padded, weights f32[N, K], distances
    f32[N, K], node-to-vertex distances f32[N, V]: each vertex popped before
    the K-th edge was found, inf elsewhere).
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    pts = np.asarray(vertex_positions, np.float32)
    v = len(pts)
    node_vertex_indices = np.asarray(node_vertex_indices, np.int64)
    n = len(node_vertex_indices)
    k = max_neighbor_count
    starts, nbrs = _vertex_adjacency(v, triangles)
    src = np.repeat(np.arange(v), np.diff(starts))
    keep = np.ones(len(nbrs), bool) if vertex_mask is None else np.asarray(vertex_mask, bool)[nbrs]
    src, dst = src[keep], nbrs[keep]
    graph = csr_matrix((_edge_lengths(pts, src, dst), (src, dst)), shape=(v, v))
    vertex_to_node = np.full(v, -1, np.int64)
    vertex_to_node[node_vertex_indices] = np.arange(n)
    max_influence = 2.0 * node_coverage
    sigma_sq2 = 2.0 * node_coverage * node_coverage

    edges = np.full((n, k), -1, np.int32)
    weights = np.zeros((n, k), np.float32)
    distances = np.zeros((n, k), np.float32)
    n2v = np.full((n, v), np.inf, np.float32)
    sources = np.nonzero(node_vertex_indices >= 0)[0]
    if len(sources) == 0 or v == 0:
        return edges, weights, distances, n2v
    limit = np.inf if enforce_total_num_neighbors else max_influence
    all_dist = dijkstra(graph, directed=True, indices=node_vertex_indices[sources], limit=limit)
    for row, ni in enumerate(sources.tolist()):
        d = all_dist[row]
        reached = np.nonzero(np.isfinite(d) & ((d <= max_influence) | enforce_total_num_neighbors))[0]
        order = reached[np.lexsort((reached, d[reached]))]
        node_ids = vertex_to_node[order]
        hits = np.nonzero((node_ids >= 0) & (node_ids != ni))[0][:k]
        popped = order[: hits[-1]] if len(hits) == k else order
        n2v[ni, popped] = d[popped]
        found_d = [float(x) for x in d[order[hits]]]
        edges[ni, : len(hits)] = node_ids[hits]
        distances[ni, : len(hits)] = found_d
        raw_w = [np.exp(-dd * dd / sigma_sq2) for dd in found_d]
        if raw_w:
            s = sum(raw_w)
            norm = s if s > 0 else len(raw_w)
            weights[ni, : len(raw_w)] = np.asarray(raw_w, np.float32) / norm
    return edges, weights, distances, n2v
