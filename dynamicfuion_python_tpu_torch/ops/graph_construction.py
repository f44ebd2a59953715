"""Deformation-graph construction from meshes (host-side numpy, runs once
per graph build). Port of the functions of
``dynamicfuion_python_tpu/ops/graph_construction.py`` that the
``FIRST_FRAME_EXTRACTED_MESH`` and ``FIRST_FRAME_DEPTH_IMAGE`` graph modes use:

  - mesh from a depth image: each pixel square becomes up to two triangles
    whose edges are all shorter than a limit;
  - erosion: iteratively drop faces any of whose vertices touch fewer than
    ``min_neighbors`` surviving faces; the mask marks vertices of surviving
    faces;
  - node sampling: greedy Poisson-disk, accept a vertex as node iff no
    previously accepted node lies within ``node_coverage``.
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
