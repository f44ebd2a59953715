"""Deformation-graph node sampling on meshes (host-side numpy, runs once
per graph build). Port of the two functions of
``dynamicfuion_python_tpu/ops/graph_construction.py`` that the default
``FIRST_FRAME_EXTRACTED_MESH`` graph mode uses:

  - erosion: iteratively drop faces any of whose vertices touch fewer than
    ``min_neighbors`` surviving faces; the mask marks vertices of surviving
    faces;
  - node sampling: greedy Poisson-disk, accept a vertex as node iff no
    previously accepted node lies within ``node_coverage``.
"""

from __future__ import annotations

import numpy as np


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
