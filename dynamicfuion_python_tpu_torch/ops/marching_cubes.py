"""Marching-cubes surface extraction from TSDF volumes (port of
``dynamicfuion_python_tpu/ops/marching_cubes.py``).

The 256-entry case table is generated at import time exactly as in the JAX
package: for every corner-sign case the crossing edges are paired per cube
face ("inside corners isolated" on ambiguous faces, so adjacent cubes agree),
linked into closed rings, fan-triangulated and orientation-checked.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.utils import trace

# corner i sits at ((i>>0)&1, (i>>1)&1, (i>>2)&1)
_CORNERS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float32
)

# the 12 cube edges as corner pairs (fixed order = edge id)
_EDGES = np.array(
    [
        [0, 1], [2, 3], [4, 5], [6, 7],  # x-aligned
        [0, 2], [1, 3], [4, 6], [5, 7],  # y-aligned
        [0, 4], [1, 5], [2, 6], [3, 7],  # z-aligned
    ],
    np.int32,
)

# 6 faces as rings of 4 corners (ring order walks the face boundary)
_FACES = [
    [0, 1, 3, 2],  # z = 0
    [4, 5, 7, 6],  # z = 1
    [0, 1, 5, 4],  # y = 0
    [2, 3, 7, 6],  # y = 1
    [0, 2, 6, 4],  # x = 0
    [1, 3, 7, 5],  # x = 1
]

_EDGE_ID = {tuple(sorted(e)): i for i, e in enumerate(_EDGES)}


def _face_pairings(inside: list[bool]) -> list[tuple[int, int]]:
    """Pair the crossing edges of every face for one sign case."""
    pairs = []
    for ring in _FACES:
        crossings = []  # (edge_id, inside_corner)
        for k in range(4):
            a, b = ring[k], ring[(k + 1) % 4]
            if inside[a] != inside[b]:
                eid = _EDGE_ID[tuple(sorted((a, b)))]
                crossings.append((eid, a if inside[a] else b))
        if not crossings:
            continue
        if len(crossings) == 2:
            pairs.append((crossings[0][0], crossings[1][0]))
        else:  # ambiguous face: two diagonal inside corners, 4 crossings.
            # "inside corners isolated": pair the two crossings adjacent to
            # the same inside corner — symmetric, so the neighboring cube
            # (which sees the same inside pattern) makes the same choice.
            by_corner: dict[int, list[int]] = {}
            for eid, c in crossings:
                by_corner.setdefault(c, []).append(eid)
            assert len(by_corner) == 2 and all(
                len(v) == 2 for v in by_corner.values()
            )
            for v in by_corner.values():
                pairs.append((v[0], v[1]))
    return pairs


def _build_case_table() -> tuple[np.ndarray, np.ndarray]:
    """[256, 5, 3] triangle table of edge ids (-1 padded) + counts."""
    table = -np.ones((256, 5, 3), np.int64)
    counts = np.zeros(256, np.int32)
    mid = 0.5 * (_CORNERS[_EDGES[:, 0]] + _CORNERS[_EDGES[:, 1]])  # [12, 3]
    for case in range(1, 255):
        inside = [(case >> c) & 1 == 1 for c in range(8)]
        pairs = _face_pairings(inside)
        # crossing edges form a 2-regular graph (one partner per adjacent
        # face) -> disjoint closed rings
        adj: dict[int, list[int]] = {}
        for a, b in pairs:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        assert all(len(v) == 2 for v in adj.values()), (case, adj)
        inside_centroid = _CORNERS[[c for c in range(8) if inside[c]]].mean(0)
        outside_centroid = _CORNERS[
            [c for c in range(8) if not inside[c]]
        ].mean(0)
        out_dir = outside_centroid - inside_centroid

        seen: set[int] = set()
        tris: list[tuple[int, int, int]] = []
        for start in sorted(adj):
            if start in seen:
                continue
            ring = [start]
            seen.add(start)
            prev, cur = None, start
            while True:
                nxt = (
                    adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
                )
                if nxt == start:
                    break
                ring.append(nxt)
                seen.add(nxt)
                prev, cur = cur, nxt
            # fan-triangulate; orient by the ring's Newell normal vs the
            # inside->outside direction
            normal = np.zeros(3)
            for k in range(len(ring)):
                p, q = mid[ring[k]], mid[ring[(k + 1) % len(ring)]]
                normal += np.cross(p, q)
            if np.dot(normal, out_dir) < 0:
                ring = ring[::-1]
            for k in range(1, len(ring) - 1):
                tris.append((ring[0], ring[k], ring[k + 1]))
        assert len(tris) <= 5, (case, tris)
        counts[case] = len(tris)
        for t, tri in enumerate(tris):
            table[case, t] = tri
    return table, counts


_CASE_TABLE, _CASE_TRI_COUNT = _build_case_table()


def marching_cubes(
    tsdf: torch.Tensor,
    valid: torch.Tensor,
    origins: torch.Tensor,
    scale: float,
    max_triangles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero isosurface of batched padded TSDF volumes.

    tsdf f32[B, R+1, R+1, R+1] (with +1 halo), valid bool[B, R+1, R+1, R+1],
    origins f32[B, 3] world position of each block's (0,0,0) voxel, scale the
    voxel size. Returns triangles f32[max_triangles, 3, 3] (padded with 0)
    and count int. Triangles come out in the JAX package's order: slot-major
    over cells flattened as ((x*R + y)*R + z)*B + block.
    """
    b, rp = tsdf.shape[0], tsdf.shape[1]
    r = rp - 1
    dev = tsdf.device
    corners_i = _CORNERS.astype(int)
    case_table = trace.upload(_CASE_TABLE, dev, "mesh.tables", torch.int64)
    edges = trace.upload(_EDGES, dev, "mesh.tables", torch.int64)
    corners = trace.upload(corners_i, dev, "mesh.tables", torch.int64)

    tsdf_t = tsdf.permute(1, 2, 3, 0)  # [R+1, R+1, R+1, B]
    valid_t = valid.permute(1, 2, 3, 0)
    case = torch.zeros((r, r, r, b), dtype=torch.int64, device=dev)
    cell_ok = torch.ones((r, r, r, b), dtype=torch.bool, device=dev)
    for ci, (cx_, cy_, cz_) in enumerate(corners_i):
        cv = tsdf_t[cx_ : cx_ + r, cy_ : cy_ + r, cz_ : cz_ + r, :]
        ok = valid_t[cx_ : cx_ + r, cy_ : cy_ + r, cz_ : cz_ + r, :]
        case = case + (cv < 0.0).to(torch.int64) * (1 << ci)
        cell_ok = cell_ok & ok
    tri_count = trace.upload(_CASE_TRI_COUNT, dev, "mesh.tables")[case] * cell_ok

    cells = r * r * r * b
    flat_case = case.reshape(-1)
    slot = torch.arange(5, device=dev)
    occupancy = (slot[:, None] < tri_count.reshape(1, -1)).reshape(-1)
    tri_ids, total = compact_mask_indices(occupancy, max_triangles, fill_value=occupancy.shape[0])
    count = torch.clamp(total, max=max_triangles)
    in_range = tri_ids < occupancy.shape[0]
    safe_ids = torch.where(in_range, tri_ids, 0)

    cell = safe_ids % cells
    tri_in_cell = safe_ids // cells
    blk = cell % b
    c3 = cell // b
    cz = c3 % r
    cy = (c3 // r) % r
    cx = c3 // (r * r)

    tri_edges = case_table[flat_case[cell], tri_in_cell]  # [T, 3] edge ids
    safe_edges = tri_edges.clamp(min=0)
    corner_a = edges[safe_edges][..., 0]
    corner_b = edges[safe_edges][..., 1]
    base = torch.stack([cx, cy, cz], dim=-1)[:, None, :]
    pos_a = base + corners[corner_a]
    pos_b = base + corners[corner_b]

    def sample(pos):
        return tsdf[blk[:, None], pos[..., 0], pos[..., 1], pos[..., 2]]

    val_a = sample(pos_a)
    val_b = sample(pos_b)
    diff = val_a - val_b
    t = val_a / torch.where(torch.abs(diff) > 1e-12, diff, 1e-12)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    verts_local = pos_a.to(torch.float32) * (1 - t) + pos_b.to(torch.float32) * t
    verts = origins[blk][:, None, :] + verts_local * scale
    verts = torch.where(in_range[:, None, None], verts, 0.0)
    return verts, count
