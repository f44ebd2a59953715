"""Surface extraction from TSDF volumes by marching tetrahedra (port of
``dynamicfuion_python_tpu/ops/marching_tetrahedra.py``).

The denser alternative to marching cubes (``VoxelBlockGrid.
extract_triangle_soup(method="tetrahedra")``): each cube cell splits into 6
tetrahedra around its main diagonal, and each tetrahedron's 4-bit sign case
selects 0, 1 or 2 triangles on its sign-changing edges. The 16-case table is
generated at import time exactly as in the JAX package (every case derived
and orientation-checked numerically); occupied triangle slots are compacted
to a fixed capacity, and geometry is computed for those only.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ops.compaction import compact_mask_indices

# ---------------------------------------------------------------------------
# Table generation (runs once at import, pure numpy)
# ---------------------------------------------------------------------------

# Corner offsets of a unit cube, index = bit code (x + 2y + 4z order NOT used;
# plain binary: bit0->x, bit1->y, bit2->z)
_CUBE_CORNERS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float32
)

# 6-tetrahedra decomposition of the cube around the main diagonal 0-7.
# Every tet contains corners 0 and 7; consecutive pairs share faces.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int32,
)

# tet edges as pairs of local tet-corner indices (0..3)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32
)


def _build_case_table() -> np.ndarray:
    """For each of 16 sign cases of a tet, up to 2 triangles of tet-edge ids.

    Entry [case, tri, corner] = tet-edge index (0..5) or -1 (unused).
    A corner is "inside" (negative TSDF) when its case bit is set. Triangle
    winding is fixed numerically so the cross-product normal points from the
    inside (negative) region toward the outside — the outward surface normal
    convention marching cubes uses.
    """
    # canonical embedding: tet corners of the first tet of a unit cube
    pos = _CUBE_CORNERS[_TETS[0]]
    table = -np.ones((16, 2, 3), np.int64)
    for case in range(1, 15):
        inside = [(case >> c) & 1 == 1 for c in range(4)]
        crossing = [
            e
            for e, (a, b) in enumerate(_TET_EDGES)
            if inside[a] != inside[b]
        ]
        # midpoints as stand-in vertices for orientation checks
        mid = {
            e: 0.5 * (pos[_TET_EDGES[e][0]] + pos[_TET_EDGES[e][1]])
            for e in crossing
        }
        inside_centroid = np.mean(
            [pos[c] for c in range(4) if inside[c]], axis=0
        )
        outside_centroid = np.mean(
            [pos[c] for c in range(4) if not inside[c]], axis=0
        )
        out_dir = outside_centroid - inside_centroid

        def orient(tri):
            a, b, c = (mid[e] for e in tri)
            n = np.cross(b - a, c - a)
            return tri if np.dot(n, out_dir) > 0 else (tri[0], tri[2], tri[1])

        if len(crossing) == 3:
            table[case, 0] = orient(tuple(crossing))
        elif len(crossing) == 4:
            # order the quad so consecutive vertices share a tet face: sort
            # by angle around the quad centroid in its plane
            center = np.mean([mid[e] for e in crossing], axis=0)
            normal = out_dir / (np.linalg.norm(out_dir) + 1e-12)
            ref = mid[crossing[0]] - center
            ref -= normal * np.dot(ref, normal)
            ref /= np.linalg.norm(ref) + 1e-12
            ref2 = np.cross(normal, ref)

            def angle(e):
                d = mid[e] - center
                return np.arctan2(np.dot(d, ref2), np.dot(d, ref))

            ring = sorted(crossing, key=angle)
            table[case, 0] = orient((ring[0], ring[1], ring[2]))
            table[case, 1] = orient((ring[0], ring[2], ring[3]))
        else:  # pragma: no cover - cases 0/15 have no crossings
            raise AssertionError
    return table


_CASE_TABLE = _build_case_table()  # [16, 2, 3]
_CASE_TRI_COUNT = np.array(
    [int((row[0] >= 0).all()) + int((row[1] >= 0).all()) for row in _CASE_TABLE],
    np.int32,
)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def marching_tetrahedra(
    tsdf: torch.Tensor,
    valid: torch.Tensor,
    origins: torch.Tensor,
    scale: float,
    max_triangles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero isosurface of batched padded TSDF volumes.

    tsdf f32[B, R+1, R+1, R+1] per block with its +1 halo stitched in, valid
    bool of the same shape (observed voxels), origins f32[B, 3] (world
    position of each block's voxel (0, 0, 0)), scale = voxel size.

    Returns triangles f32[max_triangles, 3, 3] (zero-padded) and the count
    of real triangles (clamped at the capacity).
    """
    r = tsdf.shape[1] - 1
    dev = tsdf.device
    corners = torch.as_tensor(_CUBE_CORNERS.astype(np.int64)).to(dev)  # [8, 3]
    tets = torch.as_tensor(_TETS.astype(np.int64)).to(dev)  # [6, 4]
    tet_edges = torch.as_tensor(_TET_EDGES.astype(np.int64)).to(dev)  # [6, 2]
    case_table = torch.as_tensor(_CASE_TABLE).to(dev)  # [16, 2, 3]
    case_tri_count = torch.as_tensor(_CASE_TRI_COUNT.astype(np.int64)).to(dev)

    # cell corner values and validity: [B, R, R, R, 8]
    offsets = _CUBE_CORNERS.astype(int)
    corner_vals = torch.stack([tsdf[:, x : x + r, y : y + r, z : z + r] for x, y, z in offsets], dim=-1)
    corner_valid = torch.stack([valid[:, x : x + r, y : y + r, z : z + r] for x, y, z in offsets], dim=-1)
    cell_ok = torch.all(corner_valid, dim=-1)

    # per-tet sign case: [B, R, R, R, 6]
    inside = (corner_vals[..., tets] < 0.0).to(torch.int64)  # [B, R, R, R, 6, 4]
    case = inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2] + 8 * inside[..., 3]
    tri_count = case_tri_count[case] * cell_ok[..., None]

    # each tet slot holds up to 2 triangles
    flat_case = case.reshape(-1)
    flat_count = tri_count.reshape(-1)
    occupancy = torch.stack([flat_count >= 1, flat_count >= 2], dim=-1).reshape(-1)
    n_slots = occupancy.shape[0]
    tri_ids, total = compact_mask_indices(occupancy, max_triangles, fill_value=n_slots)
    count = torch.clamp(total, max=max_triangles)
    in_range = tri_ids < n_slots
    safe_ids = torch.where(in_range, tri_ids, 0)

    # triangle slot -> (block, cell xyz, tet, triangle within the tet)
    tet_slot = safe_ids // 2
    tri_in_tet = safe_ids % 2
    tet_idx = tet_slot % 6
    cell = tet_slot // 6
    cz = cell % r
    cy = (cell // r) % r
    cx = (cell // (r * r)) % r
    blk = cell // (r * r * r)

    edges = case_table[flat_case[tet_slot], tri_in_tet]  # [T, 3] tet-edge ids
    # edge endpoints as tet corners -> cube corners -> voxel coordinates
    end_pair = tet_edges[edges]  # [T, 3, 2]
    tet_corners = tets[tet_idx][:, None, :].expand(-1, 3, 4)
    corner_a = torch.gather(tet_corners, -1, end_pair[..., 0:1])[..., 0]
    corner_b = torch.gather(tet_corners, -1, end_pair[..., 1:2])[..., 0]
    base = torch.stack([cx, cy, cz], dim=-1)[:, None, :]  # [T, 1, 3]
    pos_a = base + corners[corner_a]  # [T, 3, 3]
    pos_b = base + corners[corner_b]

    def sample(pos):
        return tsdf[blk[:, None], pos[..., 0], pos[..., 1], pos[..., 2]]

    val_a, val_b = sample(pos_a), sample(pos_b)
    t = val_a / torch.where(torch.abs(val_a - val_b) > 1e-12, val_a - val_b, 1e-12)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    verts_local = pos_a.to(torch.float32) * (1 - t) + pos_b.to(torch.float32) * t
    verts = origins[blk][:, None, :] + verts_local * scale
    return torch.where(in_range[:, None, None], verts, 0.0), count
