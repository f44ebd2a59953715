"""Point / normal warping by an embedded-deformation graph (port of
``dynamicfuion_python_tpu/ops/warp.py``):

  warped_point  = sum_k w_k * (p_k + R_k (x - p_k) + t_k)
  warped_normal = sum_k w_k * (R_k n)

Anchor slots of index -1 contribute nothing.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for an integer ``index`` of any shape, as
    ``index_select``: its backward is an ``index_add_`` (atomics on the
    card), where advanced indexing's sorts every index and sums each row's
    duplicates serially, seconds per step when a few hundred nodes are
    gathered for a million anchors."""
    return torch.index_select(table, 0, index.reshape(-1)).reshape(*index.shape, *table.shape[1:])


def blend_warp(
    points: torch.Tensor,
    nodes: torch.Tensor,
    node_rotations: torch.Tensor,
    node_translations: torch.Tensor,
    anchors: torch.Tensor,
    weights: torch.Tensor,
    normals: torch.Tensor | None = None,
):
    """Warp points f32[..., 3] (and normals) by blended node transforms."""
    safe = anchors.clamp(min=0).long()
    w = torch.where(anchors >= 0, weights, 0.0)
    anchor_nodes = gather_rows(nodes, safe)
    rot = gather_rows(node_rotations, safe)
    trans = gather_rows(node_translations, safe)
    offset = points[..., None, :] - anchor_nodes
    rotated = torch.einsum("...kab,...kb->...ka", rot, offset)
    contrib = anchor_nodes + rotated + trans
    warped = torch.einsum("...k,...ka->...a", w, contrib)
    if normals is None:
        return warped
    rotated_n = torch.einsum("...kab,...b->...ka", rot, normals)
    warped_n = torch.einsum("...k,...ka->...a", w, rotated_n)
    return warped, warped_n
