"""Point / normal warping by an embedded-deformation graph (port of
``dynamicfuion_python_tpu/ops/warp.py``):

  warped_point  = sum_k w_k * (p_k + R_k (x - p_k) + t_k)
  warped_normal = sum_k w_k * (R_k n)

Anchor slots of index -1 contribute nothing.
"""

from __future__ import annotations

import torch

from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum


class _GatherRows(torch.autograd.Function):
    """``index_select`` rows of a table; the backward sums the gradient's
    rows into the table's rows with :func:`segment_sum`: ``index_add_`` in
    index order on the CPU (the bits of autograd's own ``index_select``
    backward), a fixed order on the card, where autograd's ``index_add_``
    adds with float atomics."""

    @staticmethod
    def forward(table, index):
        return torch.index_select(table, 0, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.rows = inputs[0].shape[0]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return segment_sum(grad, index, ctx.rows), None


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for an integer ``index`` of any shape, as
    ``index_select`` (advanced indexing's backward sorts every index and
    sums each row's duplicates serially, seconds per step when a few
    hundred nodes are gathered for a million anchors), whose backward is a
    :func:`segment_sum` of the gradient's rows."""
    return _GatherRows.apply(table, index.reshape(-1)).reshape(*index.shape, *table.shape[1:])


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
