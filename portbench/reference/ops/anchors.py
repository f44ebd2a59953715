"""Warp anchors: K nearest nodes + Gaussian coverage weights (port of
``dynamicfuion_python_tpu/ops/anchors.py``)."""

from __future__ import annotations

import torch

from portbench.reference.ops.knn import knn


def compute_anchors_euclidean(
    points: torch.Tensor,
    nodes: torch.Tensor,
    anchor_count: int,
    node_coverage: float | None = None,
    node_coverage_squared: torch.Tensor | None = None,
    minimum_valid_anchor_count: int = 0,
    use_threshold: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-NN anchors + normalized weights w_k = exp(-d_k^2 / (2 cov^2)).

    Exactly one of ``node_coverage`` (scalar sigma) / ``node_coverage_squared``
    (f32[N] per-node sigma^2) is given. With ``use_threshold`` anchors with
    d > 2 cov are dropped (-1) and points with fewer than
    ``minimum_valid_anchor_count`` survivors are invalid. Returns anchors
    int32[..., K], weights f32[..., K], valid bool[...].
    """
    if (node_coverage is None) == (node_coverage_squared is None):
        raise ValueError("pass exactly one of node_coverage / node_coverage_squared")
    d2, idx = knn(points, nodes, anchor_count)
    if node_coverage_squared is None:
        cov_sq = torch.full_like(d2, float(node_coverage) ** 2)
    else:
        cov_sq = node_coverage_squared[idx.long()]
    weights = torch.exp(-d2 / (2.0 * cov_sq))
    if use_threshold:
        keep = d2 <= 4.0 * cov_sq
        idx = torch.where(keep, idx, -1)
        weights = torch.where(keep, weights, 0.0)
        valid = torch.sum(keep, dim=-1) >= minimum_valid_anchor_count
        idx = torch.where(valid[..., None], idx, -1)
        weights = torch.where(valid[..., None], weights, 0.0)
    else:
        valid = torch.ones(d2.shape[:-1], dtype=torch.bool, device=d2.device)
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    valid_slots = idx >= 0
    valid_counts = torch.sum(valid_slots, dim=-1, keepdim=True)
    uniform = torch.where(valid_slots, 1.0 / torch.clamp(valid_counts, min=1), 0.0)
    weights = torch.where(
        weight_sum > 0.0, weights / torch.clamp(weight_sum, min=1e-30), uniform
    )
    return idx.to(torch.int32), weights, valid
