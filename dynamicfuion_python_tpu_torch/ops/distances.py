"""Point-to-plane distances (port of
``dynamicfuion_python_tpu/ops/distances.py``): the per-pixel depth residual
of the dense-depth fitter, d = dot(n, p_rast - p_ref)."""

from __future__ import annotations

import torch


def point_to_plane_distances(
    rasterized_points: torch.Tensor,
    reference_points: torch.Tensor,
    rasterized_normals: torch.Tensor,
) -> torch.Tensor:
    """dot(n, p_rast - p_ref) over matching [..., 3] tensors -> [...]."""
    return torch.sum(rasterized_normals * (rasterized_points - reference_points), dim=-1)
