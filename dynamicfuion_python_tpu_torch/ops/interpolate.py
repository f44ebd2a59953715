"""Barycentric interpolation of face-vertex attributes over fragments (port
of ``dynamicfuion_python_tpu/ops/interpolate.py``)."""

from __future__ import annotations

import torch


def interpolate_face_attributes(
    face_indices: torch.Tensor,
    barycentrics: torch.Tensor,
    face_attributes: torch.Tensor,
) -> torch.Tensor:
    """Blend per-face-vertex attributes with fragment barycentrics.

    face_indices int32[H, W, K] (-1 = empty), barycentrics f32[H, W, K, 3],
    face_attributes f32[F, 3, C] -> f32[H, W, K, C], zeros on empty
    fragments. The blend is an f32 multiply and sum (no TF32), as the JAX
    package's einsum at ``Precision.HIGHEST``.
    """
    attrs = face_attributes[torch.clamp(face_indices, min=0).long()]  # [H, W, K, 3, C]
    out = torch.sum(barycentrics[..., None] * attrs, dim=-2)
    return torch.where((face_indices >= 0)[..., None], out, 0.0)


def vertex_attributes_to_face(attributes: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """f32[V, C] per-vertex attributes -> f32[F, 3, C] per-face-vertex."""
    return attributes[triangles.long()]
