"""Shaders over rasterizer fragments (port of
``dynamicfuion_python_tpu/ops/shading.py``): interpolated vertex colors, flat
fill with dark triangle edges, and Lambertian shading from interpolated
normals (the renderer's default, for the prior's rendered source image and
telemetry)."""

from __future__ import annotations

import torch

from dynamicfuion_python_tpu_torch.ops.interpolate import (
    interpolate_face_attributes,
    vertex_attributes_to_face,
)
from dynamicfuion_python_tpu_torch.ops.rasterize import Fragments


def _rgb(value, like: torch.Tensor) -> torch.Tensor:
    """A constant f32 vector on ``like``'s device, filled there: no host copy."""
    return torch.stack([like.new_full((), float(c), dtype=torch.float32) for c in value])


def _nearest_attribute(fragments: Fragments, vertex_values, triangles) -> torch.Tensor:
    face_attrs = vertex_attributes_to_face(vertex_values, triangles)
    return interpolate_face_attributes(
        fragments.face_indices[..., :1], fragments.barycentrics[..., :1, :], face_attrs
    )[..., 0, :]


def vertex_color_shader(fragments: Fragments, vertex_colors, triangles, background=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Barycentric-interpolated vertex colors of the nearest fragment."""
    colors = _nearest_attribute(fragments, vertex_colors, triangles)
    hit = fragments.face_indices[..., 0] >= 0
    return torch.where(hit[..., None], colors, _rgb(background, colors))


def flat_edge_shader(
    fragments: Fragments,
    face_color=(0.8, 0.8, 0.8),
    edge_color=(0.0, 0.0, 0.0),
    edge_width_barycentric: float = 0.05,
    background=(1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Flat fill with dark triangle edges (min barycentric < threshold)."""
    bary = fragments.barycentrics[..., 0, :]
    hit = fragments.face_indices[..., 0] >= 0
    on_edge = torch.amin(bary, dim=-1) < edge_width_barycentric
    color = torch.where(on_edge[..., None], _rgb(edge_color, bary), _rgb(face_color, bary))
    return torch.where(hit[..., None], color, _rgb(background, bary))


def normal_shader(
    fragments: Fragments,
    vertex_normals,
    triangles,
    light_direction=(0.3, -0.3, -0.9),
    albedo=(0.7, 0.7, 0.75),
    background=(1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Lambertian shading from interpolated normals."""
    normals = _nearest_attribute(fragments, vertex_normals, triangles)
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-9)
    light = torch.tensor(light_direction, dtype=torch.float32)
    light = _rgb((light / torch.linalg.norm(light)).tolist(), n)
    intensity = torch.clamp(torch.abs(torch.sum(n * -light, dim=-1)), 0.1, 1.0)
    hit = fragments.face_indices[..., 0] >= 0
    color = intensity[..., None] * _rgb(albedo, n)
    return torch.where(hit[..., None], color, _rgb(background, n))
