"""Normals of point images and triangle meshes (port of
``dynamicfuion_python_tpu/ops/normals.py``)."""

from __future__ import annotations

import torch

from portbench.reference.ops.segment_sum import segment_sum


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def point_image_normals(vertex_map: torch.Tensor) -> torch.Tensor:
    """Central-difference normals of a camera-space point image,
    n = normalize(cross(right - left, up - down)) flipped so n_z <= 0; zero at
    the border and wherever a neighbor has z == 0."""
    h, w = vertex_map.shape[:2]
    padded = torch.zeros((h + 2, w + 2, 3), dtype=vertex_map.dtype, device=vertex_map.device)
    padded[1:-1, 1:-1] = vertex_map
    left = padded[1:-1, :-2]
    right = padded[1:-1, 2:]
    up = padded[:-2, 1:-1]
    down = padded[2:, 1:-1]
    n = _normalize(torch.linalg.cross(right - left, up - down))
    n = torch.where(n[..., 2:3] > 0, -n, n)
    invalid = (
        (left[..., 2] == 0)
        | (right[..., 2] == 0)
        | (up[..., 2] == 0)
        | (down[..., 2] == 0)
    )
    return torch.where(invalid[..., None], 0.0, n)


def triangle_normals(
    vertices: torch.Tensor, triangles: torch.Tensor, normalized: bool = True
) -> torch.Tensor:
    """Per-face normals; un-normalized value is the area-weighted normal."""
    t = triangles.long()
    v0, v1, v2 = vertices[t[:, 0]], vertices[t[:, 1]], vertices[t[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    return _normalize(n) if normalized else n


def mesh_vertex_normals(vertices: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: each face's normal summed into its
    three vertices, first corners first (one ``segment_sum``)."""
    face_n = triangle_normals(vertices, triangles, normalized=False)
    t = triangles.long()
    n = segment_sum(face_n.repeat(3, 1), t.T.reshape(-1), vertices.shape[0])
    return _normalize(n)
