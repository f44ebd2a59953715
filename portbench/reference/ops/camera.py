"""Pinhole camera projection / unprojection (port of
``dynamicfuion_python_tpu/ops/camera.py``)."""

from __future__ import annotations

import torch


def unproject_depth_image(
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    depth_scale: float = 1000.0,
    depth_max: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth image [H, W] (1/depth_scale meters, 0 = missing) -> camera-space
    point image f32[H, W, 3] (zeros where invalid) + mask bool[H, W]."""
    h, w = depth.shape
    z = depth.to(torch.float32) / depth_scale
    mask = (z > 0.0) & (z <= depth_max)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    points = torch.stack([x, y, z], dim=-1)
    return torch.where(mask[..., None], points, 0.0), mask


def project_points(
    points: torch.Tensor, intrinsics: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points [..., 3] -> pixel coordinates [..., 2] + in-front
    mask."""
    z = points[..., 2]
    valid = z > 1e-6
    safe_z = torch.where(valid, z, 1.0)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u = points[..., 0] / safe_z * fx + cx
    v = points[..., 1] / safe_z * fy + cy
    return torch.stack([u, v], dim=-1), valid


def transform_points(points: torch.Tensor, matrix4: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to [..., 3] points."""
    rotated = torch.einsum("ij,...j->...i", matrix4[:3, :3], points)
    return rotated + matrix4[:3, 3]
