"""Batched axis-angle <-> rotation-matrix conversions (Rodrigues formula).

Port of ``dynamicfuion_python_tpu/ops/linalg/rodrigues.py``: branch-free
batched tensor math with a Taylor fallback near theta = 0, so the op stays
exact and differentiable there.
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-6


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product (skew-symmetric) matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle vectors -> [..., 3, 3] rotations.

    R = I + sin(t)/t K + (1-cos(t))/t^2 K^2 with K = skew(v), t = |v|; both
    coefficients switch to 2nd-order Taylor expansions below ``_SMALL_ANGLE``.
    """
    theta_sq = torch.sum(axis_angle * axis_angle, dim=-1)
    small = theta_sq < _SMALL_ANGLE**2
    # clamped denominators: the untaken branch never divides by zero
    safe_sq = torch.clamp(theta_sq, min=_SMALL_ANGLE**2)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    k = skew(axis_angle)
    k2 = torch.matmul(k, k)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def matrix_to_axis_angle(rotation: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: [..., 3, 3] rotations -> [..., 3] axis-angle."""
    trace = rotation[..., 0, 0] + rotation[..., 1, 1] + rotation[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            rotation[..., 2, 1] - rotation[..., 1, 2],
            rotation[..., 0, 2] - rotation[..., 2, 0],
            rotation[..., 1, 0] - rotation[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    # theta / (2 sin theta) with Taylor fallback 1/2 + theta^2/12 near 0
    small = torch.abs(sin_theta) < _SMALL_ANGLE
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * sin_theta, min=_SMALL_ANGLE),
    )
    return w * scale[..., None]
