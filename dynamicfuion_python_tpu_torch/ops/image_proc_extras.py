"""Legacy image-processing ops (port of
``dynamicfuion_python_tpu/ops/image_proc_extras.py``): the median depth
filter, the masked scene-flow warp of a point image, the two boundary masks
(depth steps, and point jumps across a pixel) and the composition of
rotation-augmented flow fields. Images are channels-last, on the device of
their input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.ops.image_warp import bilinear_sample


def filter_depth(depth: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Median of the valid (non-zero) depths in each (2r+1)^2 window (the
    lower median of an even count); zero where the window holds none."""
    h, w = depth.shape
    k = 2 * radius + 1
    pad = F.pad(depth.to(torch.float32), (radius, radius, radius, radius))
    stack = torch.stack([pad[dy : dy + h, dx : dx + w] for dy in range(k) for dx in range(k)], dim=-1)
    valid = stack > 0
    count = valid.sum(-1)
    ordered = torch.sort(torch.where(valid, stack, torch.inf), dim=-1).values
    idx = torch.clamp((count - 1) // 2, min=0)
    med = torch.gather(ordered, -1, idx[..., None])[..., 0]
    return torch.where(count > 0, med, 0.0).to(depth.dtype)


def warp_3d(point_image: torch.Tensor, scene_flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The point image moved by the scene flow where ``mask`` holds."""
    return torch.where(mask[..., None], point_image + scene_flow, point_image)


def compute_boundary_mask(depth: torch.Tensor, max_distance_mm: float = 100.0) -> torch.Tensor:
    """True where a pixel's depth differs from one of its 4 neighbors (zero
    outside the image) by more than the threshold."""
    d = depth.to(torch.float32)
    h, w = d.shape
    pad = F.pad(d, (1, 1, 1, 1))
    diffs = torch.stack([
        torch.abs(d - pad[0:h, 1 : w + 1]), torch.abs(d - pad[2 : h + 2, 1 : w + 1]),
        torch.abs(d - pad[1 : h + 1, 0:w]), torch.abs(d - pad[1 : h + 1, 2 : w + 2]),
    ])
    return diffs.amax(0) > max_distance_mm


def compute_boundary_mask_points(point_image: torch.Tensor, max_distance: float = 0.1) -> torch.Tensor:
    """True where the left and right neighbor points, or the upper and lower
    ones (zero outside the image), lie more than ``max_distance`` apart:
    the surface jumps across the pixel. ``point_image`` [H, W, 3]."""
    p = point_image.to(torch.float32)
    h, w = p.shape[:2]
    pad = F.pad(p, (0, 0, 1, 1, 1, 1))
    d_lr = torch.linalg.norm(pad[1 : h + 1, 2 : w + 2] - pad[1 : h + 1, 0:w], dim=-1)
    d_ud = torch.linalg.norm(pad[2 : h + 2, 1 : w + 1] - pad[0:h, 1 : w + 1], dim=-1)
    return (d_lr > max_distance) | (d_ud > max_distance)


def compute_augmented_flow_from_rotation(
    flow_rot_sa2so: torch.Tensor, flow_so2to: torch.Tensor, flow_rot_to2ta: torch.Tensor
) -> torch.Tensor:
    """Compose three pixel flows [H, W, 2], augmented source -> source ->
    target -> augmented target, by chained bilinear lookups: the total
    displacement of each augmented-source pixel."""
    h, w = flow_rot_sa2so.shape[:2]
    dev = flow_rot_sa2so.device
    vg = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    ug = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    u1 = ug + flow_rot_sa2so[..., 0]
    v1 = vg + flow_rot_sa2so[..., 1]
    f12 = bilinear_sample(flow_so2to, u1, v1)
    u2 = u1 + f12[..., 0]
    v2 = v1 + f12[..., 1]
    f23 = bilinear_sample(flow_rot_to2ta, u2, v2)
    return torch.stack([u2 + f23[..., 0] - ug, v2 + f23[..., 1] - vg], dim=-1)
