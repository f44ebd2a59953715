"""The boundary mask of a point image (point jumps across a pixel), which
the training dataset reads (a copy of the port's
``ops/image_proc_extras.py::compute_boundary_mask_points``). Images are
channels-last, on the device of their input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F



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
