"""PWC-Net's cost volume (port of ``dynamicfuion_python_tpu/ops/correlation.py``):
for displacement radius 4, output channel ``(dy + 4) * 9 + (dx + 4)`` holds
``mean_c(first[c, y, x] * second[c, y + dy, x + dx])``, with ``second``
zero outside the image. Channels-first, as the networks run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_DISPLACEMENT = 4


def correlation(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """NCHW cost volume: f32[B, C, H, W] x 2 -> f32[B, 81, H, W]."""
    md = MAX_DISPLACEMENT
    h, w = first.shape[-2:]
    padded = F.pad(second, (md, md, md, md))
    out = [
        torch.mean(first * padded[:, :, dy : dy + h, dx : dx + w], dim=1)
        for dy in range(2 * md + 1)
        for dx in range(2 * md + 1)
    ]
    return torch.stack(out, dim=1)
