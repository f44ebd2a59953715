"""Image warping and sampling (port of
``dynamicfuion_python_tpu/ops/image_warp.py``): bilinear sampling with
zeroed out-of-bounds taps, ``grid_sample``-style normalized sampling (the
neural tracker's correspondence lookup), PWC-Net's backward warp by a flow
field, and the flow and rigid warps of the legacy image ops.

Images are channels-last ``[H, W, C]``, as in the JAX package. The four taps
are written out (no ``F.grid_sample``), so the arithmetic is the JAX
package's: weights ``(1 - du) * (1 - dv)`` etc., taps outside the image
read as zero.
"""

from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor, zeros_outside: bool = True) -> torch.Tensor:
    """Sample ``image`` [H, W, C] at float pixel coordinates ``u``, ``v``
    (any equal shapes) -> [..., C]. Taps outside the image read as zero, or
    as the clamped edge pixel when ``zeros_outside`` is false."""
    h, w = image.shape[:2]
    flat = image.reshape(h * w, -1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    def tap(vi, ui):
        val = flat[vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)]
        if zeros_outside:
            inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            val = torch.where(inside[..., None], val, 0.0)
        return val

    w00 = ((1 - du) * (1 - dv))[..., None]
    w01 = (du * (1 - dv))[..., None]
    w10 = ((1 - du) * dv)[..., None]
    w11 = (du * dv)[..., None]
    return w00 * tap(v0i, u0i) + w01 * tap(v0i, u0i + 1) + w10 * tap(v0i + 1, u0i) + w11 * tap(v0i + 1, u0i + 1)


def grid_sample_normalized(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(..., padding_mode='zeros', align_corners=False)``
    semantics on [H, W, C]: normalized coordinate -1 is the outer edge of the
    corner pixel, so pixel centers sit at ``u = ((x + 1) * W - 1) / 2``.
    ``coords`` [..., 2] (x, y) -> samples [..., C]."""
    h, w = image.shape[:2]
    u = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    v = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    return bilinear_sample(image, u, v)


def _pixel_grid(h: int, w: int, device):
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return v, u


def backward_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """PWC-Net's backward warp: ``image`` [H, W, C] sampled at each pixel
    plus ``flow`` [H, W, 2] (u, v), zero outside the image."""
    h, w = image.shape[:2]
    v_grid, u_grid = _pixel_grid(h, w, image.device)
    return bilinear_sample(image, u_grid + flow[..., 0], v_grid + flow[..., 1])
