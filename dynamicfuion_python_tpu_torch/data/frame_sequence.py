"""Frame sequences (the synthetic deforming surface; the DeepDeform
directory loader of the JAX package is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    index: int
    depth: np.ndarray  # u16[H, W] (millimeters)
    color: np.ndarray | None  # u8[H, W, 3]
    mask: np.ndarray | None  # bool[H, W]


class SyntheticBendingPlaneSequence:
    """Deterministic deforming-surface sequence rendered analytically: a plane
    at depth ``z`` bending with per-frame increasing curvature."""

    def __init__(
        self,
        frame_count: int = 8,
        image_size: tuple[int, int] = (240, 320),
        z: float = 1.0,
        bend_per_frame: float = 0.02,
        focal: float = 300.0,
    ):
        self.frame_count = frame_count
        h, w = image_size
        self.image_size = image_size
        self.intrinsics = np.asarray(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
        )
        self.z = z
        self.bend_per_frame = bend_per_frame

    def __len__(self):
        return self.frame_count

    def gt_surface_z(self, x: np.ndarray, y: np.ndarray, index: int) -> np.ndarray:
        bend = self.bend_per_frame * index
        return self.z + bend * (x + 0.3) ** 2

    def load_frame(self, index: int) -> Frame:
        h, w = self.image_size
        fx = self.intrinsics[0, 0]
        cx, cy = self.intrinsics[0, 2], self.intrinsics[1, 2]
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        # solve z from the bending-surface equation along each pixel ray
        # (fixed-point iteration; converges fast for mild bending)
        z = np.full((h, w), self.z, np.float32)
        for _ in range(12):
            x = (u - cx) / fx * z
            y = (v - cy) / fx * z
            z = self.gt_surface_z(x, y, index).astype(np.float32)
        # limit to a finite patch
        x = (u - cx) / fx * z
        y = (v - cy) / fx * z
        inside = (np.abs(x) < 0.3) & (np.abs(y) < 0.3)
        depth = np.where(inside, (z * 1000.0), 0).astype(np.uint16)
        color = np.zeros((h, w, 3), np.uint8)
        color[..., 1] = np.where(inside, 180, 0)
        return Frame(index=index, depth=depth, color=color, mask=inside)

    def __iter__(self):
        for i in range(self.frame_count):
            yield self.load_frame(i)
