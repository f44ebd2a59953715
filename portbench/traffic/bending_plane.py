"""A seeded, periodic bending plane: the fusion cells' frames.

A 0.6 x 0.6 m patch at ``z0`` metres faces the camera and bends away from it,
z = z0 + b_t (x + 0.3)^2, with b_t = A (1 - cos(2 pi t / P)) / 2: the bend
returns every ``P`` frames, so a window of any length sees the same scene
sizes (the port's ``SyntheticBendingPlaneSequence`` grows b_t without limit).
Depth carries Gaussian noise of ``noise_mm_at_1m`` x z^2 millimetres and is
rounded to whole millimetres, as the sensor gives it; colour is a texture of
the material point. The seed draws the noise. Every seed starts at the same
phase and so makes the same sizes: the first frames set the fitter's mesh
buckets for the rest of a run, and a phase drawn from the seed gave runs
buckets from (32768, 65536) to (65536, 131072) vertices and triangles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BendingPlane:
    height: int
    width: int
    focal: float
    period: int = 60
    amplitude: float = 0.3
    z0: float = 1.0
    half_extent: float = 0.3
    noise_mm_at_1m: float = 1.0

    @property
    def intrinsics(self) -> np.ndarray:
        h, w = self.height, self.width
        return np.asarray([[self.focal, 0, w / 2], [0, self.focal, h / 2], [0, 0, 1]], np.float32)

    def bend(self, t: int) -> float:
        return self.amplitude * (1.0 - np.cos(2.0 * np.pi * t / self.period)) / 2.0

    def rays(self) -> tuple[np.ndarray, np.ndarray]:
        """Normalized image coordinates (x / z, y / z) of each pixel."""
        h, w = self.height, self.width
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        return (u - w / 2) / self.focal, (v - h / 2) / self.focal

    def surface(self, t: int, rays=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Noise-free depth (metres), and the material point (x, y) seen at
        each pixel of frame ``t``, in float64."""
        xn, yn = self.rays() if rays is None else rays
        b = self.bend(t)
        # z = z0 + b (xn z + e)^2: the root near z0, in the form that stays
        # exact as b xn^2 -> 0
        e = self.half_extent
        a = b * xn * xn
        bb = 2.0 * b * e * xn - 1.0
        c = self.z0 + b * e * e
        z = 2.0 * c / (-bb + np.sqrt(np.maximum(bb * bb - 4.0 * a * c, 0.0)))
        return z, xn * z, yn * z

    def frames(self, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """One period of (depth u16[H, W] mm, color u8[H, W, 3]), from
        phase 0 (flat)."""
        rng = np.random.default_rng(seed)
        out, rays = [], self.rays()
        for t in range(self.period):
            z, x, y = self.surface(t, rays)
            inside = (np.abs(x) < self.half_extent) & (np.abs(y) < self.half_extent)
            noisy = z * 1000.0 + rng.standard_normal(z.shape) * self.noise_mm_at_1m * z * z
            depth = np.where(inside, np.round(noisy), 0).astype(np.uint16)
            x, y = x.astype(np.float32), y.astype(np.float32)
            r = 0.5 + 0.5 * np.sin(x * 61.0) * np.cos(y * 47.0)
            g = 0.5 + 0.5 * np.sin((x + y) * 83.0)
            bl = 0.5 + 0.5 * np.cos(x * 29.0 - y * 97.0)
            tex = np.clip(np.stack([r, g, bl], -1) * 255.0 + 0.5, 0, 255).astype(np.uint8)
            color = np.where(inside[..., None], tex, 0).astype(np.uint8)
            out.append((depth, color))
        return out
