"""Colour frames for the SOD cell, made from the seed: a salient ellipse
that moves from frame to frame over a textured background, with per-pixel
sensor noise, written as 8-bit RGB PNGs (as ``chip_smoke.py``'s SOD phase
draws its frames, but from the run's seed). The ellipse's colour, axes and
path and the background's gratings are drawn per run; its path closes over
the sequence, so a cycled sequence has no jump."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.reference.data.images import write_png


def write_frames(folder: Path, count: int, size_hw, seed: int) -> list[Path]:
    """``count`` frames of ``size_hw`` in ``folder`` (``000000.png`` ...);
    returns their paths in order."""
    rng = np.random.default_rng([seed, 7])
    h, w = size_hw
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    # background: three colour gratings of seeded direction, period and phase
    background = np.zeros((h, w, 3), np.float32)
    for _ in range(3):
        angle, period, phase = rng.uniform(0, np.pi), rng.uniform(0.05, 0.3) * min(h, w), rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * (u * np.cos(angle) + v * np.sin(angle)) / period + phase)
        background += wave[..., None] * rng.uniform(5, 25, size=3).astype(np.float32)
    background += rng.uniform(60, 140, size=3).astype(np.float32)
    colour = rng.uniform(150, 240, size=3).astype(np.float32)
    axes = rng.uniform(0.15, 0.3, size=2) * min(h, w)
    turn = rng.uniform(0, 2 * np.pi, size=2)
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(count):
        t = 2 * np.pi * i / count
        cu = w / 2 + 0.25 * w * np.cos(t + turn[0])
        cv = h / 2 + 0.2 * h * np.sin(2 * t + turn[1])
        inside = ((u - cu) / axes[0]) ** 2 + ((v - cv) / axes[1]) ** 2 < 1.0
        img = np.where(inside[..., None], colour, background) + rng.normal(0, 6, size=(h, w, 3))
        paths.append(folder / f"{i:06d}.png")
        write_png(paths[-1], np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return paths
