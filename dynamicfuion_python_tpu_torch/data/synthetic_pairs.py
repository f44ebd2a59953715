"""Synthetic DeepDeform-layout sequences with closed-form ground truth.

A textured rectangular patch (0.44 m x 0.36 m by default) faces the camera
at 1 m and moves; its colour is a function of the material point, so frames
agree where the surface does. Two motions:

  - ``shift``: the patch slides by ``(dx, dy, dz)`` metres per frame;
  - ``bend``: the patch stays in place and bends away from the camera,
    z = 1 + b_t x^2 with b_t = ``bend`` * t.

Each sequence directory gets ``color/<id>.png`` (8-bit RGB), ``depth/<id>.png``
(16-bit millimetres), ``intrinsics.txt`` and, per frame pair (source,
target), ``optical_flow/<seq>_<src>_<tgt>.oflow`` (pixels) and
``scene_flow/<seq>_<src>_<tgt>.sflow`` (metres), NaN off the patch. PNGs are
written by ``utils/telemetry.py::write_png`` (zlib, no Pillow).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dynamicfuion_python_tpu_torch.data.io import save_flow_binary
from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

HALF_EXTENT = (0.22, 0.18)  # metres, x and y


def intrinsics_for(size_hw: tuple[int, int]) -> np.ndarray:
    """Pinhole intrinsics with the DeepDeform sensor's field of view (focal
    575 px at 640 columns), principal point at the image center."""
    h, w = size_hw
    f = 575.0 * w / 640.0
    return np.asarray([[f, 0.0, (w - 1) / 2], [0.0, f, (h - 1) / 2], [0.0, 0.0, 1.0]], np.float32)


def _texture(x0: np.ndarray, y0: np.ndarray) -> np.ndarray:
    """uint8 RGB of the material point (x0, y0) of the patch."""
    r = 0.5 + 0.5 * np.sin(x0 * 61.0) * np.cos(y0 * 47.0)
    g = 0.5 + 0.5 * np.sin((x0 + y0) * 83.0)
    b = 0.5 + 0.5 * np.cos(x0 * 29.0 - y0 * 97.0)
    return np.clip(np.stack([r, g, b], -1) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _surface(motion: str, t: int, x_n: np.ndarray, y_n: np.ndarray, rate):
    """The patch at frame ``t`` seen through the normalized image
    coordinates: (depth, material x0, material y0, on-patch mask)."""
    ax, ay = HALF_EXTENT
    if motion == "shift":
        dx, dy, dz = (t * np.asarray(rate, np.float64)).tolist()
        z = np.full_like(x_n, 1.0 + dz)
    else:
        b = rate * t
        a = b * x_n * x_n
        # z = 1 + b (x_n z)^2, the root near 1
        z = np.where(a > 1e-12, (1.0 - np.sqrt(np.maximum(1.0 - 4.0 * a, 0.0))) / (2.0 * np.maximum(a, 1e-12)), 1.0)
        dx = dy = 0.0
    x0, y0 = x_n * z - dx, y_n * z - dy
    on = (np.abs(x0) < ax) & (np.abs(y0) < ay)
    return z, x0, y0, on


def _moved(motion: str, t0: int, t1: int, points: np.ndarray, rate) -> np.ndarray:
    """Material points at frame ``t0`` [..., 3] at frame ``t1``."""
    out = points.copy()
    if motion == "shift":
        out += (t1 - t0) * np.asarray(rate, np.float64)
    else:
        out[..., 2] = 1.0 + rate * t1 * points[..., 0] ** 2
    return out


def write_sequence(seq_dir: str | Path, size_hw: tuple[int, int], motion: str, frames: int, pairs, rate=None) -> Path:
    """Write one sequence of ``frames`` frames and the ground truth of each
    (source, target) frame pair in ``pairs``; ``rate`` is the per-frame
    shift (dx, dy, dz) or bend b. Returns the directory."""
    seq_dir = Path(seq_dir)
    if rate is None:
        rate = (0.02, 0.0, 0.01) if motion == "shift" else 0.15
    h, w = size_hw
    k = intrinsics_for(size_hw).astype(np.float64)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x_n, y_n = (u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1]
    for sub in ("color", "depth", "optical_flow", "scene_flow"):
        (seq_dir / sub).mkdir(parents=True, exist_ok=True)
    np.savetxt(seq_dir / "intrinsics.txt", _pad4(k), fmt="%.6f")
    surfaces = []
    for t in range(frames):
        z, x0, y0, on = _surface(motion, t, x_n, y_n, rate)
        depth = np.where(on, np.round(z * 1000.0), 0).astype(np.uint16)
        color = np.where(on[..., None], _texture(x0, y0), 40).astype(np.uint8)
        write_png(seq_dir / "depth" / f"{t:06d}.png", depth)
        write_png(seq_dir / "color" / f"{t:06d}.png", color)
        surfaces.append((depth, on))
    for src, tgt in pairs:
        depth, on = surfaces[src]
        z = depth.astype(np.float64) / 1000.0
        points = np.stack([x_n * z, y_n * z, z], -1)
        moved = _moved(motion, src, tgt, points, rate)
        flow = np.stack([moved[..., 0] / moved[..., 2] * k[0, 0] + k[0, 2] - u,
                         moved[..., 1] / moved[..., 2] * k[1, 1] + k[1, 2] - v])
        scene = np.moveaxis(moved - points, -1, 0)
        flow[:, ~on] = np.nan
        scene[:, ~on] = np.nan
        name = f"{seq_dir.name}_{src:06d}_{tgt:06d}"
        save_flow_binary(seq_dir / "optical_flow" / f"{name}.oflow", flow.astype(np.float32))
        save_flow_binary(seq_dir / "scene_flow" / f"{name}.sflow", scene.astype(np.float32))
    return seq_dir


def _pad4(k: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = k
    return out


def write_split(split_root: str | Path, size_hw: tuple[int, int], pairs=((0, 1), (0, 2))) -> list[Path]:
    """A split of two sequences, ``shift`` and ``bend``, three frames each,
    with the given pairs in each; returns the sequence directories."""
    root = Path(split_root)
    frames = max(max(p) for p in pairs) + 1
    return [write_sequence(root / motion, size_hw, motion, frames, pairs) for motion in ("shift", "bend")]
