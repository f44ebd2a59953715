"""A seeded DeepDeform-layout training split: the training cells' pairs.

The port's ``data/synthetic_pairs.py::write_split`` with its rates drawn from
the seed: a textured 0.44 x 0.36 m patch at 1 m that slides (``shift``) or
bends (``bend``), one sequence each, ``frames`` frames, and the pairs
(0, t) for t = 1 .. frames - 1 in each, with closed-form optical and scene
flow. PNG frames, flows and the intrinsics go under ``root``; the graph data
of each source frame is made by the reference's ``create_graph_data``, so
both the port and the reference read the same files. Every seed gives the
same image size and pair count.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.reference.apps import create_graph_data
from portbench.reference.data.io import save_flow_binary
from portbench.reference.data.images import write_png

HALF_EXTENT = (0.22, 0.18)  # metres, x and y


def intrinsics_for(size_hw: tuple[int, int]) -> np.ndarray:
    """Pinhole intrinsics with the DeepDeform sensor's field of view (focal
    575 px at 640 columns), principal point at the image center."""
    h, w = size_hw
    f = 575.0 * w / 640.0
    return np.asarray([[f, 0.0, (w - 1) / 2], [0.0, f, (h - 1) / 2], [0.0, 0.0, 1.0]], np.float64)


def _texture(x0, y0, phase) -> np.ndarray:
    x0, y0 = (x0 + phase[0]).astype(np.float32), (y0 + phase[1]).astype(np.float32)
    r = 0.5 + 0.5 * np.sin(x0 * 61.0) * np.cos(y0 * 47.0)
    g = 0.5 + 0.5 * np.sin((x0 + y0) * 83.0)
    b = 0.5 + 0.5 * np.cos(x0 * 29.0 - y0 * 97.0)
    return np.clip(np.stack([r, g, b], -1) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _surface(motion, t, x_n, y_n, rate):
    """(depth m, material x0, y0, on-patch mask) of frame ``t``."""
    if motion == "shift":
        dx, dy, dz = (t * np.asarray(rate, np.float64)).tolist()
        z = np.full_like(x_n, 1.0 + dz)
    else:
        a = rate * t * x_n * x_n
        z = np.where(a > 1e-12, (1.0 - np.sqrt(np.maximum(1.0 - 4.0 * a, 0.0))) / (2.0 * np.maximum(a, 1e-12)), 1.0)
        dx = dy = 0.0
    x0, y0 = x_n * z - dx, y_n * z - dy
    on = (np.abs(x0) < HALF_EXTENT[0]) & (np.abs(y0) < HALF_EXTENT[1])
    return z, x0, y0, on


def _moved(motion, t0, t1, points, rate):
    out = points.copy()
    if motion == "shift":
        out += (t1 - t0) * np.asarray(rate, np.float64)
    else:
        out[..., 2] = 1.0 + rate * t1 * points[..., 0] ** 2
    return out


def write_sequence(seq_dir: Path, size_hw, motion: str, frames: int, rate, phase) -> Path:
    h, w = size_hw
    k = intrinsics_for(size_hw)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x_n, y_n = (u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1]
    for sub in ("color", "depth", "optical_flow", "scene_flow"):
        (seq_dir / sub).mkdir(parents=True, exist_ok=True)
    pad = np.eye(4)
    pad[:3, :3] = k
    np.savetxt(seq_dir / "intrinsics.txt", pad, fmt="%.6f")
    surfaces = []
    for t in range(frames):
        z, x0, y0, on = _surface(motion, t, x_n, y_n, rate)
        depth = np.where(on, np.round(z * 1000.0), 0).astype(np.uint16)
        color = np.where(on[..., None], _texture(x0, y0, phase), 40).astype(np.uint8)
        write_png(seq_dir / "depth" / f"{t:06d}.png", depth)
        write_png(seq_dir / "color" / f"{t:06d}.png", color)
        surfaces.append((depth, on))
    depth, on = surfaces[0]
    z = depth.astype(np.float64) / 1000.0
    points = np.stack([x_n * z, y_n * z, z], -1)
    for tgt in range(1, frames):
        moved = _moved(motion, 0, tgt, points, rate)
        flow = np.stack([moved[..., 0] / moved[..., 2] * k[0, 0] + k[0, 2] - u,
                         moved[..., 1] / moved[..., 2] * k[1, 1] + k[1, 2] - v])
        scene = np.moveaxis(moved - points, -1, 0)
        flow[:, ~on] = np.nan
        scene[:, ~on] = np.nan
        name = f"{seq_dir.name}_{0:06d}_{tgt:06d}"
        save_flow_binary(seq_dir / "optical_flow" / f"{name}.oflow", flow.astype(np.float32))
        save_flow_binary(seq_dir / "scene_flow" / f"{name}.sflow", scene.astype(np.float32))
    return seq_dir


def write_split(root: str | Path, size_hw: tuple[int, int], frames: int, seed: int) -> Path:
    """The two sequences under ``root``, their source frames' graph data and
    ``root/train.json`` listing the ``2 * (frames - 1)`` pairs. Returns the
    labels file."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    rates = {
        "shift": (float(rng.uniform(0.01, 0.03)), float(rng.uniform(-0.01, 0.01)), float(rng.uniform(0.005, 0.015))),
        "bend": float(rng.uniform(0.1, 0.2)),
    }
    labels = root / "train.json"
    for motion in ("shift", "bend"):
        seq = write_sequence(root / motion, size_hw, motion, frames, rates[motion], rng.uniform(0, 1, 2))
        create_graph_data.main([str(seq), "--frames", "0", "--labels", str(labels)])
    return labels
