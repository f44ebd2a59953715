"""Where a frame's time goes: the 480x640 bending-plane slice on the card,
one frame traced with ``torch.profiler`` and the port's spans
(``utils/trace.py``).

    python -m dynamicfuion_python_tpu_torch.apps.profile_frame [--frames N] [--out DIR]

Defines the slice (:func:`make_slice`), which chip_smoke.py's main path runs
too, the neural prior's 448x640 shifted-plane scene
(:func:`make_shifted_plane`) and the indexed rasterizer's headline scene
(:func:`build_scene`). Warms up on the first frames, then runs the last frame twice from the
same state: untraced on a copy of the pipeline (its wall time), and traced
with the spans on. Prints one JSON line: both wall times, the summed device
time of the traced frame's kernels, the device's idle share of the untraced
frame (and of the traced one, which the profiler's host overhead inflates),
the hand-written kernels' device time per launch, the rigid odometry stage
(its own traced call on the last frame's depth pair: device time of its
kernels and CUDA-event time), by span the device ms, launches, self host ms
and the device's idle ms while the host was in it, the port's counters, and
the operators with the most device time. ``--out`` also receives the Chrome
trace.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
from dynamicfuion_python_tpu_torch.data.frame_sequence import Frame, SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu_torch.ops.rigid_odometry import rigid_odometry_multi_scale
from dynamicfuion_python_tpu_torch.settings import Parameters
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

# default Parameters() (rigid odometry on) with capacity overrides only: the
# fitter's mesh bucket at 65536 triangles; the default 2048-block table fills
# by frame 2 of this scene and more than the default 1024 blocks intersect
# the band from frame 1 (see PERF.md), so both are sized up and no block is
# dropped
SLICE_OVERRIDES = (
    "fusion.mesh_capacity_hint=65536",
    "tsdf.initial_block_count=4096",
    "tsdf.max_active_blocks=2048",
)
# the DeepDeform sensor resolution; focal min(size) * 1.4 (672), as the CLI
# sets it
SLICE_IMAGE_SIZE = (480, 640)
HAND_KERNELS = ("rasterize_tiles_kernel", "mesh_expand_kernel")


def device_us(evt) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def use_fp32_matmuls() -> None:
    """Turn TF32 off, so the card's matrix products round as FP32 ones do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_slice(frame_count: int, image_size: tuple[int, int] = SLICE_IMAGE_SIZE):
    """The slice's ``Parameters`` and bending-plane sequence (focal
    ``min(size) * 1.4``; 448x640 is the size the neural prior's DeformNet
    takes, both sides multiples of 64)."""
    params = apply_overrides(Parameters(), list(SLICE_OVERRIDES))
    seq = SyntheticBendingPlaneSequence(frame_count=frame_count, image_size=image_size, focal=min(image_size) * 1.4)
    return params, seq


# the neural prior's scenes: the reference's DeepDeform input size
PRIOR_IMAGE_SIZE = (448, 640)


class ShiftedPlaneSequence:
    """A flat 0.5 x 0.5 m patch at 1 m, fronto-parallel, moving ``shift``
    metres along +x per frame, with its oracle flow: the aperture case where
    point-to-plane fitting alone cannot see the motion and the prior's flow
    recovers it (the JAX package's ``TestNeuralPrior`` scene)."""

    def __init__(self, frame_count: int = 3, shift: float = 0.08, image_size=PRIOR_IMAGE_SIZE):
        h, w = image_size
        focal = min(image_size) * 1.4
        self.frame_count = frame_count
        self.shift = shift
        self.image_size = image_size
        self.intrinsics = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    def load_frame(self, index: int) -> Frame:
        h, w = self.image_size
        fx, cx, cy = self.intrinsics[0, 0], self.intrinsics[0, 2], self.intrinsics[1, 2]
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        x = (u - cx) / fx
        y = (v - cy) / fx
        inside = (np.abs(x - self.shift * index) < 0.25) & (np.abs(y) < 0.25)
        depth = np.where(inside, 1000.0, 0).astype(np.uint16)
        return Frame(index=index, depth=depth, color=None, mask=inside)

    def oracle_flow(self, frames: int = 1) -> np.ndarray:
        """Dense flow f32[H, W, 2] over ``frames`` frames of motion: every
        pixel moves fx * shift * frames along +u."""
        flow = np.zeros((*self.image_size, 2), np.float32)
        flow[..., 0] = self.intrinsics[0, 0] * self.shift * frames
        return flow

    def __iter__(self):
        for i in range(self.frame_count):
            yield self.load_frame(i)


def make_shifted_plane(frame_count: int = 3):
    """The neural prior's oracle-flow scene: default ``Parameters`` with the
    slice's capacity overrides and rigid odometry off (the camera is
    static and ICP would explain the motion), and the shifted plane."""
    params = apply_overrides(Parameters(), [*SLICE_OVERRIDES, "alignment.use_rigid_alignment=false"])
    return params, ShiftedPlaneSequence(frame_count=frame_count)


# the reference's headline rasterization scene: 64 objects, 4.47M faces at
# 480x640, focal 580 (benchmarks/bench_rasterizer.py), with that bench's tier
# caps for the splat path (the 2x2 tier ~96k faces, 4x4 ~0 at these sizes)
HEADLINE_IMAGE_SIZE = (480, 640)
HEADLINE_FOCAL = 580.0


def headline_tier_caps(num_faces: int) -> dict:
    return {"quad_cap": max(4096, num_faces // 32), "hex_cap": max(4096, num_faces // 512),
            "oct_cap": 2048, "max_large_faces": 512}


def uv_sphere(rings: int, segments: int, radius: float, center) -> tuple[np.ndarray, np.ndarray]:
    """-> (verts f32[V, 3], faces int32[F, 3]) with F = 2 * segments * (rings - 1)."""
    phi = np.linspace(0, np.pi, rings + 1)[1:-1]
    theta = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    ring_pts = np.stack([np.sin(pp) * np.cos(tt), np.sin(pp) * np.sin(tt), np.cos(pp)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.0]], ring_pts, [[0, 0, -1.0]]], 0) * radius + np.asarray(center)
    n_ring = rings - 1
    faces = []
    top, bottom = 0, 1 + n_ring * segments
    ring0 = 1
    for s in range(segments):
        faces.append([top, ring0 + s, ring0 + (s + 1) % segments])
    for r in range(n_ring - 1):
        a = ring0 + r * segments
        b = a + segments
        for s in range(segments):
            s1 = (s + 1) % segments
            faces.append([a + s, b + s, b + s1])
            faces.append([a + s, b + s1, a + s1])
    last = ring0 + (n_ring - 1) * segments
    for s in range(segments):
        faces.append([bottom, last + (s + 1) % segments, last + s])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def build_scene(grid: int = 8, rings: int = 149, segments: int = 236) -> tuple[np.ndarray, np.ndarray]:
    """64 UV spheres of 2 * segments * (rings - 1) faces (4,470,784 in all,
    2,235,520 vertices) in a grid facing the camera, 4.0-4.2 m away."""
    base_v, base_f = uv_sphere(rings, segments, 0.22, (0, 0, 0))
    half = (grid - 1) / 2
    verts_all, faces_all = [], []
    for i in range(grid):
        for j in range(grid):
            center = np.asarray([(j - half) * 0.5, (i - half) * 0.5, 4.0 + 0.1 * ((i + j) % 3)], np.float32)
            faces_all.append(base_f + len(base_v) * len(verts_all))
            verts_all.append(base_v + center)
    return np.concatenate(verts_all), np.concatenate(faces_all)


def device_busy_ms(events) -> float:
    """Summed device time of the kernel rows of ``key_averages()`` (operator
    rows and the spans' ranges would count their kernels twice)."""
    return sum(
        device_us(e) for e in events
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and not e.key.startswith(trace.PREFIX)
    ) / 1e3


def odometry_row(previous_depth, depth, intrinsics, params) -> dict:
    """The rigid odometry stage alone on one depth pair: device time of its
    kernels, its kernel launches and its costliest kernels (one traced call),
    and CUDA-event time per call (after warm-up)."""

    def call():
        return rigid_odometry_multi_scale(
            previous_depth, depth, intrinsics,
            depth_scale=params.fusion.depth_scale, depth_max=params.fusion.far_clip_distance,
        )

    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        call()
    end.record()
    torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -device_us(e))[:5]
    return {
        "device_ms": device_busy_ms(events),
        "event_ms": start.elapsed_time(end) / 5,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "device_ms": device_us(e) / 1e3, "calls": e.count} for e in top],
    }


def _timed_frame(pipe, frame) -> float:
    t0 = time.perf_counter()
    pipe.process_frame(frame.depth, frame.color)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4, help="warm-up frames before the traced one")
    ap.add_argument("--out", type=Path, default=None, help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA card")
    use_fp32_matmuls()
    params, seq = make_slice(args.frames + 2)
    frames = list(seq)
    pipe = FusionPipeline(params, seq.intrinsics)
    pipe.initialize(frames[0].depth, frames[0].color)
    for f in frames[1:-1]:
        pipe.process_frame(f.depth, f.color)
    torch.cuda.synchronize()
    # the same frame from the same state, untraced: the profiler's own host
    # cost stretches the traced frame's wall time
    previous_depth = pipe.previous_depth
    untraced_s = _timed_frame(copy.deepcopy(pipe), frames[-1])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    trace.reset()
    trace.enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            wall_s = _timed_frame(pipe, frames[-1])
    finally:
        trace.enable(False)
    host = trace.snapshot()
    device = trace.read_profile(prof.events())
    spans = {
        name: {"device_ms": device["device_ms"].get(name, 0.0), "launches": device["launches"].get(name, 0),
               "self_host_ms": row["self_ms"], "idle_ms": device["idle_ms"].get(name, 0.0), "calls": row["calls"]}
        for name, row in sorted(host["spans"].items(), key=lambda kv: -kv[1]["self_ms"])
    }
    events = prof.key_averages()
    rows = sorted(
        ({"name": e.key, "device_ms": device_us(e) / 1e3, "calls": e.count} for e in events),
        key=lambda r: -r["device_ms"],
    )
    kernel_rows = [r for r in rows if r["device_ms"] > 0 and not r["name"].startswith(trace.PREFIX)]
    busy_ms = device_busy_ms(events)
    odometry = odometry_row(previous_depth, pipe.previous_depth, pipe.intrinsics, params)
    hand = {
        k: {"device_ms_per_launch": r["device_ms"] / max(r["calls"], 1), "launches": r["calls"]}
        for k in HAND_KERNELS
        for r in rows
        if k in r["name"]
    }
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "frame_trace.json"))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip(),
        "frame_wall_ms": untraced_s * 1e3,
        "traced_frame_wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (untraced_s * 1e3),
        "traced_device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "hand_kernels": hand,
        "rigid_odometry": odometry,
        "spans": spans,
        "idle_outside_spans_ms": device["idle_ms"].get("none", 0.0),
        "counters": host["counters"],
        "top_device_ops": kernel_rows[:25],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
