#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing one JSON line (and raising, so the script exits
non-zero, on any failure):
  1. build: compile the hand-written kernels (csrc/*.cu) with nvcc, one
     process per source, and print the card's name and power limit;
  2. main path: the port's FusionPipeline on the slice that
     dynamicfuion_python_tpu_torch/apps/profile_frame.py defines (synthetic
     bending plane at 480x640, focal 672, the DeepDeform sensor resolution;
     default Parameters, rigid odometry on, with capacity overrides only:
     mesh capacity 65536, block table 4096 and 2048 active blocks so the
     scene fits), frame 0 + 5 fitted frames; every GN iteration must go
     through the three kernels, and odometry must run on every frame from 2 on;
     then the same frames from a fresh pipeline must leave the same bits
     (nodes, rotations, translations, the TSDF values and weights of the
     occupied blocks, the canonical mesh; both digests printed);
  3. kernels: each kernel against its plain PyTorch version on the inputs
     of the main path's last launch (the warped mesh of the last frame's
     last GN iteration; for the face data term's rows, phase 7's inputs,
     which must give the plain rows, segments, weights and residuals bit for
     bit), timed with CUDA events and the profiler beside its bound (counted
     from those inputs) and, for B1 and B2, an empty kernel's launch floor
     on the kernel's own grid;
  4. odometry: rigid_odometry_multi_scale on the card, under
     torch.cuda.set_sync_debug_mode("error"), on the main path's last depth
     pair and on a 480x640 wavy surface moved by a known rotation and
     translation; the card must equal the CPU and recover the motion;
  5. entry point: the CLI runs 4 frames of the slice with telemetry, and
     run_fusion resumes from a checkpoint to the full run's result;
  6. reference: a small 3-frame scene (odometry on frame 2) through the
     kernels on the card and through the plain versions on the CPU must
     agree;
  7. data terms: the fitter's "face", "fast" and "autodiff" data terms on
     the main path's first GN inputs (frame 1 from the identity warp, the
     same in every run: their digest is printed) must agree (the JAX
     package's parity tolerances), each timed with CUDA events;
  8. neural prior: the 448x640 shifted plane (3 frames, 8 cm per frame, its
     oracle flow, rigid odometry off) twice, FIRST_TO_CURRENT with Euclidean
     pixel anchors and PREVIOUS_TO_CURRENT with shortest-path anchors: the
     prior must be valid with > 1000 matches on every fitted frame, every GN
     solve valid and the median node x-translation within 2 cm of the
     cumulative shift;
  9. DeformNet: the 448x640 bending plane (rigid odometry on) with the prior
     loading a seeded DeformNet checkpoint: the network must run on every
     fitted frame, every output be finite, and its forward on the card equal
     its forward on the CPU; the same run from a fresh pipeline must repeat
     DeformNet's outputs (the point-cloud GN's node transforms among them)
     and the fitted nodes bit for bit; the forward, its point-cloud GN and
     the prior's share of the frame are timed;
 10. renderer: MeshRenderer on the main path's final warped canonical mesh
     at 480x640 (bins of 1024 faces) against the same render with both
     kernels replaced by their plain versions on the card: face ids equal,
     depth and color within 1e-5, no bin or large-face drops; ms per render,
     B1's device ms at this bin capacity beside its bound, bin statistics;
 11. rendered prior: the 448x640 bending plane with the seeded DeformNet in
     RENDERED_WITH_PREVIOUS_FRAME_OVERLAY with the rendered-mesh recorder
     on (3 frames), then the 448x640 shifted plane in RENDERED_ONLY with its
     oracle flow (PREVIOUS_TO_CURRENT, so the rendered model is the
     keyframe's state): finite metrics, both PNGs of each fitted frame
     written and readable at 448x640, the slide recovered (median node x
     within 2 cm); the rendered source depth against the keyframe's and the
     prior's share of the frame reported;
 12. volume read-out: the main path's final volume ray-cast at 480x640 with
     normals and colors under torch.cuda.set_sync_debug_mode("error"), its
     welded mesh rendered by MeshRenderer (median |ray-cast depth - rendered
     depth| under one voxel), marching tetrahedra against marching cubes,
     sample_tsdf on the card equal to the CPU's within 1e-5;
 13. indexed: the reference's headline scene (64 spheres, 4,470,784 faces,
     480x640) through rasterize_indexed (B2 on the plan's sorted faces, the
     splat, the id remap) and through rasterize_splat on the faces expanded
     in the caller's order, with the rasterizer bench's tier caps: no drops,
     face ids equal but at equal-depth ties, depths within 1e-5; B2 held to
     its plain version at this size, its device ms beside its byte bound;
 14. train: DeformNet training. A DeepDeform-layout split of 4 pairs
     (480x640 shifted and bending patches, PNG frames, closed-form flows)
     under a temporary directory, its graphs and labels from
     create_graph_data.main; train(labeled=True) at stage 1_solver at the JAX
     train()'s defaults (448x640 crop, batch 4, 128 nodes, 10,000 matches,
     3 GN iterations, SGD momentum 0.9), 5 steps of one repeated batch at lr
     1e-4: finite losses, the last below the first, the checkpoint reloads
     bit-equal, the eval step's metrics finite, and the same run again
     leaves the same weights (state_dict digests equal); one step each of
     0_flow, 2_mask (flow net bit-equal) and 3_refine, each trained net
     moving; generate -> evaluate over the split, every metric finite (None
     only where no pair has a valid node); one 1_solver step at 192x256,
     batch 1, on the card and on the CPU from the same weights and batch
     with TF32 turned on globally beforehand: gradient hooks must read TF32
     off for cuBLAS and cuDNN and cuDNN deterministic throughout the step's
     backward (and TF32 on in the control's), the loss and the gradients'
     relative L2 difference within TRAIN_LOSS_RTOL / TRAIN_GRAD_RTOL; that
     step and a 3_refine step each run twice on the card must repeat their
     loss and every gradient bit for bit, and the graph of a card step must
     hold the fixed-order gathers and upsampling (its backward node types
     and counts printed). Printed, never gated: step, forward and backward
     ms (CUDA events), data seconds per batch, peak memory, the GN's share
     of the backward, one traced step and the same step with TF32 left on
     (a control).
 15. sod: apps/sod.py's generate_masks with the reference's default model
     (U2NET at full width, seeded weights, 320x320 input) over four 480x640
     PNG colour frames in a temporary directory, TF32 turned on globally
     beforehand: every mask written as uint8 480x640, forward hooks reading
     TF32 off for cuBLAS and cuDNN in every card forward, the fused output
     on the card equal to the CPU's within 1e-4, the weights through a Flax
     .npz and back bit for bit; ms per frame, the forward's event ms, peak
     memory;
 16. leaf ops: on the main path's last 480x640 point cloud and its last
     arrowhead system, card against CPU: mean / median grid sampling at the
     node coverage and the voxel size (counts and indices equal, means
     within 1e-6), the block-COO products (the system times its gradient,
     and B^T B on the corner's pattern) within 1e-5 of their scale, and
     point-to-plane distances within 1e-6; ms for each;
 17. spmd: two ranks spawned on the one card (gloo on CUDA tensors, a
     FileStore rendezvous in a temporary directory, a deadline): first the
     data term and one GN step on phase 7's fixed inputs against one
     process (H and g within phase 7's bounds, translations within 1e-5);
     then enable_spmd on the main path's slice for 3 fitted frames against
     the single-process port run three times (bit-equal, spread 0): node
     translations within 1e-3 m of the first run, every solve
     valid, the data loss falling and the occupied blocks equal each frame,
     both kernels launched in both ranks; frame wall time for 1 and 2 ranks.
Phases 2, 8-15 and 17 each set the kernels' launch counts to 0 before they
drive their path and read them after: every kernel of a path must have
launched in it (phases 10 and 12 render without fitting: B1 and B2 only;
phase 13's path runs B2 only: its splat is plain PyTorch; phase 14's runs
none, training rasterizes nothing, nor do phases 15 and 16: SOD and the
leaf ops rasterize nothing either). Each phase prints a start line
first. The kernels line (phase 3's measurements, each path's launch counts
and the new shapes' times) comes next, and the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the checkout stays as git wrote it: no __pycache__ beside the sources
sys.dont_write_bytecode = True

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 outside the
# tensor cores. Built with --fmad=false, the kernels' FP32 issue ceiling is
# half the latter, 33.5 T instructions/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# per face of the expansion: 3 corners x (2 divisions, 2 multiplies, 2 adds)
EXPAND_OPS_PER_FACE = 18
# the kernels a path that rasterizes without fitting launches (renderer, ray
# cast read-out); the fitter's paths launch every kernel of native.KERNELS
RASTER_KERNELS = ("rasterize_tiles", "mesh_expand")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def reset_counters() -> None:
    """Zero the port's counters (``utils/trace.py``), B1's and B2's
    launches among them."""
    from dynamicfuion_python_tpu_torch.utils import trace

    trace.reset()


def kernel_launches() -> dict:
    """The kernels' launches (B1, B2, the face data term's rows) since the
    counters were last zeroed."""
    from dynamicfuion_python_tpu_torch.utils import trace

    return {"rasterize_tiles": trace.counter("b1.launches"), "mesh_expand": trace.counter("b2.launches"),
            "face_data_rows": trace.counter("face_rows.launches")}


def pose_summary(extrinsics) -> dict:
    """A 4x4 camera pose's translation norm, rotation angle (rad) and the
    largest entry of R R^T - I."""
    import torch

    t = extrinsics.detach().double().cpu()
    rot = t[:3, :3]
    cos = torch.clamp((torch.trace(rot) - 1.0) / 2.0, -1.0, 1.0)
    return {
        "translation_norm": float(torch.linalg.norm(t[:3, 3])),
        "rotation_angle": float(torch.arccos(cos)),
        "orthonormality_err": float((rot @ rot.T - torch.eye(3, dtype=torch.float64)).abs().max()),
    }


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_launch(fns: dict, iters: int) -> dict:
    """Profiler device time per launch of each named kernel, each run
    ``iters`` times by its function; None where the trace has no device
    time for it."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.profile_frame import device_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns.values():
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in fns:
        rows = [e for e in events if name in e.key and device_us(e) > 0]
        calls = sum(e.count for e in rows)
        out[name] = sum(device_us(e) for e in rows) / 1e3 / calls if calls else None
    return out


def _snapshot(value):
    """``value`` with every tensor in it (inside tuples, lists and named
    tuples too) cloned, so later in-place updates leave it as it was."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*[_snapshot(v) for v in value])
    if isinstance(value, (tuple, list)):
        return type(value)(_snapshot(v) for v in value)
    return value


def tensor_digest(values) -> str:
    """SHA-1 over the bytes of every tensor in ``values`` (in order): equal
    digests mean bit-equal inputs."""
    import hashlib

    import torch

    digest = hashlib.sha1()

    def add(value):
        if isinstance(value, torch.Tensor):
            digest.update(str((value.dtype, tuple(value.shape))).encode())
            digest.update(value.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(value, (tuple, list)):
            for v in value:
                add(v)

    add(values)
    return digest.hexdigest()


def _flat_tensors(value) -> list:
    """Every tensor in ``value`` (inside tuples, lists and named tuples too),
    in order."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _flat_tensors(v)]
    return []


def bit_equal(a, b) -> bool:
    """The same tensors, bit for bit (NaN equal to the same NaN)."""
    import torch

    a, b = _flat_tensors(a), _flat_tensors(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.detach().reshape(-1).view(torch.uint8), y.detach().reshape(-1).view(torch.uint8))
        for x, y in zip(a, b))


class LastCall:
    """Replaces ``module.name`` (or ``module[name]`` of a dict) by a function
    that records the arguments of its last call and counts its calls, then
    calls the original; :meth:`restore` puts it back. With ``keep_first`` it
    also keeps a copy of its first call's arguments (``first_args``)."""

    def __init__(self, module, name: str, keep_first: bool = False):
        self.module, self.name = module, name
        self.fn = module[name] if isinstance(module, dict) else getattr(module, name)
        self.args, self.kwargs = None, None
        self.first_args = None
        self.keep_first = keep_first
        self.calls = 0
        self._set(self)

    def _set(self, fn) -> None:
        if isinstance(self.module, dict):
            self.module[self.name] = fn
        else:
            setattr(self.module, self.name, fn)

    def __call__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        if self.keep_first and self.calls == 0:
            self.first_args = _snapshot(args)
        self.calls += 1
        return self.fn(*args, **kwargs)

    def restore(self) -> None:
        self._set(self.fn)


class Timed:
    """Wraps a callable; each call is bracketed by ``cuda.synchronize()`` and
    its host seconds appended to :attr:`seconds`."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds: list[float] = []

    def __call__(self, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want| (1e-12 at least)."""
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def violations(got, want, rtol: float, atol: float) -> int:
    """Entries with |got - want| > atol + rtol |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def phase_build():
    import torch

    from dynamicfuion_python_tpu_torch.apps.profile_frame import use_fp32_matmuls
    from dynamicfuion_python_tpu_torch.ops import native

    use_fp32_matmuls()
    t0 = time.perf_counter()
    reports = native.build_kernels()
    build_s = time.perf_counter() - t0
    # ptxas resource lines: registers, shared memory, spills per kernel
    ptxas = {
        name: [ln.split("info    :")[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        for name, log in reports.items()
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({
        "phase": "build", "seconds": build_s, "kernels": sorted(native.KERNELS),
        "built_now": sorted(reports), "ptxas": ptxas, "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return smi


def phase_main_path():
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops import native, rasterize, rigid_odometry

    params, seq = make_slice(frame_count=6)
    check(params.alignment.use_rigid_alignment, "the slice must run the default rigid odometry")
    frames = list(seq)
    torch.cuda.reset_peak_memory_stats()
    # the inputs of each kernel's last launch, for phase 3: the fitter's B2
    # call and rasterize_binned's B1 call; the odometry's calls (counted per
    # frame) and last depth pair, for phase 4; the data term's first inputs
    # (frame 1, from the identity warp), for phase 7
    # the first GN step's inputs and the last solve's arrowhead system, for
    # phases 16 and 17
    last = {"mesh_expand": LastCall(fitter, "expand_project_faces"),
            "rasterize_tiles": LastCall(rasterize, "rasterize_tiles"),
            "odometry": LastCall(rigid_odometry, "rigid_odometry_multi_scale"),
            "data_term": LastCall(fitter._DATA_TERMS, "face", keep_first=True),
            "gn_step": LastCall(fitter, "gauss_newton_step", keep_first=True),
            "arrowhead": LastCall(fitter, "solve_block_sparse_arrowhead")}
    reset_counters()
    pipe = FusionPipeline(params, seq.intrinsics)  # the default device: the card
    t0 = time.perf_counter()
    pipe.initialize(frames[0].depth, frames[0].color)
    torch.cuda.synchronize()
    emit({
        "phase": "main_path", "frame": 0, "wall_s": time.perf_counter() - t0,
        "nodes": pipe.warp_field.num_nodes, "layers": list(pipe.warp_field.layer_node_counts),
        "triangles": pipe.canonical_triangle_count, "vertices": pipe._count_host[0],
    })
    per_frame = []
    for f in frames[1:]:
        odometry_calls = last["odometry"].calls
        t0 = time.perf_counter()
        m = pipe.process_frame(f.depth, f.color)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        occupied = int(pipe.volume.occupied_count())
        row = {
            "phase": "main_path", "frame": f.index, "wall_s": wall,
            "odometry_ran": last["odometry"].calls > odometry_calls, "rigid_rmse": m["rigid_rmse"],
            **pose_summary(pipe.extrinsics),
            "data_loss": m["data_loss"], "arap_loss": m["arap_loss"],
            "valid_solve": m["valid_solve"], "active_blocks": m["active_blocks"],
            "max_active_blocks": params.tsdf.max_active_blocks,
            "occupied_blocks": occupied, "block_capacity": pipe.volume.capacity,
            "dropped_bin_entries": m["dropped_bin_entries"],
            "dropped_large_faces": m["dropped_large_faces"],
            "pixel_cap_kept_fraction": m["pixel_cap_kept_fraction"],
            "triangles": pipe.canonical_triangle_count, "vertices": pipe._count_host[0],
            "nodes": pipe.warp_field.num_nodes,
            "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
        }
        emit(row)
        per_frame.append(row)
    launches = kernel_launches()
    for rec in last.values():
        rec.restore()
    for row in per_frame:
        check(row["odometry_ran"] == (row["frame"] >= 2),
              f"frame {row['frame']}: odometry ran {row['odometry_ran']}, expected from frame 2 on")
        check(math.isfinite(row["rigid_rmse"]) and row["rigid_rmse"] < 0.07,
              f"frame {row['frame']}: rigid rmse {row['rigid_rmse']} not finite or >= 0.07")
        check(row["orthonormality_err"] <= 1e-4,
              f"frame {row['frame']}: pose rotation off orthonormal by {row['orthonormality_err']}")
        check(all(row["valid_solve"]), f"frame {row['frame']}: a GN solve was invalid")
        check(row["data_loss"][-1] < row["data_loss"][0], f"frame {row['frame']}: data loss did not fall")
        check(0 < row["active_blocks"] <= row["max_active_blocks"],
              f"frame {row['frame']}: active blocks {row['active_blocks']} outside (0, max_active_blocks]")
        check(row["occupied_blocks"] < row["block_capacity"], f"frame {row['frame']}: block table full")
        check(not any(row["dropped_bin_entries"]) and not any(row["dropped_large_faces"]),
              f"frame {row['frame']}: rasterizer overflow")
    for name in native.KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    verts = pipe.canonical_vertices
    check(bool(torch.isfinite(verts).all()) and bool(torch.isfinite(pipe.warp_field.node_translations).all()),
          "non-finite canonical mesh or node translations")
    emit({
        "phase": "main_path", "summary": True, "launches": launches, "fitted_frames": len(per_frame),
        "odometry_calls": last["odometry"].calls,
        "mean_frame_s": sum(r["wall_s"] for r in per_frame) / len(per_frame),
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
    })
    # the same path again from a fresh pipeline (after the launch counts are
    # read): every float sum has a fixed order, so it repeats bit for bit
    again = FusionPipeline(params, seq.intrinsics)
    again.initialize(frames[0].depth, frames[0].color)
    for f in frames[1:]:
        again.process_frame(f.depth, f.color)
    torch.cuda.synchronize()
    first, second = _main_path_state(pipe), _main_path_state(again)
    equal = {k: bit_equal(first[k], second[k]) for k in first}
    emit({"phase": "main_path", "repeat": True, "bit_equal": equal,
          "digests": [tensor_digest(list(first.values())), tensor_digest(list(second.values()))]})
    check(all(equal.values()), f"main path: a second run differs ({equal})")
    return last, launches, len(per_frame), pipe


def _main_path_state(pipe) -> dict:
    """What a run of the main path leaves: the nodes and their transforms,
    the TSDF values and weights of the occupied (every active) block, and
    the canonical mesh."""
    field, volume = pipe.warp_field, pipe.volume
    occupied = volume.occupied_mask()
    return {
        "node_positions": field.node_positions, "node_rotations": field.node_rotations,
        "node_translations": field.node_translations, "block_keys": volume.slot_keys,
        "tsdf": volume.tsdf[occupied], "weight": volume.weight[occupied],
        "mesh_vertices": pipe.canonical_vertices, "mesh_triangles": pipe.canonical_triangles,
    }


def phase_kernels(last, launches, fitted_frames):
    import torch

    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops import face_data_rows as fr
    from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
    from dynamicfuion_python_tpu_torch.ops import rasterize as rz

    # B2 on the warped mesh of the last GN iteration
    b2 = last["mesh_expand"]
    verts, tris, k = b2.args
    fv, valid = me.expand_project_faces_cuda(*b2.args, **b2.kwargs)
    pfv, pvalid = me.expand_project_faces_plain(*b2.args, **b2.kwargs)
    torch.cuda.synchronize()
    check(torch.equal(valid, pvalid), "mesh_expand: clip mask differs from the plain version")
    b2_err = float((fv - pfv).abs().max())
    check(b2_err == 0.0, f"mesh_expand: not bit-equal to the plain version (max err {b2_err})")
    n_faces, n_verts = tris.shape[0], verts.shape[0]
    b2_ms = cuda_time_ms(lambda: me.expand_project_faces_cuda(*b2.args, **b2.kwargs), 200)
    b2_plain = cuda_time_ms(lambda: me.expand_project_faces_plain(*b2.args, **b2.kwargs), 50)
    b2_grid = me.expand_grid(n_faces)
    floor_ms = cuda_time_ms(lambda: me.launch_floor(*b2_grid, verts.device), 200)
    b2_bytes = n_verts * 12 + n_faces * 12 + 36 + n_faces * 36 + n_faces
    b2_ops = n_faces * EXPAND_OPS_PER_FACE
    b2_bound = max(b2_bytes / PEAK_BYTES_PER_S, b2_ops / PEAK_FP32_PER_S) * 1e3

    # B1 on the same iteration's bins
    b1 = last["rasterize_tiles"]
    faces, table, image_size, tile_size = b1.args
    got = rz.rasterize_tiles_cuda(*b1.args, **b1.kwargs)
    want = rz.rasterize_tiles_plain(*b1.args, **b1.kwargs)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), "rasterize_tiles: face ids differ from the plain version")
    b1_err = max(float((g - x).abs().max()) for g, x in zip(got[1:], want[1:]))
    check(b1_err <= 1e-5, f"rasterize_tiles: max abs err {b1_err} > 1e-5")
    b1_ms = cuda_time_ms(lambda: rz.rasterize_tiles_cuda(*b1.args, **b1.kwargs), 100)
    b1_plain = cuda_time_ms(lambda: rz.rasterize_tiles_plain(*b1.args, **b1.kwargs), 5, warmup=1)
    blur = b1.kwargs.get("blur_radius", 0.0)
    work = rz.rasterize_tiles_work(faces, table, image_size, tile_size, blur)
    b1_bound = max(work["bytes"] / PEAK_BYTES_PER_S, work["operations"] / PEAK_FP32_PER_S) * 1e3
    occupancy = rz.rasterize_tiles_occupancy(tile_size)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b1_grid = rz.rasterize_tiles_grid(table.shape[0], tile_size)
    b1_floor_ms = cuda_time_ms(lambda: me.launch_floor(*b1_grid, verts.device), 200)

    device_ms = device_ms_per_launch({
        "rasterize_tiles_kernel": lambda: rz.rasterize_tiles_cuda(*b1.args, **b1.kwargs),
        "mesh_expand_kernel": lambda: me.expand_project_faces_cuda(*b2.args, **b2.kwargs),
    }, 50)
    # the empty kernel on each grid, traced apart: both launches share its name
    floor_device_ms = {
        name: device_ms_per_launch({"launch_floor_kernel": lambda g=grid: me.launch_floor(*g, verts.device)}, 50)[
            "launch_floor_kernel"
        ]
        for name, grid in (("rasterize_tiles", b1_grid), ("mesh_expand", b2_grid))
    }
    # the face data term's rows on the main path's first GN inputs (phase 7's)
    args = last["data_term"].first_args
    call = fitter._face_row_inputs(*args)
    fr_got = fr.face_data_rows_cuda(*call)
    fr_want = fitter._face_rows_plain(*call)
    torch.cuda.synchronize()
    fr_equal = {name: bool(torch.equal(a, b)) for name, a, b in zip(("rows", "seg", "weight", "residuals"),
                                                                      fr_got, fr_want)}
    check(all(fr_equal.values()), f"face_data_rows: not bit-equal to the plain rows on phase 7's inputs ({fr_equal})")
    del fr_got, fr_want
    fr_ms = cuda_time_ms(lambda: fr.face_data_rows_cuda(*call), 50)
    fr_plain = cuda_time_ms(lambda: fitter._face_rows_plain(*call), 5, warmup=1)
    f_tris, _, face_nodes, slots, frag, _, mask = call[5:12]
    fr_work = fr.face_data_rows_work(f_tris, face_nodes, slots, frag, mask, *call[14:16])
    fr_bound = fr_work["bytes"] / PEAK_BYTES_PER_S * 1e3
    fr_device_ms = device_ms_per_launch({"face_data_rows_kernel": lambda: fr.face_data_rows_cuda(*call)}, 20)

    occ = (table >= 0).sum(1)
    emit({
        "phase": "kernels", "faces": n_faces, "vertices": n_verts, "image_size": list(image_size),
        "tiles": table.shape[0], "bin_capacity": table.shape[1], "bin_entries": work["entries"],
        "mean_bin_occupancy": work["entries"] / table.shape[0], "max_bin_occupancy": int(occ.max()),
        "visible_pixels": int((got[0] >= 0).sum()),
        "b1_blocks_per_sm": occupancy, "sms": sms, "b1_waves": table.shape[0] / (occupancy * sms),
        "b1_grid": list(b1_grid), "b2_grid": list(b2_grid),
        "b1_launch_floor_ms": b1_floor_ms, "b2_launch_floor_ms": floor_ms,
        "launch_floor_device_ms": floor_device_ms,
    })
    kernels = [
        {
            "name": "rasterize_tiles", "route": "cuda",
            "source": "dynamicfuion_python_tpu_torch/csrc/rasterize_tiles.cu",
            "replaces": "dynamicfuion_python_tpu/ops/pallas/rasterize_tiles.py:185",
            "launches": launches["rasterize_tiles"],
            "launches_per_frame": launches["rasterize_tiles"] / fitted_frames,
            "max_abs_err": b1_err, "ms": b1_ms, "device_ms": device_ms["rasterize_tiles_kernel"],
            "plain_ms": b1_plain, "bound_ms": b1_bound,
            "bound_by": "bytes" if work["bytes"] / PEAK_BYTES_PER_S > work["operations"] / PEAK_FP32_PER_S else "operations",
            "launch_floor_device_ms": floor_device_ms["rasterize_tiles"],
            "tests": work["tests"], "tile_tests": work["tile_tests"],
            "distinct_faces": work["distinct_faces"],
            "operations": work["operations"], "bytes": work["bytes"],
            "library_ms": None,
        },
        {
            "name": "mesh_expand", "route": "cuda",
            "source": "dynamicfuion_python_tpu_torch/csrc/mesh_expand.cu",
            "replaces": "dynamicfuion_python_tpu/ops/pallas/mesh_expand.py:178",
            "launches": launches["mesh_expand"],
            "launches_per_frame": launches["mesh_expand"] / fitted_frames,
            "max_abs_err": b2_err, "ms": b2_ms, "device_ms": device_ms["mesh_expand_kernel"],
            "plain_ms": b2_plain, "bound_ms": b2_bound,
            "bound_by": "bytes" if b2_bytes / PEAK_BYTES_PER_S > b2_ops / PEAK_FP32_PER_S else "operations",
            "launch_floor_device_ms": floor_device_ms["mesh_expand"],
            "operations": b2_ops, "bytes": b2_bytes,
            "library_ms": None,
        },
        {
            "name": "face_data_rows", "route": "cuda",
            "source": "dynamicfuion_python_tpu_torch/csrc/face_data_rows.cu",
            "replaces": "models/fitter.py::_face_rows_plain (plain PyTorch; no TPU kernel)",
            "launches": launches["face_data_rows"],
            "launches_per_frame": launches["face_data_rows"] / fitted_frames,
            "pixels": fr_work["pixels"], "faces": fr_work["faces"], "nodes": fr_work["nodes"],
            "bit_equal": fr_equal, "inputs_sha1": tensor_digest(list(args)),
            "ms": fr_ms, "device_ms": fr_device_ms["face_data_rows_kernel"],
            "plain_ms": fr_plain, "bound_ms": fr_bound, "bound_by": "bytes", "bytes": fr_work["bytes"],
            "library_ms": None,
        },
    ]
    return kernels


def wavy_motion_scene(height: int = 480, width: int = 640):
    """The wavy surface of the JAX package's odometry tests at 4x their
    120x160 resolution (same geometry: focal and wavelengths scaled), and
    the same surface moved by a 0.01 rad rotation about y plus 1 cm along z,
    splatted to its nearest pixels. Returns (source depth, target depth,
    intrinsics, the motion as a 4x4) on the CPU."""
    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.ops.camera import project_points, unproject_depth_image
    from dynamicfuion_python_tpu_torch.ops.linalg import axis_angle_to_matrix

    scale = width / 160
    k = torch.tensor([[160.0 * scale, 0.0, width / 2], [0.0, 160.0 * scale, height / 2], [0.0, 0.0, 1.0]])
    v, u = np.mgrid[0:height, 0:width].astype(np.float32)
    z = 1.2 + 0.08 * np.sin(u / (12 * scale)) * np.cos(v / (12 * scale))
    source = torch.as_tensor((z * 1000).astype(np.uint16).astype(np.int32))
    motion = torch.eye(4)
    motion[:3, :3] = axis_angle_to_matrix(torch.tensor([0.0, 0.01, 0.0]))
    motion[2, 3] = 0.01
    pts, mask = unproject_depth_image(source, k, 1000.0, 5.0)
    moved = pts.reshape(-1, 3) @ motion[:3, :3].T + motion[:3, 3]
    uv, _ = project_points(moved, k)
    pu = torch.round(uv[:, 0]).long().numpy()
    pv = torch.round(uv[:, 1]).long().numpy()
    ok = mask.reshape(-1).numpy() & (pu >= 0) & (pu < width) & (pv >= 0) & (pv < height)
    target = np.zeros((height, width), np.float32)
    target[pv[ok], pu[ok]] = moved[:, 2].numpy()[ok] * 1000
    return source, torch.as_tensor(target.astype(np.uint16).astype(np.int32)), k, motion


def phase_odometry(odometry_call):
    """Rigid odometry on the card: sync-free, equal to the CPU, and right on
    a known motion."""
    import torch

    from dynamicfuion_python_tpu_torch.ops.rigid_odometry import rigid_odometry_multi_scale

    source, target, k, motion = wavy_motion_scene()
    prev, cur, intr = odometry_call.args
    cases = {
        "main_path_last_pair": ((prev, cur, intr), odometry_call.kwargs),
        "wavy_rotation_y_0.01_z_1cm": ((source, target, k), {}),
    }
    out = {"phase": "odometry"}
    for name, (args, kwargs) in cases.items():
        card_args = [a.cuda() for a in args]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # any host sync in the call raises
        try:
            card_t, card_rmse = rigid_odometry_multi_scale(*card_args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu_t, cpu_rmse = rigid_odometry_multi_scale(*[a.cpu() for a in args], **kwargs)
        err_t = float((card_t.cpu() - cpu_t).abs().max())
        err_rmse = abs(float(card_rmse) - float(cpu_rmse))
        check(err_t <= 1e-4 and err_rmse <= 1e-4,
              f"odometry {name}: card differs from the CPU (transform {err_t}, rmse {err_rmse})")
        ms = cuda_time_ms(lambda: rigid_odometry_multi_scale(*card_args, **kwargs), 10, warmup=2)
        row = {"transform_card_vs_cpu": err_t, "rmse_card_vs_cpu": err_rmse, "rmse": float(card_rmse),
               "ms_per_call": ms, **pose_summary(card_t)}
        if name.startswith("wavy"):
            got = card_t.cpu()
            row["rotation_err"] = float((got[:3, :3] - motion[:3, :3]).abs().max())
            row["translation_err"] = float((got[:3, 3] - motion[:3, 3]).abs().max())
            # the JAX package's odometry tests' gates: 3e-3 on the rotation,
            # 2e-3 m on the translation
            check(row["rotation_err"] <= 3e-3 and row["translation_err"] <= 2e-3,
                  f"odometry {name}: motion not recovered ({row['rotation_err']}, {row['translation_err']})")
        out[name] = row
    emit(out)


def phase_entry_point():
    """The CLI with telemetry on the slice, and run_fusion's checkpoint and
    resume, on the card."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import main, run_fusion
    from dynamicfuion_python_tpu_torch.apps.profile_frame import SLICE_IMAGE_SIZE, SLICE_OVERRIDES, make_slice
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    h, w = SLICE_IMAGE_SIZE  # the CLI's synthetic focal, min(h, w) * 1.4, is the slice's
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "telemetry"
        t0 = time.perf_counter()
        result = main([
            "--sequence", "synthetic", "--frames", "4", "--size", f"{h}x{w}", *SLICE_OVERRIDES,
            f"telemetry.output_directory={out}", "telemetry.print_runtime=false",
        ])
        cli_s = time.perf_counter() - t0
        runs = list(out.iterdir())
        check(len(runs) == 1, f"the CLI wrote {len(runs)} run directories")
        metrics = json.loads((runs[0] / "metrics.json").read_text())
        plys = sorted(p.name for p in runs[0].glob("*.ply"))
        check(metrics["frame_count"] == 4 and len(plys) == 6,
              f"CLI telemetry: {metrics['frame_count']} frames, PLY files {plys}")
        check(all(all(f["valid_solve"]) for f in metrics["frames"][1:]), "CLI: a GN solve was invalid")

        params, seq = make_slice(frame_count=3)
        params = apply_overrides(params, [f"telemetry.output_directory={out}", "telemetry.print_runtime=false"])
        ckpt = Path(tmp) / "checkpoint"
        full = run_fusion(seq, params, run_name="full", checkpoint_dir=str(ckpt), checkpoint_every=2)
        resumed = run_fusion(seq, params, run_name="resumed", checkpoint_dir=str(ckpt), resume=True)
        check(resumed.summary["frame_count"] == 1, "resume: expected one frame after the checkpoint")
        err = float((resumed.warp_field.node_translations - full.warp_field.node_translations).abs().max())
        check(err <= 1e-4, f"resume: node translations differ from the full run by {err}")
        torch.cuda.synchronize()
    emit({
        "phase": "entry_point", "cli_s": cli_s, "cli_frames": metrics["frame_count"],
        "cli_triangles": len(result.canonical_mesh), "ply_files": len(plys),
        "resume_max_translation_diff": err, "resumed_frames": resumed.summary["frame_count"],
    })


def phase_reference():
    """A small scene through the kernels on the card and through the plain
    versions on the CPU: the same losses, validity, block counts and camera
    pose (frame 2 runs odometry)."""
    import dataclasses

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    params = apply_overrides(Parameters(), [
        "tsdf.voxel_size=0.01", "tsdf.sdf_truncation_distance=0.04", "tsdf.initial_block_count=512",
        "graph.node_coverage=0.12", "graph.layer_count=2", "graph.erosion_num_iterations=1",
        "alignment.max_iteration_count=2", "alignment.arap_term_weight=20.0", "fusion.far_clip_distance=2.0",
        "fusion.extraction_max_triangles=60000", "fusion.mesh_capacity_hint=65536",
    ])
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    out, poses = {}, {}
    for device in ("cuda", "cpu"):
        pipe = FusionPipeline(params, seq.intrinsics, device=device)
        pipe.fitter_config = dataclasses.replace(pipe.fitter_config, max_faces_per_bin=1024)
        pipe.initialize(frames[0].depth, frames[0].color)
        out[device] = [pipe.process_frame(f.depth, f.color) for f in frames[1:]]
        poses[device] = pipe.extrinsics.cpu()
    worst = 0.0
    for g, c in zip(out["cuda"], out["cpu"]):
        check(g["valid_solve"] == c["valid_solve"], "reference: valid_solve differs card vs CPU")
        check(g["active_blocks"] == c["active_blocks"], "reference: active blocks differ card vs CPU")
        for a, b in zip(g["data_loss"] + g["arap_loss"], c["data_loss"] + c["arap_loss"]):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
    # f32 sums in another order on the card (atomics in index_add_)
    check(worst < 1e-2, f"reference: losses differ card vs CPU by {worst:.3g} relative")
    pose_err = float((poses["cuda"] - poses["cpu"]).abs().max())
    check(out["cpu"][-1]["rigid_rmse"] > 0, "reference: odometry did not run on frame 2")
    check(pose_err <= 1e-4, f"reference: camera pose differs card vs CPU by {pose_err}")
    emit({"phase": "reference", "max_rel_loss_diff": worst, "pose_card_vs_cpu": pose_err,
          "frames": len(out["cuda"]), **pose_summary(poses["cuda"])})


def phase_data_terms(data_term_call):
    """The fitter's three data terms on the main path's first GN inputs
    (frame 1, first iteration, from the identity warp), on the card. Those
    inputs are the same in every run (their digest is printed); the main
    path's later states are not (float ``index_add_`` on the card sums in
    an order that changes between runs, and the fits amplify it), and the
    gate's f32 noise moved with them. Only "face" compacts pixels: at the
    configured fraction where its cap is above the covered-pixel count,
    else at 0 (no row dropped), so the three compute the same sums."""
    import dataclasses

    import torch

    from dynamicfuion_python_tpu_torch.models import fitter

    args = list(data_term_call.first_args)
    config, frag_faces, ref_mask = args[11], args[7], args[9]
    total = frag_faces.numel()
    covered = int(((frag_faces.reshape(-1) >= 0) & ref_mask.reshape(-1)).sum())
    frac = config.pixel_compaction_fraction
    cap = min(total, ((int(total * frac) + 1023) // 1024) * 1024)
    face_frac = frac if cap > covered else 0.0
    call_args = args[:11] + [dataclasses.replace(config, pixel_compaction_fraction=face_frac)] + args[12:]
    out, ms = {}, {}
    with torch.no_grad():
        for name in ("face", "fast", "autodiff"):
            fn = fitter._DATA_TERMS[name]
            out[name] = fn(*call_args)
            ms[name] = cuda_time_ms(lambda fn=fn: fn(*call_args), 3, warmup=1)
    row = {"phase": "data_terms", "pixels": total, "covered_pixels": covered, "compaction_cap": cap,
           "face_fraction": face_frac, "ms": ms, "nodes": args[12], "inputs_sha1": tensor_digest(args)}
    for a, b in (("face", "fast"), ("face", "autodiff"), ("fast", "autodiff")):
        (ha, ga, la), (hb, gb, lb) = out[a], out[b]
        key = f"{a}_vs_{b}"
        # the JAX package's parity tolerances (tests/test_fitter.py:408-426):
        # loss rtol 1e-5, H and g rtol 1e-4 and atol 1e-5, the atol scaled
        # by the largest entry where that is above 1. That test's fixture has
        # H entries up to ~500; here ~1 px faces of 10^5 pixels leave f32
        # cancellation noise of ~1e-6 of the largest entry in entries near
        # zero, which an absolute 1e-5 counts ("strict_violations")
        h_max, g_max = float(hb.abs().max()), float(gb.abs().max())
        h_atol, g_atol = 1e-5 * max(1.0, h_max), 1e-5 * max(1.0, g_max)
        row[key] = {"loss_rel": abs(float(la) - float(lb)) / max(abs(float(lb)), 1e-30),
                    "h_max": h_max, "g_max": g_max,
                    "h_abs": float((ha - hb).abs().max()), "g_abs": float((ga - gb).abs().max()),
                    "h_rel": max_rel_err(ha, hb), "g_rel": max_rel_err(ga, gb),
                    "strict_violations": violations(ha, hb, 1e-4, 1e-5) + violations(ga, gb, 1e-4, 1e-5)}
        check(row[key]["loss_rel"] <= 1e-5 and violations(ga, gb, 1e-4, g_atol) == 0
              and violations(ha, hb, 1e-4, h_atol) == 0, f"data terms: {a} and {b} disagree ({row[key]})")
    check(all(bool(torch.isfinite(x).all()) for res in out.values() for x in res), "data terms: non-finite")
    emit(row)


def _frame_row(pipe, metrics, wall: float, extra: dict) -> dict:
    import numpy as np

    t = pipe.warp_field.node_translations.detach().cpu().numpy()
    return {
        "frame": pipe.frames_processed, "wall_s": wall, "prior_valid": metrics.get("prior_valid"),
        "prior_matches": metrics.get("prior_matches"), "valid_solve": metrics["valid_solve"],
        "data_loss": metrics["data_loss"], "median_node_x": float(np.median(t[:, 0])),
        "translations_finite": bool(np.isfinite(t).all()), "nodes": pipe.warp_field.num_nodes,
        "dropped_bin_entries": metrics["dropped_bin_entries"], **extra,
    }


def phase_neural_prior() -> dict:
    """The prior with the oracle flow on the 448x640 shifted plane, in two
    tracking-span and anchor modes; returns each run's kernel launches."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_shifted_plane
    from dynamicfuion_python_tpu_torch.ops import native
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    runs = {
        "first_to_current_euclidean": (["fusion.tracking_span_mode=FIRST_TO_CURRENT",
                                        "fusion.pixel_anchor_computation_mode=EUCLIDEAN"], True),
        "previous_to_current_shortest_path": (["fusion.tracking_span_mode=PREVIOUS_TO_CURRENT",
                                               "fusion.pixel_anchor_computation_mode=SHORTEST_PATH"], False),
    }
    launches = {}
    for name, (overrides, from_first) in runs.items():
        params, seq = make_shifted_plane(frame_count=3)
        params = apply_overrides(params, overrides)
        frames = list(seq)
        reset_counters()
        pipe = FusionPipeline(params, seq.intrinsics)
        prior = pipe._apply_prior = Timed(pipe._apply_prior)
        pipe.initialize(frames[0].depth, frames[0].color)
        rows = []
        for f in frames[1:]:
            flow = seq.oracle_flow(f.index if from_first else 1)
            t0 = time.perf_counter()
            m = pipe.process_frame(f.depth, f.color, prior_flow=flow)
            torch.cuda.synchronize()
            rows.append(_frame_row(pipe, m, time.perf_counter() - t0, {"prior_s": prior.seconds[-1]}))
        launches[name] = kernel_launches()
        emit({"phase": "neural_prior", "run": name, "frames": rows, "launches": launches[name]})
        for row in rows:
            shift = seq.shift * row["frame"]
            check(row["prior_valid"] is True, f"neural prior {name}: frame {row['frame']} prior invalid")
            check(row["prior_matches"] > 1000, f"neural prior {name}: frame {row['frame']} has "
                  f"{row['prior_matches']} matches")
            check(all(row["valid_solve"]), f"neural prior {name}: frame {row['frame']}: a GN solve was invalid")
            check(abs(row["median_node_x"] - shift) <= 0.02,
                  f"neural prior {name}: frame {row['frame']} median node x {row['median_node_x']} vs {shift}")
        for kernel in native.KERNELS:
            check(launches[name][kernel] > 0, f"neural prior {name}: kernel {kernel} was not launched")
    return launches


DEFORM_NET_SEED = 0


def phase_deform_net() -> dict:
    """The prior through a seeded DeformNet checkpoint on the 448x640
    bending plane (rigid odometry on); returns the kernel launches. Random
    weights make no meaningful flow: the fit's validity after the prior is
    reported, not gated."""
    import copy

    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.apps import fusion_pipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import PRIOR_IMAGE_SIZE, device_busy_ms, device_us, make_slice
    from dynamicfuion_python_tpu_torch.models import deform_net as dn
    from dynamicfuion_python_tpu_torch.ops import native
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    params, seq = make_slice(frame_count=3, image_size=PRIOR_IMAGE_SIZE)
    check(params.alignment.use_rigid_alignment, "deform_net: the scene must run the default rigid odometry")
    frames = list(seq)
    forwards = []  # the inputs of each DeformNet forward
    outputs = []  # and its outputs, copied

    def record(module, args, kwargs, output):
        if isinstance(module, dn.DeformNet):
            forwards.append((args, kwargs))
            outputs.append(_snapshot(output))

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "deform_net.pt"
        torch.save(dn.seeded_state_dict(dn.DeformNet(), torch.Generator().manual_seed(DEFORM_NET_SEED)), path)
        params = apply_overrides(params, ["fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}"])
        loads = LastCall(fusion_pipeline, "_load_prior_network")
        gn = LastCall(dn, "optimize_point_cloud_alignment")
        hook = torch.nn.modules.module.register_module_forward_hook(record, with_kwargs=True)
        try:
            reset_counters()
            pipe = fusion_pipeline.FusionPipeline(params, seq.intrinsics)
            prior = pipe._apply_prior = Timed(pipe._apply_prior)
            pipe.initialize(frames[0].depth, frames[0].color)
            rows = []
            for f in frames[1:]:
                t0 = time.perf_counter()
                m = pipe.process_frame(f.depth, f.color)
                torch.cuda.synchronize()
                rows.append(_frame_row(pipe, m, time.perf_counter() - t0, {"prior_s": prior.seconds[-1]}))
            launches = kernel_launches()
        finally:
            hook.remove()
            loads.restore()
            gn.restore()
        # the same run again from a fresh pipeline (after the launch counts
        # are read): DeformNet's outputs (flow, mask, the point-cloud GN's
        # node transforms) and the fitted nodes repeat bit for bit
        first_outputs, first_forwards = list(outputs), len(forwards)
        outputs.clear()
        hook = torch.nn.modules.module.register_module_forward_hook(record, with_kwargs=True)
        try:
            again = fusion_pipeline.FusionPipeline(params, seq.intrinsics)
            again.initialize(frames[0].depth, frames[0].color)
            for f in frames[1:]:
                again.process_frame(f.depth, f.color)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        del forwards[first_forwards:]
    repeat = {
        "deform_net_outputs_bit_equal": len(outputs) == len(first_outputs) and bit_equal(first_outputs, outputs),
        "nodes_bit_equal": all(bit_equal(getattr(pipe.warp_field, k), getattr(again.warp_field, k))
                               for k in ("node_rotations", "node_translations")),
        "digests": [tensor_digest(list(first_outputs)), tensor_digest(list(outputs))],
    }
    emit({"phase": "deform_net", "repeat": True, **repeat})
    check(repeat["deform_net_outputs_bit_equal"] and repeat["nodes_bit_equal"],
          f"deform_net: a second run differs ({repeat})")
    net = pipe.prior.deform_net
    check(loads.calls == 1 and net is not None, f"deform_net: the network was loaded {loads.calls} times")
    check(len(forwards) == len(rows) and all(r["prior_valid"] is not None for r in rows),
          f"deform_net: {len(forwards)} DeformNet forwards for {len(rows)} fitted frames")
    verts = pipe.canonical_vertices
    check(all(r["translations_finite"] and all(math.isfinite(x) for x in r["data_loss"]) for r in rows)
          and bool(torch.isfinite(verts).all()), "deform_net: non-finite output")
    for kernel in native.KERNELS:
        check(launches[kernel] > 0, f"deform_net: kernel {kernel} was not launched")

    # the last frame's forward again on the card, and on the CPU
    args, kwargs = forwards[-1]
    with torch.no_grad():
        card = net(*args, **kwargs)
        cpu_net = copy.deepcopy(net).cpu()
        to_cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
        cpu = cpu_net(*[to_cpu(a) for a in args], **{k: to_cpu(v) for k, v in kwargs.items()})
        # the solve's own sensitivity: the CPU's tracker on the card's flow
        # and mask (evaluate=True, no mask threshold: the weights are the
        # mask prediction)
        h, w = args[0].shape[1:3]
        cpu_args = [to_cpu(a) for a in args]
        intrinsics = cpu_args[8].expand(cpu_args[0].shape[0], 3, 3)
        resolved = dn.track_from_flow(
            dn.upsample_flow_to_full(card.flows[0].cpu(), (h, w)), *cpu_args[:8], intrinsics,
            gn_config=cpu_net.gn_config, guards=cpu_net.guards,
            mask_weights=card.mask_prediction[..., 0].cpu(),
            initial_rotations=to_cpu(kwargs.get("node_rotations_estimate")),
            initial_translations=to_cpu(kwargs.get("node_translations_estimate")),
            num_nodes=cpu_net.num_nodes or args[2].shape[1],
        )

    def transform_err(a_rot, a_trans, b_rot, b_trans):
        return (float((a_rot.cpu() - b_rot.cpu()).abs().max()), float((a_trans.cpu() - b_trans.cpu()).abs().max()))

    rot_err, trans_err = transform_err(card.node_rotations, card.node_translations,
                                       cpu.node_rotations, cpu.node_translations)
    rot_sens, trans_sens = transform_err(resolved["node_rotations"], resolved["node_translations"],
                                         cpu.node_rotations, cpu.node_translations)
    errs = {
        "flow2_rel": max_rel_err(card.flows[0], cpu.flows[0]),
        "features2_rel": max_rel_err(card.features2, cpu.features2),
        "mask_rel": max_rel_err(card.mask_prediction, cpu.mask_prediction),
        "node_rotations_abs": rot_err, "node_translations_abs": trans_err,
        "deformed_points_abs": float((card.deformed_points.cpu() - cpu.deformed_points).abs().max()),
        "cpu_solve_of_card_flow_rotations_abs": rot_sens, "cpu_solve_of_card_flow_translations_abs": trans_sens,
        "valid_solve_card_cpu": [int(card.valid_solve[0]), int(cpu.valid_solve[0])],
    }
    # FP32 convolutions (TF32 off) in another summation order: ~1e-6 relative
    # per layer over the ~40 layers; TF32 would round each product to 10
    # mantissa bits, ~5e-4
    check(max(errs["flow2_rel"], errs["features2_rel"], errs["mask_rel"]) <= 2e-4,
          f"deform_net: card forward differs from the CPU's ({errs})")
    # the node transforms. The dense system's condition number is ~3e7 (phase
    # output), so in f32 the rotations of weakly held nodes (few matches,
    # held by the LM damping) are not determined: the card and the CPU may
    # differ there by ~5e-3 per entry, and the CPU's own solve moves that
    # much on the card's flow. What the solve determines is held tightly:
    # translations to 1e-3 m and the dense warp of the source points (what
    # the transforms are for) to 2e-3 m, a tenth of the 2 cm the prior's
    # tests hold node motion to; rotation entries only to 0.05 (~3 degrees),
    # a bound against a broken solve
    check(errs["valid_solve_card_cpu"][0] == errs["valid_solve_card_cpu"][1] and trans_err <= 1e-3
          and errs["deformed_points_abs"] <= 2e-3 and rot_err <= 0.05,
          f"deform_net: card node transforms differ from the CPU's ({errs})")

    with torch.no_grad():
        forward_ms = cuda_time_ms(lambda: net(*args, **kwargs), 3, warmup=1)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            net(*args, **kwargs)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernel_rows = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                             key=lambda e: -device_us(e))
        # the operators that launched those kernels (own device time: each
        # kernel counts once, at its innermost operator)
        op_rows = sorted((e for e in events if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                          and device_us(e) > 0), key=lambda e: -device_us(e))
        # the flow network alone, on the forward's two color images
        pwcnet_ms = cuda_time_ms(lambda: net.flow_net(args[0][..., :3], args[1][..., :3]), 3, warmup=1)
        gn_ms = cuda_time_ms(lambda: dn.optimize_point_cloud_alignment(*gn.args, **gn.kwargs), 3, warmup=1)
        checked = gn.kwargs["config"]._replace(check_condition_num=True, break_on_condition_num=False)
        conditions = dn.optimize_point_cloud_alignment(*gn.args, **{**gn.kwargs, "config": checked}).condition_numbers
    iterations = gn.kwargs["config"].num_iterations
    frame_s = sum(r["wall_s"] for r in rows)
    emit({
        "phase": "deform_net", "image_size": list(PRIOR_IMAGE_SIZE), "frames": rows, "launches": launches,
        "card_vs_cpu": errs, "forward_ms": forward_ms, "forward_device_ms": device_busy_ms(events),
        "forward_kernel_launches": sum(e.count for e in kernel_rows),
        "top_device_ops": [{"name": e.key[:80], "device_ms": device_us(e) / 1e3, "calls": e.count}
                           for e in kernel_rows[:12]],
        "top_operators": [{"name": e.key[:60], "device_ms": device_us(e) / 1e3, "calls": e.count}
                          for e in op_rows[:12]],
        "pwcnet_ms": pwcnet_ms,
        "gn_ms": gn_ms, "gn_iterations": iterations, "gn_ms_per_iteration": gn_ms / iterations,
        "gn_matches": int(gn.args[3].shape[0]), "gn_nodes": int(gn.kwargs["num_nodes"]),
        "gn_condition_numbers": [float(c) for c in conditions],
        "prior_share_of_frame": sum(r["prior_s"] for r in rows) / frame_s, "frames_s": frame_s,
        "fit_valid_solve_after_random_prior": [r["valid_solve"] for r in rows],
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
        "max_abs_translation": float(np.abs(pipe.warp_field.node_translations.cpu().numpy()).max()),
    })
    return launches


class plain_kernels:
    """Inside the block, the rasterizer reaches both kernels' plain PyTorch
    versions (on the card's tensors) instead of the kernels."""

    def __enter__(self):
        from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
        from dynamicfuion_python_tpu_torch.ops import rasterize as rz

        def expand(vertices, triangles, intrinsics, near=0.05, far=10.0):
            fv, valid = me.expand_project_faces_plain(vertices, triangles, intrinsics, near, far)
            return fv, valid, None

        self.saved = (rz.expand_project_faces, rz.rasterize_tiles)
        rz.expand_project_faces, rz.rasterize_tiles = expand, rz.rasterize_tiles_plain
        return self

    def __exit__(self, *exc):
        from dynamicfuion_python_tpu_torch.ops import rasterize as rz

        rz.expand_project_faces, rz.rasterize_tiles = self.saved


class Active:
    """Wraps a callable; :attr:`active` is True while it runs."""

    def __init__(self, fn):
        self.fn = fn
        self.active = False

    def __call__(self, *args, **kwargs):
        self.active = True
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.active = False


def host_syncs(fn):
    """Run ``fn`` under torch.cuda.set_sync_debug_mode("warn"); returns (its
    result, the number of host syncs it issued)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def traced(fn) -> dict:
    """One traced call of ``fn``: its device time, its kernel launches and
    its costliest kernels."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.profile_frame import device_busy_ms, device_us

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -device_us(e))
    return {"device_ms": device_busy_ms(events), "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:70], "device_ms": device_us(e) / 1e3, "calls": e.count}
                            for e in kernels[:5]]}


def percentiles(values, qs=(50, 95)) -> dict:
    import numpy as np

    v = np.asarray(values, np.float64)
    return {f"p{q}": float(np.percentile(v, q)) if v.size else None for q in qs}


def bin_stats(table) -> dict:
    occ = (table >= 0).sum(1)
    return {"tiles": int(table.shape[0]), "bin_capacity": int(table.shape[1]), "entries": int(occ.sum()),
            "mean_entries": float(occ.float().mean()), "max_entries": int(occ.max())}


def phase_renderer(pipe):
    """MeshRenderer on the main path's final warped canonical mesh, against
    the same render through the kernels' plain versions; returns B1's and
    B2's launches and the B1 measurements at bin capacity 1024."""
    import torch

    from dynamicfuion_python_tpu_torch.models.renderer import MeshRenderer
    from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
    from dynamicfuion_python_tpu_torch.ops import native
    from dynamicfuion_python_tpu_torch.ops import rasterize as rz

    size = tuple(pipe.previous_depth.shape)
    verts = pipe.warp_field.warp_points(pipe.canonical_vertices).contiguous()
    tris = pipe.canonical_triangles
    renderer = MeshRenderer(size, pipe.intrinsics)
    b1 = LastCall(rz, "rasterize_tiles")
    reset_counters()
    try:
        (color, depth), syncs = host_syncs(lambda: renderer.render_mesh(verts, tris))
        torch.cuda.synchronize()
    finally:
        b1.restore()
    launches = kernel_launches()
    for kernel in RASTER_KERNELS:
        check(launches[kernel] > 0, f"renderer: kernel {kernel} was not launched")
    with plain_kernels():
        p_color, p_depth = renderer.render_mesh(verts, tris)
    # the fragments themselves: the kernels' face ids against the plain ones
    fv, valid = rz.extract_face_vertices(verts, tris, pipe.intrinsics, size)
    p_fv, p_valid = me.expand_project_faces_plain(verts, tris, pipe.intrinsics)
    check(torch.equal(fv, p_fv) and torch.equal(valid, p_valid), "renderer: B2 differs from its plain version")
    kw = dict(max_faces_per_bin=renderer.max_faces_per_bin, tile_size=renderer.tile_size, return_overflow=True)
    frag, overflow = rz.rasterize_binned(fv, valid, size, **kw)
    with plain_kernels():
        p_frag, _ = rz.rasterize_binned(fv, valid, size, **kw)
    torch.cuda.synchronize()
    ids_equal = torch.equal(frag.face_indices, p_frag.face_indices)
    errs = {"depth": float((depth - p_depth).abs().max()), "color": float((color - p_color).abs().max()),
            "fragment_depth": float((frag.depths - p_frag.depths).abs().max())}
    drops = {k: int(v) for k, v in overflow.items()}
    check(ids_equal, "renderer: B1's face ids differ from the plain version's")
    check(max(errs.values()) <= 1e-5, f"renderer: kernels differ from the plain versions ({errs})")
    check(drops == {"dropped_large_faces": 0, "dropped_bin_entries": 0}, f"renderer: rasterizer drops {drops}")
    ms = cuda_time_ms(lambda: renderer.render_mesh(verts, tris), 20)
    faces, table, image_size, tile_size = b1.args
    with plain_kernels():
        render_plain_ms = cuda_time_ms(lambda: renderer.render_mesh(verts, tris), 2, warmup=1)
    b1_ms = cuda_time_ms(lambda: rz.rasterize_tiles_cuda(*b1.args, **b1.kwargs), 50)
    b1_plain_ms = cuda_time_ms(lambda: rz.rasterize_tiles_plain(*b1.args, **b1.kwargs), 2, warmup=1)
    b1_device = device_ms_per_launch({"rasterize_tiles_kernel": lambda: rz.rasterize_tiles_cuda(*b1.args, **b1.kwargs)},
                                     50)["rasterize_tiles_kernel"]
    work = rz.rasterize_tiles_work(faces, table, image_size, tile_size, b1.kwargs.get("blur_radius", 0.0))
    b1_bound = max(work["bytes"] / PEAK_BYTES_PER_S, work["operations"] / PEAK_FP32_PER_S) * 1e3
    row = {
        "phase": "renderer", "image_size": list(size), "faces": int(tris.shape[0]), "vertices": int(verts.shape[0]),
        "launches": launches, "host_syncs_per_render": syncs, "face_ids_equal": ids_equal, "max_abs_err": errs,
        "drops": drops, "ms_per_render": ms, "ms_per_render_plain_kernels": render_plain_ms,
        "render_trace": traced(lambda: renderer.render_mesh(verts, tris)),
        "hit_pixels": int((depth > 0).sum()), "bins": bin_stats(table),
        "b1": {"ms": b1_ms, "device_ms": b1_device, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
               "bound_by": "bytes" if work["bytes"] / PEAK_BYTES_PER_S > work["operations"] / PEAK_FP32_PER_S
               else "operations", "bytes": work["bytes"], "operations": work["operations"],
               "tests": work["tests"], "distinct_faces": work["distinct_faces"]},
    }
    emit(row)
    return launches, row


def phase_rendered_prior() -> dict:
    """The prior's rendered source-image modes with the rendered-mesh
    recorder: the seeded DeformNet on the 448x640 bending plane in the
    overlay mode, and the oracle flow on the 448x640 shifted plane in
    RENDERED_ONLY. Returns each run's kernel launches."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import PRIOR_IMAGE_SIZE, make_shifted_plane, make_slice
    from dynamicfuion_python_tpu_torch.models import deform_net as dn
    from dynamicfuion_python_tpu_torch.ops import native
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides
    from dynamicfuion_python_tpu_torch.utils.telemetry import TelemetryRecorder, read_png

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "deform_net.pt"
        torch.save(dn.seeded_state_dict(dn.DeformNet(), torch.Generator().manual_seed(DEFORM_NET_SEED)), ckpt)
        overlay, overlay_seq = make_slice(frame_count=3, image_size=PRIOR_IMAGE_SIZE)
        shifted, shifted_seq = make_shifted_plane(frame_count=3)
        runs = {
            "deform_net_overlay": (apply_overrides(overlay, [
                "fusion.use_neural_prior=true", f"fusion.prior_checkpoint={ckpt}",
                "fusion.source_image_mode=RENDERED_WITH_PREVIOUS_FRAME_OVERLAY"]), overlay_seq, None),
            "oracle_flow_rendered_only": (apply_overrides(shifted, [
                "fusion.source_image_mode=RENDERED_ONLY", "fusion.tracking_span_mode=PREVIOUS_TO_CURRENT",
                "fusion.pixel_anchor_computation_mode=EUCLIDEAN"]), shifted_seq, shifted_seq.oracle_flow(1)),
        }
        for name, (params, seq, flow) in runs.items():
            params = apply_overrides(params, [
                "telemetry.record_rendered_warped_mesh=true", f"telemetry.output_directory={tmp}",
                "telemetry.print_runtime=false"])
            frames = list(seq)
            reset_counters()
            pipe = FusionPipeline(params, seq.intrinsics)
            pipe.telemetry = TelemetryRecorder(params.telemetry, name)
            in_prior = Active(pipe._apply_prior)
            prior = pipe._apply_prior = Timed(in_prior)
            sources = []  # (rendered depth, keyframe depth) of each render for the prior
            render = pipe._render_warped_mesh

            def recording_render(size, render=render, in_prior=in_prior, pipe=pipe, sources=sources):
                color, depth = render(size)
                if in_prior.active:
                    sources.append((depth, pipe.keyframe_source[0]))
                return color, depth

            pipe._render_warped_mesh = recording_render
            pipe.initialize(frames[0].depth, frames[0].color)
            rows = []
            for f in frames[1:]:
                t0 = time.perf_counter()
                m = pipe.process_frame(f.depth, f.color, prior_flow=flow)
                torch.cuda.synchronize()
                rows.append(_frame_row(pipe, m, time.perf_counter() - t0, {"prior_s": prior.seconds[-1]}))
            launches[name] = kernel_launches()
            gaps = []
            for depth_r, kf in sources:
                kf_m = kf.to(torch.float32) / params.fusion.depth_scale
                both = (depth_r > 0) & (kf_m > 0)
                d = (depth_r - kf_m)[both].abs().cpu().numpy()
                gaps.append({"coverage_of_keyframe": float(both.sum()) / max(int((kf_m > 0).sum()), 1),
                             **{f"abs_diff_m_{k}": v for k, v in percentiles(d).items()}})
            pngs = {}
            for row in rows:
                for kind in ("color", "depth"):
                    path = pipe.telemetry.run_dir / f"{row['frame']:06d}_rendered_{kind}.png"
                    pngs[path.name] = list(read_png(path).shape) if path.exists() else None
            frame_s = sum(r["wall_s"] for r in rows)
            emit({"phase": "rendered_prior", "run": name, "image_size": list(PRIOR_IMAGE_SIZE), "frames": rows,
                  "launches": launches[name], "rendered_vs_keyframe_depth": gaps, "pngs": pngs,
                  "prior_share_of_frame": sum(r["prior_s"] for r in rows) / frame_s, "frames_s": frame_s})
            for kernel in native.KERNELS:
                check(launches[name][kernel] > 0, f"rendered prior {name}: kernel {kernel} was not launched")
            check(len(sources) == len(rows), f"rendered prior {name}: {len(sources)} rendered sources "
                  f"for {len(rows)} fitted frames")
            for row in rows:
                check(row["translations_finite"] and all(math.isfinite(x) for x in row["data_loss"]),
                      f"rendered prior {name}: frame {row['frame']}: non-finite output")
            check(all(shape is not None and shape[:2] == list(PRIOR_IMAGE_SIZE) for shape in pngs.values())
                  and len(pngs) == 2 * len(rows), f"rendered prior {name}: rendered PNGs {pngs}")
            if flow is not None:
                for row in rows:
                    shift = seq.shift * row["frame"]
                    check(row["prior_valid"] is True and all(row["valid_solve"]),
                          f"rendered prior {name}: frame {row['frame']}: prior or solve invalid")
                    check(abs(row["median_node_x"] - shift) <= 0.02,
                          f"rendered prior {name}: frame {row['frame']} median node x {row['median_node_x']} "
                          f"vs {shift}")
    return launches


def phase_volume_readout(pipe):
    """Ray casting, the rendered mesh, marching tetrahedra and sample_tsdf
    on the main path's final volume; returns the kernel launches of its
    render."""
    import dataclasses

    import torch

    from dynamicfuion_python_tpu_torch.models.renderer import MeshRenderer
    from dynamicfuion_python_tpu_torch.models.voxel_block_grid import extract_mesh_fitter_arrays
    from dynamicfuion_python_tpu_torch.ops import native

    volume = pipe.volume
    h, w = pipe.previous_depth.shape
    k = pipe.intrinsics

    def cast():
        return volume.ray_cast(k, None, width=w, height=h, with_normals=True, with_color=True)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the call raises
    try:
        rays = cast()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ray_ms = cuda_time_ms(cast, 3, warmup=1)
    n_steps = int(math.ceil((volume.depth_max - 0.1) / (0.5 * volume.sdf_truncation_distance))) + 1

    # the welded mesh in the fitter's padded arrays (faces past the count
    # point at the padding vertex, which the near plane clips)
    verts, faces, v_count, t_count = extract_mesh_fitter_arrays(volume, 1 << 20, 1 << 19, 0.0)
    renderer = MeshRenderer((h, w), k)
    reset_counters()
    _, depth_r = renderer.render_mesh(verts, faces)
    torch.cuda.synchronize()
    launches = kernel_launches()
    for kernel in RASTER_KERNELS:
        check(launches[kernel] > 0, f"volume read-out: kernel {kernel} was not launched")
    both = rays["mask"] & (depth_r > 0)
    diff = (rays["depth"] - depth_r)[both].abs().cpu().numpy()
    stats = percentiles(diff)
    check(both.sum() > 10000 and stats["p50"] < volume.voxel_size,
          f"volume read-out: ray-cast vs rendered depth {stats} over {int(both.sum())} pixels")

    _, tetra_count = volume.extract_triangle_soup(max_triangles=1 << 21, method="tetrahedra")
    _, cube_count = volume.extract_triangle_soup(max_triangles=1 << 21)
    tetra_ms = cuda_time_ms(lambda: volume.extract_triangle_soup(max_triangles=1 << 21, method="tetrahedra"), 2,
                            warmup=1)

    hits = rays["points"][rays["mask"]]
    gen = torch.Generator().manual_seed(0)
    probes = torch.cat([hits[::7], hits[::13] + 0.01 * torch.randn(hits[::13].shape, generator=gen).to(hits)])
    cpu_volume = dataclasses.replace(volume, **{
        f.name: getattr(volume, f.name).cpu() for f in dataclasses.fields(volume)
        if isinstance(getattr(volume, f.name), torch.Tensor)})
    val, valid = volume.sample_tsdf(probes)
    cpu_val, cpu_valid = cpu_volume.sample_tsdf(probes.cpu())
    sample_err = float((val.cpu() - cpu_val)[cpu_valid].abs().max())
    check(torch.equal(valid.cpu(), cpu_valid) and sample_err <= 1e-5,
          f"volume read-out: sample_tsdf card vs CPU {sample_err}")
    row = {
        "phase": "volume_readout", "image_size": [h, w], "ray_cast_ms": ray_ms, "ray_steps": n_steps,
        "ray_hits": int(rays["mask"].sum()), "ray_cast_sync_free": True, "ray_cast_trace": traced(cast),
        "normals_finite": bool(torch.isfinite(rays["normals"]).all()),
        "rendered_hits": int((depth_r > 0).sum()), "both_hit": int(both.sum()),
        "ray_vs_rendered_depth_m": stats, "voxel_size": volume.voxel_size,
        "mesh_triangles": int(t_count), "mesh_vertices": int(v_count), "launches": launches,
        "tetrahedra_triangles": int(tetra_count), "cubes_triangles": int(cube_count),
        "tetrahedra_ms": tetra_ms, "sample_tsdf_probes": int(probes.shape[0]),
        "sample_tsdf_card_vs_cpu": sample_err, "sample_tsdf_valid": int(cpu_valid.sum()),
    }
    check(row["normals_finite"], "volume read-out: non-finite normals")
    emit(row)
    return launches


def phase_indexed():
    """rasterize_indexed and rasterize_splat on the reference's headline
    scene; returns B2's launches and measurements at 4,470,784 faces."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.profile_frame import (
        HEADLINE_FOCAL, HEADLINE_IMAGE_SIZE, build_scene, headline_tier_caps)
    from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
    from dynamicfuion_python_tpu_torch.ops import rasterize as rz
    from dynamicfuion_python_tpu_torch.utils.device import resolve_device

    h, w = HEADLINE_IMAGE_SIZE
    verts_np, faces_np = build_scene()
    dev = resolve_device()  # the card
    verts = torch.as_tensor(verts_np, device=dev)
    faces = torch.as_tensor(faces_np, device=dev)
    k = torch.tensor([[HEADLINE_FOCAL, 0, w / 2], [0, HEADLINE_FOCAL, h / 2], [0, 0, 1]], device=dev)
    f = faces.shape[0]
    caps = headline_tier_caps(f)
    plan = me.ExpansionPlan(faces, verts.shape[0])
    reset_counters()
    frag_i, over_i = me.rasterize_indexed(verts, plan, k, (h, w), **caps)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches["mesh_expand"] > 0, "indexed: kernel mesh_expand was not launched")
    fv, valid = rz.extract_face_vertices(verts, faces, k, (h, w))
    frag_s, over_s = rz.rasterize_splat(fv, valid, (h, w), return_overflow=True, **caps)
    drops = {"indexed": {n: int(v) for n, v in over_i.items()}, "splat": {n: int(v) for n, v in over_s.items()}}
    check(all(v == 0 for d in drops.values() for v in d.values()), f"indexed: drops {drops}")
    ids_i, ids_s = frag_i.face_indices, frag_s.face_indices
    differ = ids_i != ids_s
    depth_err = float((frag_i.depths - frag_s.depths).abs().max())
    check(depth_err <= 1e-5, f"indexed: depths differ from the splat's by {depth_err}")
    # where the face ids differ the two faces tie: both orders evaluate each
    # face alike, so the winners' depths are equal exactly
    check(bool(((ids_i >= 0) == (ids_s >= 0)).all()), "indexed: coverage differs from the splat's")
    check(bool((frag_i.depths[differ] == frag_s.depths[differ]).all()),
          "indexed: face ids differ where the depths do not tie")
    covered = int((ids_s >= 0).sum())

    # B2 at this size, on the plan's sorted faces, against its plain version
    tri = plan.sorted_triangles
    got = me.expand_project_faces_cuda(verts, tri, k)
    want = me.expand_project_faces_plain(verts, tri, k)
    torch.cuda.synchronize()
    b2_err = float((got[0] - want[0]).abs().max())
    check(torch.equal(got[1], want[1]) and b2_err == 0.0, f"indexed: B2 not bit-equal ({b2_err})")
    b2_ms = cuda_time_ms(lambda: me.expand_project_faces_cuda(verts, tri, k), 20)
    b2_plain = cuda_time_ms(lambda: me.expand_project_faces_plain(verts, tri, k), 5, warmup=1)
    b2_device = device_ms_per_launch({"mesh_expand_kernel": lambda: me.expand_project_faces_cuda(verts, tri, k)},
                                     20)["mesh_expand_kernel"]
    n_verts = verts.shape[0]
    b2_bytes = n_verts * 12 + f * 12 + 36 + f * 36 + f
    b2_ops = f * EXPAND_OPS_PER_FACE
    b2_bound = max(b2_bytes / PEAK_BYTES_PER_S, b2_ops / PEAK_FP32_PER_S) * 1e3
    indexed_ms = cuda_time_ms(lambda: me.rasterize_indexed(verts, plan, k, (h, w), **caps), 5, warmup=1)
    splat_ms = cuda_time_ms(lambda: rz.rasterize_splat(fv, valid, (h, w), **caps), 5, warmup=1)
    plan_ms = cuda_time_ms(lambda: me.ExpansionPlan(faces, n_verts), 3, warmup=1)
    b2 = {"faces": f, "vertices": n_verts, "ms": b2_ms, "device_ms": b2_device, "plain_ms": b2_plain,
          "bound_ms": b2_bound, "bytes": b2_bytes, "operations": b2_ops, "max_abs_err": b2_err,
          "bound_by": "bytes" if b2_bytes / PEAK_BYTES_PER_S > b2_ops / PEAK_FP32_PER_S else "operations"}
    row = {"phase": "indexed", "image_size": [h, w], "faces": f, "vertices": n_verts, "tier_caps": caps,
           "launches": launches, "drops": drops, "covered_pixels": covered, "tied_pixels": int(differ.sum()),
           "depth_max_abs_err": depth_err, "rasterize_indexed_ms": indexed_ms, "rasterize_splat_ms": splat_ms,
           "rasterize_indexed_trace": traced(lambda: me.rasterize_indexed(verts, plan, k, (h, w), **caps)),
           "expansion_plan_ms": plan_ms, "b2": b2}
    emit(row)
    return launches, b2


# DeformNet training at the JAX train()'s defaults (448x640 crop of 480x640,
# batch 4, 128 nodes, 10,000 matches, 3 GN iterations, SGD momentum 0.9)
TRAIN_CROP = (448, 640)
TRAIN_SIZE = (480, 640)
PARITY_CROP = (192, 256)
# card against CPU, one 1_solver step at batch 1 from the same weights and
# batch, TF32 on globally beforehand (the step turns it off): the loss
# relative, the gradients as ||card - CPU|| / ||CPU|| over all parameters.
# Each bound is 10x or more the worst value PERF.md records beside it
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-4


def _train_batch(dataset, indices, seed: int) -> dict:
    """A labeled batch prepared as train() prepares it: ground-truth node
    translations and match-subsampling uniforms (numpy)."""
    import numpy as np

    from dynamicfuion_python_tpu_torch.apps import train

    batch = dataset.batch(indices)
    batch["node_translations_gt"] = train.node_translations_gt_from_scene_flow(batch)[0]
    batch["match_subsample_uniforms"] = (
        np.random.default_rng(seed).uniform(size=batch["target"].shape[:3]).astype(np.float32))
    return batch


def _stage_model(stage: str, state: dict, device, gn_iterations: int | None = None):
    """The stage's model as train() builds it (weights seeded by 0, then
    ``state`` where it has them), on ``device``."""
    import torch

    from dynamicfuion_python_tpu_torch.apps import train
    from dynamicfuion_python_tpu_torch.models.deform_net import seeded_state_dict
    from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig

    model = train.build_model(train.STAGES[stage], 128, 10000)
    if gn_iterations is not None:
        model.gn_config = GnConfig(num_iterations=gn_iterations, lm_factor=0.1)
    model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(0)))
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()}, strict=False)
    return model.to(device)


def _one_step(stage: str, state: dict, batch_np: dict, device, tf32_backward: bool = False):
    """One SGD step (lr 1e-4) of ``stage`` from ``state`` on a numpy batch:
    (loss, {name: gradient on the CPU}, backward flags). The flags are the
    set of (cuBLAS ``allow_tf32``, cuDNN ``allow_tf32``, cuDNN
    ``deterministic``) triples in force while the backward computed each
    parameter's gradient, read by gradient hooks. ``tf32_backward`` runs
    the forward and backward outside the step's ``fp32_step`` block (the
    control)."""
    import torch

    from dynamicfuion_python_tpu_torch.apps import train

    model = _stage_model(stage, state, device)
    optimizer, scheduler = train._stage_optimizer(train.STAGES[stage], model, 1e-4, use_adam=False)
    batch = train.batch_to_device(dict(batch_np), device)
    flags = set()

    def read_flags(grad):
        flags.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                   torch.backends.cudnn.deterministic))

    hooks = [p.register_hook(read_flags) for p in model.parameters() if p.requires_grad]
    if tf32_backward:
        loss, _ = train._forward_and_loss(model, batch, train.STAGES[stage])
        loss.backward()
    else:
        loss, _ = train.make_train_step(model, optimizer, train.STAGES[stage], scheduler)(batch)
    for hook in hooks:
        hook.remove()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, flags


def _grad_diff(got: dict, want: dict) -> dict:
    """Card-against-CPU gradient differences: the relative L2 norm over all
    tensors (gated), and the largest per-tensor max |diff| / max |CPU|
    (printed: a tensor whose gradient is tiny makes it jump between runs)."""
    import torch

    per_tensor = [float((got[k] - w).abs().max() / w.abs().max()) for k, w in want.items() if float(w.abs().max()) > 0]
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w**2).sum()) for w in want.values())
    return {"grad_max_rel_per_tensor": max(per_tensor), "grad_rel_l2": (num / den) ** 0.5, "tensors": len(per_tensor),
            "finite": all(bool(torch.isfinite(g).all()) for g in got.values())}


def phase_train(smi: str) -> dict:
    """DeformNet training on the card: a DeepDeform-layout split written
    under a temporary directory (two 480x640 sequences, a shifted and a
    bending patch, 4 pairs, PNG frames, closed-form optical and scene flow),
    its graphs and labels from create_graph_data.main, then train() at stage
    1_solver at the JAX train()'s defaults (5 steps of one repeated batch,
    lr 1e-4, an eval step) twice, which must leave the same weights bit for
    bit, one step each of 0_flow / 2_mask / 3_refine, generate -> evaluate
    over the split, one 1_solver step on the card against the CPU at
    192x256, batch 1, and that step and a 3_refine step each run twice on
    the card, which must repeat bit for bit. Returns the kernel launches of
    the training path (the training path rasterizes nothing)."""
    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.apps import create_graph_data, evaluate, generate, train
    from dynamicfuion_python_tpu_torch.apps.profile_frame import device_us
    from dynamicfuion_python_tpu_torch.apps.profile_train_step import compare_steps
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split
    from dynamicfuion_python_tpu_torch.settings import TrainingConfig

    row = {"phase": "train", "nvidia_smi": smi, "image_size": list(TRAIN_CROP), "batch": 4, "max_nodes": 128,
           "gn_max_matches": 10000, "gn_iterations": 3}
    cfg = TrainingConfig(shuffle=False)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        for seq in write_split(root / "train", TRAIN_SIZE):
            create_graph_data.main([str(seq), "--frames", "0", "--labels", str(root / "train.json")])
        row["dataset_s"] = time.perf_counter() - t0

        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        t0 = time.perf_counter()
        model, losses = train.train(str(root), stage="1_solver", labeled=True, iterations=5, learning_rate=1e-4,
                                    eval_every=5, checkpoint_dir=str(root / "ckpt"), training_config=cfg, stats=stats)
        row["train_1_solver_s"] = time.perf_counter() - t0
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row["losses"] = losses
        check(len(losses) == 5 and all(math.isfinite(x) for x in losses), f"train: losses {losses}")
        check(losses[-1] < losses[0], f"train: the last loss {losses[-1]} is not below the first {losses[0]}")
        row.update({k: stats[k] for k in ("step_ms", "forward_ms", "backward_ms", "optimizer_ms")})
        row["data_s_per_batch"] = float(np.median(stats["data_s"]))
        row["eval_metrics"] = {k: v for k, v in stats["eval_history"][-1].items() if k != "iteration"}
        check(all(math.isfinite(v) for v in row["eval_metrics"].values()), f"train: eval metrics {row['eval_metrics']}")
        trained = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        reloaded = train.load_checkpoint(root / "ckpt", train.build_model(train.STAGES["1_solver"], 128, 10000))
        check(all(torch.equal(reloaded.state_dict()[k], v) for k, v in trained.items()),
              "train: the checkpoint does not reload bit-equal")
        row["checkpoint_bit_equal"] = True
        # the same run again: every step's backward has a fixed order, so the
        # weights after 5 steps are the same bits
        again, again_losses = train.train(str(root), stage="1_solver", labeled=True, iterations=5, learning_rate=1e-4,
                                          eval_every=5, checkpoint_dir=str(root / "ckpt_again"), training_config=cfg)
        digests = [tensor_digest(list(trained.values())),
                   tensor_digest([again.state_dict()[k] for k in trained])]
        row["train_repeat"] = {"losses_equal": again_losses == losses, "state_dict_digests": digests}
        check(digests[0] == digests[1], f"train: a second 5-step run left other weights: {digests}")
        del again

        stages = {}
        for stage, frozen, trains in (("0_flow", (), ("flow_net",)), ("2_mask", ("flow_net",), ("mask_net",)),
                                      ("3_refine", (), ("flow_net", "mask_net"))):
            # train() starts each stage from the weights seeded by 0, as _stage_model builds them
            before = _stage_model(stage, {}, "cpu").state_dict()
            after, stage_losses = train.train(str(root), stage=stage, labeled=True, iterations=1, learning_rate=1e-4,
                                              eval_every=0, checkpoint_dir=str(root / f"ckpt_{stage}"),
                                              training_config=cfg)
            after = {k: v.cpu() for k, v in after.state_dict().items()}
            moved = {net: any(not torch.equal(after[k], before[k]) for k in before if k.startswith(net + "."))
                     for net in ("flow_net", "mask_net") if any(k.startswith(net + ".") for k in before)}
            check(all(not moved[n] for n in frozen), f"train: {stage} moved a frozen net: {moved}")
            check(all(moved[n] for n in trains), f"train: {stage} left a trained net unchanged: {moved}")
            check(math.isfinite(stage_losses[0]), f"train: {stage} loss {stage_losses}")
            stages[stage] = {"loss": stage_losses[0], "moved": moved, "frozen_bit_equal": list(frozen)}
        row["stages"] = stages

        t0 = time.perf_counter()
        names = generate.generate(str(root), out_dir=str(root / "pred"), checkpoint_dir=str(root / "ckpt"),
                                  labels_filename="train", image_size=TRAIN_CROP)
        metrics = evaluate.evaluate(str(root), predictions_dir=str(root / "pred"), labels_filename="train",
                                    image_size=TRAIN_CROP)
        row["generate_evaluate_s"] = time.perf_counter() - t0
        row["evaluate"] = metrics
        any_valid_node = any(float(np.load(root / "pred" / f"{n}.npz")["deformations_validity"].sum()) > 0 for n in names)
        check(metrics["pair_count"] == 4, f"train: evaluate scored {metrics['pair_count']} pairs")
        for key in ("epe_3d", "valid_solve_ratio", "graph_error_3d"):
            value = metrics[key]
            if value is None:
                check(key == "graph_error_3d" and not any_valid_node, f"train: evaluate {key} is None")
            else:
                check(math.isfinite(value), f"train: evaluate {key} = {value}")
        launches = kernel_launches()

        # one step on the card against the CPU, TF32 on globally beforehand
        dataset = LabeledDeformDataset(root, "train", input_size=PARITY_CROP, max_nodes=128)
        batch = _train_batch(dataset, [0], seed=1)
        previous = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            cpu_loss, cpu_grads, _ = _one_step("1_solver", trained, batch, "cpu")
            card_loss, card_grads, card_flags = _one_step("1_solver", trained, batch, "cuda")
            repeat_loss, repeat_grads, _ = _one_step("1_solver", trained, batch, "cuda")
            check((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True),
                  "train: the step did not restore the global TF32 flags")
            tf32_loss, tf32_grads, tf32_flags = _one_step("1_solver", trained, batch, "cuda", tf32_backward=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = previous
        # the step's own precision and algorithms, read while its backward
        # ran: TF32 off for cuBLAS and cuDNN, cuDNN deterministic; the
        # control's hooks see TF32 on
        row["backward_flags"] = {"fields": ["matmul_tf32", "cudnn_tf32", "cudnn_deterministic"],
                                 "step": sorted(card_flags), "control": sorted(tf32_flags)}
        check(card_flags == {(False, False, True)}, f"train: the step's backward ran with flags {sorted(card_flags)}")
        check({f[:2] for f in tf32_flags} == {(True, True)},
              f"train: the control's backward ran with TF32 flags {sorted(tf32_flags)}")
        card = {"loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss), **_grad_diff(card_grads, cpu_grads)}
        row["card_vs_cpu"] = {**card, "image_size": list(PARITY_CROP), "loss_rtol": TRAIN_LOSS_RTOL,
                              "grad_rtol": TRAIN_GRAD_RTOL}
        check(card["finite"] and math.isfinite(card_loss), "train: non-finite card gradients")
        check(card["loss_rel"] <= TRAIN_LOSS_RTOL, f"train: card loss {card_loss} against CPU {cpu_loss}")
        check(card["grad_rel_l2"] <= TRAIN_GRAD_RTOL, f"train: card gradients against the CPU's: {card}")
        # the same step twice on the card: loss and gradients bit for bit;
        # then a 3_refine step twice (MaskNet's convolutions, the mask loss)
        refine = _one_step("3_refine", trained, batch, "cuda"), _one_step("3_refine", trained, batch, "cuda")
        row["card_step_repeat"] = {"1_solver": compare_steps((card_loss, card_grads), (repeat_loss, repeat_grads)),
                                   "3_refine": compare_steps(refine[0][:2], refine[1][:2])}
        for stage, result in row["card_step_repeat"].items():
            check(result["loss_bit_equal"] and result["gradients_bit_equal"],
                  f"train: a {stage} card step does not repeat: {result}")
        check(refine[0][2] == {(False, False, True)}, f"train: the 3_refine backward ran with flags {sorted(refine[0][2])}")
        # the backward node types of one card step, walked from its loss: the
        # fixed-order gathers and upsampling must stand in the graph
        model = _stage_model("1_solver", trained, "cuda")
        train._stage_optimizer(train.STAGES["1_solver"], model, 1e-4, use_adam=False)
        with train.fp32_step():
            loss, _ = train._forward_and_loss(model, train.batch_to_device(dict(batch), "cuda"), train.STAGES["1_solver"])
        row["backward_census"] = train.backward_census(loss)
        check(all(row["backward_census"].get(n, 0) > 0 for n in ("_GatherRowsBackward", "_BilinearResizeBackward")),
              f"train: the card step's graph lacks a fixed-order backward: {row['backward_census']}")
        del model, loss
        # the control, never a gate: the same step with TF32 left on
        row["card_tf32_vs_cpu"] = {"loss_rel": abs(tf32_loss - cpu_loss) / abs(cpu_loss),
                                   **_grad_diff(tf32_grads, cpu_grads)}

        # the GN's share of the backward: the same batch without the solve
        big = _train_batch(LabeledDeformDataset(root, "train", input_size=TRAIN_CROP, max_nodes=128), [0, 1, 2, 3], 2)
        big = train.batch_to_device(big, "cuda")
        backward = {}
        for iterations in (3, 0):
            m = _stage_model("1_solver", trained, "cuda", gn_iterations=iterations)
            opt, sched = train._stage_optimizer(train.STAGES["1_solver"], m, 1e-4, use_adam=False)
            step = train.make_train_step(m, opt, train.STAGES["1_solver"], sched)
            times = []
            for _ in range(3):
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                step(big, marks)
                torch.cuda.synchronize()
                times.append(marks[1].elapsed_time(marks[2]))
            backward[iterations] = float(np.median(times[1:]))
            if iterations == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(big)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    step(big)
                    torch.cuda.synchronize()
                events = prof.key_averages()
                kernels = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                                 key=lambda e: -device_us(e))
                device_ms = sum(device_us(e) for e in kernels) / 1e3
                row["traced_step"] = {
                    "step_wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
                    "kernel_launches": sum(e.count for e in kernels),
                    "top_device_ops": [{"name": e.key[:70], "device_ms": device_us(e) / 1e3, "calls": e.count}
                                       for e in kernels[:8]],
                }
        row["backward_ms_gn3"], row["backward_ms_gn0"] = backward[3], backward[0]
        row["gn_backward_share"] = (backward[3] - backward[0]) / backward[3]
    row["launches"] = launches
    emit(row)
    return launches


# salient-object detection: the reference's default model (U2NET, full
# width) on seeded weights, at its 320x320 input, over 480x640 colour frames
SOD_FRAMES = 4
SOD_FRAME_SIZE = (480, 640)
# the SPMD frame loop: two ranks on the one card (gloo on CUDA tensors), the
# main path's slice for 3 fitted frames; a hung rank fails the phase
SPMD_RANKS = 2
SPMD_FITTED_FRAMES = 3
SPMD_TIMEOUT_S = 420.0
# the two-rank loop's node translations against the first single-process
# run, within 1e-3 m (a quarter of a voxel). Every float sum on the card
# has a fixed order (ops/segment_sum.py), so the single process repeats bit
# for bit: its SPMD_SINGLE_RUNS runs must be equal (spread 0). The two
# ranks add their halves of the data term onto a chain, each half summed in
# one fixed order, which rounds differently from one process's single sum;
# the fit grows that difference frame by frame, so the loop's error is a
# fixed number per build, printed beside the bound. The fixed-input step
# (the same inputs on both sides, no frame feedback) is held to 1e-5, and
# the CPU tests hold the loop bit for bit
SPMD_SINGLE_RUNS = 3
SPMD_LOOP_TOL = 1e-3


def _sod_frames(folder: Path, count: int, size) -> None:
    """``count`` PNG colour frames: a warm disc sliding over a cool noisy
    background."""
    import numpy as np

    from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

    folder.mkdir(parents=True)
    rng = np.random.default_rng(15)
    h, w = size
    v, u = np.mgrid[0:h, 0:w]
    for i in range(count):
        disc = ((u - w / 2 - 30 * i) ** 2 + (v - h / 2) ** 2 < (h / 4) ** 2)[..., None]
        img = np.where(disc, [210, 90, 50], [40, 100, 170]) + rng.integers(0, 30, size=(h, w, 3))
        write_png(folder / f"{i:06d}.png", np.clip(img, 0, 255).astype(np.uint8))


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}, as flax.traverse_util flattens."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def phase_sod() -> dict:
    """generate_masks with the full U2NET over 480x640 PNG frames; the card's
    fused output against the CPU's; the weights through an .npz and back."""
    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.apps import sod
    from dynamicfuion_python_tpu_torch.apps.profile_frame import use_fp32_matmuls
    from dynamicfuion_python_tpu_torch.apps.train import fp32_step
    from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import (
        load_u2net_checkpoint,
        u2net_flax_from_state_dict,
    )
    from dynamicfuion_python_tpu_torch.models.u2net import U2Net, U2NetFull
    from dynamicfuion_python_tpu_torch.utils.telemetry import read_png

    flags, marks, starts = [], [], []

    def before(module, args):
        if isinstance(module, U2Net) and args[0].is_cuda:
            flags.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            marks.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
            marks[-1][0].record()

    def after(module, args, output):
        if isinstance(module, U2Net) and args[0].is_cuda:
            marks[-1][1].record()

    load_color = sod.load_color

    def timed_load(path):  # each frame starts with its read
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return load_color(path)

    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(before),
             torch.nn.modules.module.register_module_forward_hook(after)]
    sod.load_color = timed_load
    # TF32 on globally: generate_masks must turn it off around its forward
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            _sod_frames(tmp / "color", SOD_FRAMES, SOD_FRAME_SIZE)
            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            written = sod.generate_masks(tmp / "color", tmp / "sod", full_model=True)
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            wall = starts[-1] - t0
            launches = kernel_launches()
            peak = torch.cuda.max_memory_allocated() / 2**20
            masks = [read_png(p) for p in written]
            sod.load_color = load_color
            use_fp32_matmuls()
            # the card's fused output against the CPU's on the first frame
            x = sod.preprocess(load_color(tmp / "color" / "000000.png"), (320, 320))
            card, cpu = sod.build_model(full_model=True), sod.build_model(full_model=True, device="cpu")
            with torch.no_grad(), fp32_step():
                fused_card = card(torch.as_tensor(x, device="cuda"))[0].cpu()
            with torch.no_grad():
                fused_cpu = cpu(torch.as_tensor(x))[0]
            err = float((fused_card - fused_cpu).abs().max())
            # the weights as Flax variables in an .npz, and back
            state = {k: v.cpu() for k, v in card.state_dict().items()}
            np.savez(tmp / "u2net.npz", **_flatten(u2net_flax_from_state_dict(state)))
            back = U2NetFull()
            load_u2net_checkpoint(back, tmp / "u2net.npz")
            round_trip = all(torch.equal(v, state[k]) for k, v in back.state_dict().items())
    finally:
        sod.load_color = load_color
        for h in hooks:
            h.remove()
        use_fp32_matmuls()
    torch.cuda.synchronize()
    forward_ms = [a.elapsed_time(b) for a, b in marks]
    frame_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    row = {
        "phase": "sod", "model": "U2NET", "frames": len(written), "frame_size": list(SOD_FRAME_SIZE),
        "input_size": [320, 320], "parameters": sum(v.numel() for v in state.values()),
        "wall_s": wall, "frame_ms": frame_ms, "steady_frame_ms": float(np.median(frame_ms[1:])),
        "forward_event_ms": forward_ms[:SOD_FRAMES], "steady_forward_event_ms": float(np.median(forward_ms[1:SOD_FRAMES])),
        "fused_card_vs_cpu": err, "tf32_flags_in_forward": sorted(set(flags)), "npz_round_trip": round_trip,
        "launches": launches, "peak_mem_mib": peak,
        "mask_mean_grey": [float(m.mean()) for m in masks],
    }
    emit(row)
    check(len(masks) == SOD_FRAMES and all(m.dtype == np.uint8 and m.shape == SOD_FRAME_SIZE for m in masks),
          f"sod: masks {[(m.dtype, m.shape) for m in masks]}")
    check(all(m.max() > m.min() for m in masks), "sod: a constant mask")
    check(set(flags) == {(False, False)}, f"sod: the card's forward ran with TF32 flags {sorted(set(flags))}")
    check(err <= 1e-4, f"sod: fused output differs card vs CPU by {err}")
    check(round_trip, "sod: the weights changed through the .npz")
    return launches


def phase_leaf_ops(odometry_call, arrowhead_call, params) -> dict:
    """Grid sampling on the main path's last point cloud, the block-COO
    products on its last arrowhead system and point-to-plane distances, card
    against CPU."""
    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.ops import sampling
    from dynamicfuion_python_tpu_torch.ops.camera import unproject_depth_image
    from dynamicfuion_python_tpu_torch.ops.distances import point_to_plane_distances
    from dynamicfuion_python_tpu_torch.ops.linalg import (
        arrowhead_matvec,
        matmul_block_sparse,
        matmul_block_sparse_dense,
    )
    from dynamicfuion_python_tpu_torch.ops.normals import point_image_normals

    reset_counters()
    prev, cur, intr = odometry_call.args
    f = params.fusion
    points, mask = unproject_depth_image(cur, intr, f.depth_scale, f.far_clip_distance)
    prev_points, _ = unproject_depth_image(prev, intr, f.depth_scale, f.far_clip_distance)
    cloud = points[mask].contiguous()
    row = {"phase": "leaf_ops", "points": cloud.shape[0]}
    for name, size in (("node_coverage", params.graph.node_coverage), ("voxel_size", params.tsdf.voxel_size)):
        card_mean, card_n = sampling.mean_grid_downsample(cloud, size)
        cpu_mean, cpu_n = sampling.mean_grid_downsample(cloud.cpu(), size)
        card_idx, card_m = sampling.median_grid_subsample(cloud, size)
        cpu_idx, cpu_m = sampling.median_grid_subsample(cloud.cpu(), size)
        n = int(cpu_n)
        mean_err = float((card_mean[:n].cpu() - cpu_mean[:n]).abs().max()) if int(card_n) == n else None
        row[name] = {
            "cell": size, "cells": n, "counts_equal": int(card_n) == n and int(card_m) == int(cpu_m),
            "indices_equal": bool(torch.equal(card_idx.cpu(), cpu_idx)), "mean_max_abs_err": mean_err,
            "mean_ms": cuda_time_ms(lambda: sampling.mean_grid_downsample(cloud, size), 5, warmup=1),
            "median_ms": cuda_time_ms(lambda: sampling.median_grid_subsample(cloud, size), 5, warmup=1),
        }
        check(row[name]["counts_equal"] and row[name]["indices_equal"] and mean_err <= 1e-6,
              f"leaf ops: grid sampling at the {name} differs card vs CPU ({row[name]})")

    # the arrowhead system as block-COO: stem diagonal, wings and their
    # transposes, corner blocks; padded wing slots inactive (-1)
    matrix, gradient = arrowhead_call.args[0], arrowhead_call.args[1]
    stem, wing, cols, corner = matrix.diag_blocks, matrix.wing_blocks, matrix.wing_cols.long(), matrix.corner
    n0, k = cols.shape
    nc = corner.shape[0] // 6
    rows = torch.arange(n0, device=cols.device)[:, None].expand(n0, k)
    active = cols >= 0
    wing_coords = torch.stack([torch.where(active, rows, -1), torch.where(active, n0 + cols, -1)], -1).reshape(-1, 2)
    ci = torch.arange(nc, device=cols.device)
    corner_coords = torch.stack(torch.meshgrid(n0 + ci, n0 + ci, indexing="ij"), -1).reshape(-1, 2)
    blocks = torch.cat([stem, wing.reshape(-1, 6, 6), wing.reshape(-1, 6, 6).mT,
                        corner.reshape(nc, 6, nc, 6).permute(0, 2, 1, 3).reshape(-1, 6, 6)])
    coords = torch.cat([torch.arange(n0, device=cols.device)[:, None].expand(n0, 2), wing_coords,
                        wing_coords.flip(1), corner_coords]).to(torch.int32)
    nodes = n0 + nc
    card = matmul_block_sparse_dense(blocks, coords, gradient, nodes)
    cpu = matmul_block_sparse_dense(blocks.cpu(), coords.cpu(), gradient.cpu(), nodes)
    scale = float(cpu.abs().max())
    dense_err = float((card.cpu() - cpu).abs().max())
    matvec_err = float((card - arrowhead_matvec(matrix, gradient)).abs().max())
    # B^T B on the corner's pattern (the wing part of the Schur complement),
    # over at most 2048 wing blocks: the product's cross join is Na x Nb
    used = min(n0, max(1, 2048 // k))
    wt = wing[:used].reshape(-1, 6, 6)
    wc = wing_coords.reshape(n0, k, 2)[:used].reshape(-1, 2).to(torch.int32)
    product = matmul_block_sparse(wt.mT, wc.flip(1), wt, wc, corner_coords.to(torch.int32))
    product_cpu = matmul_block_sparse(wt.mT.cpu(), wc.flip(1).cpu(), wt.cpu(), wc.cpu(), corner_coords.to(torch.int32).cpu())
    product_scale = float(product_cpu.abs().max())
    product_err = float((product.cpu() - product_cpu).abs().max())
    row["block_sparse"] = {
        "nodes": nodes, "stem_blocks": n0, "wing_slots": n0 * k, "corner_blocks": nc * nc, "blocks": blocks.shape[0],
        "dense_product_max_abs_err": dense_err, "dense_product_scale": scale, "vs_arrowhead_matvec": matvec_err,
        "dense_ms": cuda_time_ms(lambda: matmul_block_sparse_dense(blocks, coords, gradient, nodes), 10),
        "sparse_product_stem_rows": used, "sparse_product_pairs": wt.shape[0] ** 2,
        "sparse_product_max_abs_err": product_err, "sparse_product_scale": product_scale,
        "sparse_ms": cuda_time_ms(lambda: matmul_block_sparse(wt.mT, wc.flip(1), wt, wc, corner_coords.to(torch.int32)),
                                  5, warmup=1),
    }
    check(dense_err <= 1e-5 * max(1.0, scale) and matvec_err <= 1e-5 * max(1.0, scale),
          f"leaf ops: block-sparse x dense differs ({row['block_sparse']})")
    check(product_err <= 1e-5 * max(1.0, product_scale), f"leaf ops: block-sparse product differs ({row['block_sparse']})")

    normals = point_image_normals(points)
    card_d = point_to_plane_distances(points, prev_points, normals)
    cpu_d = point_to_plane_distances(points.cpu(), prev_points.cpu(), normals.cpu())
    row["point_to_plane"] = {
        "max_abs_err": float((card_d.cpu() - cpu_d).abs().max()),
        "ms": cuda_time_ms(lambda: point_to_plane_distances(points, prev_points, normals), 20),
    }
    check(row["point_to_plane"]["max_abs_err"] <= 1e-6, f"leaf ops: distances differ ({row['point_to_plane']})")
    launches = kernel_launches()
    row["launches"] = launches
    emit(row)
    return launches


def _spmd_frames(pipe, frames) -> list[dict]:
    """Fuse ``frames`` and time each (host clock, synchronized)."""
    import torch

    rows = []
    for f in frames:
        t0 = time.perf_counter()
        m = pipe.process_frame(f.depth, f.color)
        torch.cuda.synchronize()
        rows.append({"wall_s": time.perf_counter() - t0, "data_loss": m["data_loss"], "valid_solve": m["valid_solve"],
                     "occupied_blocks": int(pipe.volume.occupied_count())})
    return rows


def _spmd_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 17 (a spawned process): the data term and a GN step
    on the fixed inputs, then the slice's frame loop under enable_spmd."""
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice, use_fp32_matmuls
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.parallel import distributed, spmd

    tmp = Path(tmp)
    use_fp32_matmuls()
    dev = distributed.initialize(f"file://{tmp / 'store'}", world, rank, "gloo", device="cuda")
    group = spmd.fusion_group()
    fixed = torch.load(tmp / "fixed.pt", map_location=dev, weights_only=False)
    out = {"device": str(dev)}
    d = list(fixed["data_term"])
    with torch.no_grad():
        h, g, loss, covered, _ = fitter.data_normal_equations(
            *d[:8], spmd.shard_pixel_rows(d[8], group), spmd.shard_pixel_rows(d[9], group), *d[10:], group
        )
        s = list(fixed["step"])
        step = fitter.gauss_newton_step(
            *s[:5], spmd.shard_pixel_rows(s[5], group), spmd.shard_pixel_rows(s[6], group), *s[7:], group=group
        )
    out["fixed"] = {"h": h.cpu(), "g": g.cpu(), "loss": float(loss), "covered": int(covered),
                    "translations": step.field.node_translations.cpu()}
    params, seq = make_slice(frame_count=SPMD_FITTED_FRAMES + 1)
    frames = list(seq)
    pipe = FusionPipeline(params, seq.intrinsics)  # this rank's card
    pipe.initialize(frames[0].depth, frames[0].color)
    pipe.enable_spmd(group)
    reset_counters()
    out["frames"] = _spmd_frames(pipe, frames[1:])
    out["launches"] = kernel_launches()
    out["translations"] = pipe.warp_field.node_translations.cpu()
    torch.save(out, tmp / f"rank{rank}.pt")


def phase_spmd(step_call, data_term_call) -> dict:
    """The SPMD frame loop in two ranks on the one card against the
    single-process port; returns the kernels' launches summed over the
    ranks."""
    import numpy as np
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.parallel import run_ranks

    # the single process on the card, run to run
    params, seq = make_slice(frame_count=SPMD_FITTED_FRAMES + 1)
    frames = list(seq)
    single = []
    for _ in range(SPMD_SINGLE_RUNS):
        pipe = FusionPipeline(params, seq.intrinsics)
        pipe.initialize(frames[0].depth, frames[0].color)
        rows = _spmd_frames(pipe, frames[1:])
        single.append((rows, pipe.warp_field.node_translations.cpu()))
    pairs = [float((a[1] - b[1]).abs().max()) for i, a in enumerate(single) for b in single[i + 1:]]
    spread = max(pairs)
    singles_equal = all(bit_equal(single[0][1], run[1]) for run in single[1:])

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save({"data_term": data_term_call.first_args, "step": step_call.first_args}, tmp / "fixed.pt")
        t0 = time.perf_counter()
        run_ranks(_spmd_rank, SPMD_RANKS, (str(tmp),), timeout_s=SPMD_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(SPMD_RANKS)]

    # the fixed inputs (frame 1 from the identity warp): H / g as phase 7
    # bounds them, translations within 1e-5
    with torch.no_grad():
        h1, g1, l1 = (x.cpu() for x in fitter._DATA_TERMS["face"](*data_term_call.first_args))
        single_step = fitter.gauss_newton_step(*step_call.first_args)
    h_atol, g_atol = 1e-5 * max(1.0, float(h1.abs().max())), 1e-5 * max(1.0, float(g1.abs().max()))
    fixed = ranks[0]["fixed"]
    step_err = float((fixed["translations"] - single_step.field.node_translations.cpu()).abs().max())
    loop_err = float((ranks[0]["translations"] - single[0][1]).abs().max())
    launches = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    single_ms = [r["wall_s"] * 1e3 for rows, _ in single for r in rows[1:]]
    rank_ms = [r["wall_s"] * 1e3 for r in ranks[0]["frames"][1:]]
    row = {
        "phase": "spmd", "ranks": SPMD_RANKS, "backend": "gloo", "devices": [r["device"] for r in ranks],
        "fixed_inputs_sha1": tensor_digest(list(data_term_call.first_args)),
        "fixed_h_max_abs_err": float((fixed["h"] - h1).abs().max()), "fixed_h_atol": h_atol,
        "fixed_g_max_abs_err": float((fixed["g"] - g1).abs().max()), "fixed_g_atol": g_atol,
        "fixed_loss_rel": abs(fixed["loss"] - float(l1)) / max(abs(float(l1)), 1e-30),
        "fixed_step_translation_err": step_err,
        "single_run_pair_distances": pairs, "single_run_spread": spread, "single_runs_bit_equal": singles_equal,
        "loop_tolerance": SPMD_LOOP_TOL, "loop_translation_err": loop_err,
        "ranks_agree": bool(torch.equal(ranks[0]["translations"], ranks[1]["translations"])),
        "frames": [{"rank": rf, "single": sf} for rf, sf in zip(ranks[0]["frames"], single[0][0])],
        "launches_per_rank": [r["launches"] for r in ranks], "ranks_wall_s": ranks_s,
        "steady_frame_ms_1_rank": float(np.median(single_ms)), "steady_frame_ms_2_ranks": float(np.median(rank_ms)),
    }
    emit(row)
    check(violations(fixed["h"], h1, 1e-4, h_atol) == 0 and violations(fixed["g"], g1, 1e-4, g_atol) == 0,
          "spmd: the two ranks' data term differs from one process's")
    check(row["fixed_loss_rel"] <= 1e-5, f"spmd: data loss {fixed['loss']} against {float(l1)}")
    check(step_err <= 1e-5, f"spmd: the fixed step's translations differ by {step_err}")
    check(singles_equal and spread == 0.0, f"spmd: the single-process runs differ (spread {spread})")
    check(loop_err <= SPMD_LOOP_TOL, f"spmd: the loop's translations differ by {loop_err} > {SPMD_LOOP_TOL}")
    check(row["ranks_agree"], "spmd: the ranks' warp fields differ")
    for rf, sf in zip(ranks[0]["frames"], single[0][0]):
        check(all(rf["valid_solve"]) and rf["data_loss"][-1] < rf["data_loss"][0],
              f"spmd: a frame's solve was invalid or its loss did not fall ({rf})")
        check(rf["occupied_blocks"] == sf["occupied_blocks"],
              f"spmd: occupied blocks {rf['occupied_blocks']} against {sf['occupied_blocks']}")
    for r in ranks:
        for name in launches:
            check(r["launches"][name] > 0, f"spmd: kernel {name} was not launched in a rank")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    started = time.perf_counter()

    def run(name, fn, *args):
        """Each phase announces itself first, so a failing log shows where it stopped."""
        emit({"phase": name, "start": True, "at_s": time.perf_counter() - started})
        return fn(*args)

    smi = run("build", phase_build)
    last, launches, fitted, pipe = run("main_path", phase_main_path)
    kernels = run("kernels", phase_kernels, last, launches, fitted)
    run("odometry", phase_odometry, last["odometry"])
    run("entry_point", phase_entry_point)
    run("reference", phase_reference)
    run("data_terms", phase_data_terms, last["data_term"])
    prior_launches = run("neural_prior", phase_neural_prior)
    deform_launches = run("deform_net", phase_deform_net)
    renderer_launches, renderer = run("renderer", phase_renderer, pipe)
    rendered_launches = run("rendered_prior", phase_rendered_prior)
    readout_launches = run("volume_readout", phase_volume_readout, pipe)
    indexed_launches, b2_headline = run("indexed", phase_indexed)
    train_launches = run("train", phase_train, smi)
    sod_launches = run("sod", phase_sod)
    leaf_launches = run("leaf_ops", phase_leaf_ops, last["odometry"], last["arrowhead"], pipe.params)
    spmd_launches = run("spmd", phase_spmd, last["gn_step"], last["data_term"])
    for k in kernels:
        for run_name, counts in prior_launches.items():
            k[f"launches_neural_prior_{run_name}"] = counts[k["name"]]
        k["launches_deform_net"] = deform_launches[k["name"]]
        k["launches_renderer"] = renderer_launches[k["name"]]
        for run_name, counts in rendered_launches.items():
            k[f"launches_rendered_prior_{run_name}"] = counts[k["name"]]
        k["launches_volume_readout"] = readout_launches[k["name"]]
        k["launches_indexed"] = indexed_launches[k["name"]]
        k["launches_train"] = train_launches[k["name"]]
        k["launches_sod"] = sod_launches[k["name"]]
        k["launches_leaf_ops"] = leaf_launches[k["name"]]
        k["launches_spmd"] = spmd_launches[k["name"]]
    b1_row, b2_row = kernels[:2]
    b1_row["renderer_bin_capacity_1024"] = renderer["b1"]
    b2_row["indexed_4470784_faces"] = b2_headline
    emit({"phase": "done", "seconds": time.perf_counter() - started})
    emit({"kernels": kernels})
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
