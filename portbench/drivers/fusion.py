"""Driver of ``FusionPipeline.process_frame``: the closed frame loop, one
frame in flight, as a live capture has.

Set-up: one period of the seeded bending plane, the pipeline built from the
configuration's overrides (with the neural prior on, seeded DeformNet
weights written to the run's scratch directory), ``initialize`` on the
run's first frame and ``warm_frames`` frames. The window then hands frames
in one after another; a frame counts from handing its depth and color in to
its metrics on the host (``process_frame`` synchronizes; the driver
synchronizes again). With ``--trace 1``, ``trace_frames`` more frames run
under the profiler after the window. Then the reference runs its own chain
from the raw frames to a frame drawn from the seed among the window's first
``chain_within``, comparing at the end of the warm-up and there, and
follows the port one step at ``check_frames`` frames drawn among the
window's first ``check_within``.
"""

from __future__ import annotations

import gc
from contextlib import nullcontext
import statistics
import sys
import time

import numpy as np

from portbench.check import fusion as check
from portbench.check.precision import set_fp32
from portbench.counts import raster
from portbench.trace import Ranges, summarize
from portbench.traffic.bending_plane import BendingPlane

RANGES = (
    ("odometry", "ops.rigid_odometry", "rigid_odometry_multi_scale"),
    ("fit", "apps.fusion_pipeline", "fit_to_image"),
    ("volume", "apps.fusion_pipeline", "volume_update"),
    ("volume", "apps.fusion_pipeline", "FusionPipeline._refresh_canonical_mesh"),
    ("prior", "apps.fusion_pipeline", "FusionPipeline._apply_prior"),
    ("b1", "ops.rasterize", "rasterize_tiles"),
    ("b2", "ops.mesh_expand", "expand_project_faces"),
)


def _prior_weights(run) -> list[str]:
    """Seeded DeformNet weights in the run's scratch directory, named by
    ``fusion.prior_checkpoint``."""
    from portbench.weights import deform_net_state, save_state

    path = run.scratch / "deform_net.pt"
    save_state(deform_net_state(run.seed, run.device, use_mask=True), path)
    return [f"fusion.prior_checkpoint={path}"]


def run(run) -> dict:
    import torch

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides
    from dynamicfuion_python_tpu_torch.utils.tensor_io import save_fusion_checkpoint

    set_fp32()
    cuda = torch.device(run.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = run.traffic
    plane = BendingPlane(*t["image_size"], focal=t["focal"], period=t["period"], amplitude=t["amplitude"],
                         noise_mm_at_1m=t["noise_mm_at_1m"])
    period = plane.frames(run.seed)

    def frame(i):
        return period[i % plane.period]

    overrides = list(run.config["overrides"])
    prior_on = apply_overrides(Parameters(), overrides).fusion.use_neural_prior
    if prior_on:
        overrides += _prior_weights(run)
    pipe = FusionPipeline(apply_overrides(Parameters(), overrides), plane.intrinsics, device=run.device)
    warm = t["warm_frames"]
    pipe.initialize(*frame(0))
    start_prior = {}
    for i in range(1, warm + 1):
        with check.prior_outputs(DeformNet, start_prior) if i == warm else nullcontext():
            pipe.process_frame(*frame(i))
    sync()
    start = {**check.snapshot(pipe), "prior": start_prior}
    caps = (pipe._mesh_v_cap, pipe._mesh_t_cap)
    rng = np.random.default_rng([run.seed, 1])
    follow = sorted(int(n) for n in rng.choice(t["check_within"], size=t["check_frames"], replace=False))
    chain = int(rng.integers(t["chain_within"]))
    sample = sorted(set(follow) | {chain})
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    times, iterations, blocks, pre, post = [], [], [], {}, {}
    t_start = time.perf_counter()
    setup_s = t_start - run.t0
    deadline = t_start + run.seconds
    window_s = None
    n = 0
    while True:
        if window_s is None and time.perf_counter() >= deadline:
            window_s = time.perf_counter() - t_start
        if window_s is not None and n > sample[-1]:
            break  # frames past the window run only to reach the sampled ones
        prior = {}
        if n in follow:
            pre[n] = check.snapshot(pipe)
        recording = check.prior_outputs(DeformNet, prior) if n in sample else nullcontext()
        t1 = time.perf_counter()
        with recording:
            metrics = pipe.process_frame(*frame(warm + 1 + n))
        sync()
        dt = time.perf_counter() - t1
        if n in sample:
            post[n] = {**check.snapshot(pipe), "prior": prior}
        if window_s is None:
            times.append(dt)
            iterations.append(len(metrics["data_loss"]))
            blocks.append(metrics["active_blocks"])
        n += 1
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    frames = len(times)
    print(f"window: {frames} frames in {window_s:.3f} s; frame_ms_p90 over {frames} samples", file=sys.stderr)
    print(f"work: {pipe.warp_field.num_nodes} nodes, {pipe.canonical_triangle_count} triangles at the end, mesh "
          f"buckets {caps} after set-up, {(pipe._mesh_v_cap, pipe._mesh_t_cap)} at the end, "
          f"{statistics.mean(blocks):.1f} active blocks per frame, frame ms quartiles "
          f"{[round(q * 1e3, 1) for q in (statistics.quantiles(times, n=4) if frames > 1 else times)]}", file=sys.stderr)
    out = {
        "attempted": frames,
        "failed": 0,
        "end_to_end": {
            "frame_ms": window_s * 1e3 / frames,
            "frame_ms_p90": float(np.percentile(np.asarray(times) * 1e3, 90)),
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        },
        "memory_peak_bytes": max(setup_peak, window_peak),
    }

    if run.trace:
        ranges = Ranges(RANGES, record=("b1", "b2"))
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        k = t["trace_frames"]
        with ranges, torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for i in range(k):
                pipe.process_frame(*frame(warm + 1 + n + i))
            sync()
            traced_s = time.perf_counter() - t1
        trace = summarize(prof, k)
        bound = sum(raster.bound_seconds(raster.b1_work(a[0], a[1], a[2], a[3], kw.get("blur_radius", 0.0)))
                    for a, kw in ranges.calls["b1"])
        bound += sum(raster.bound_seconds(raster.b2_work(a[0].shape[0], a[1].shape[0])) for a, _ in ranges.calls["b2"])
        kernels_ms = trace["range_device_ms"].get("b1", 0.0) + trace["range_device_ms"].get("b2", 0.0)
        print(f"raster: {len(ranges.calls['b1'])} B1 and {len(ranges.calls['b2'])} B2 calls, bound "
              f"{bound * 1e3 / k:.5f} ms a frame, device {kernels_ms:.5f} ms a frame", file=sys.stderr)
        trace.update(
            untraced_ms=statistics.median(times) * 1e3,
            frame_ms=out["end_to_end"]["frame_ms"],
            gn_iterations=statistics.mean(iterations),
            raster={"bound_ms": bound * 1e3 / k, "device_ms": kernels_ms},
            flops_per_frame=run.config.get("flops", {}).get("prior_forward") if prior_on else None,
        )
        out["trace"] = trace
        out["device_trace"] = {"busy_s": trace["busy_s"], "window_s": traced_s, "breakdown": trace["breakdown"]}
        del prof, ranges

    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    keyframe = frame(0) if prior_on else None
    checkpoints = {}
    for n in follow:
        s = pre[n]
        checkpoints[n] = run.scratch / f"state_{n}"
        save_fusion_checkpoint(checkpoints[n], s["volume"], s["warp_field"], n, mesh_state=s["mesh_state"],
                               camera_state={k: s[k] for k in ("extrinsics", "previous_depth", "frames_processed")})
    del pre

    def compare(tf32: bool) -> dict:
        last = warm + 1 + chain
        ref = check.reference_chain(overrides, plane.intrinsics, [frame(i) for i in range(last + 1)],
                                    {warm, last}, run.device, tf32)
        rows = [check.gaps(start, ref[warm]), check.gaps(post[chain], ref[last])]
        for n in follow:
            ref = check.reference_step(overrides, plane.intrinsics, checkpoints[n], frame(warm + 1 + n), run.device,
                                       tf32, keyframe=keyframe)
            rows.append(check.gaps(post[n], ref))
        return check.worst(rows)

    gaps = compare(False)
    out["checks"] = {name: (gaps[name], limit) for name, limit in run.limits.items()}
    if run.control:
        out["control"] = compare(True)
    return out
