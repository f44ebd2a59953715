"""One rank of tests/test_torch_parallel.py's two-rank gloo world on the CPU
(imports torch and the port only). ``run(rank, world, tmp)`` reads the
inputs the test wrote to ``tmp/inputs.pt`` and writes what it computed to
``tmp/rank<r>.pt``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _field(state):
    from dynamicfuion_python_tpu_torch.utils.state_conversion import warp_field_from_numpy

    return warp_field_from_numpy(state, device="cpu")


def _step(problem, config, group=None, global_slabs=False):
    """One GN step of the port on a test problem: single-process (no
    group), distributed_fit_step, or distributed_fit_step_global fed with
    this rank's slab."""
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals
    from dynamicfuion_python_tpu_torch.parallel import distributed, spmd

    field = _field(problem["field"])
    args = (problem["verts"], problem["tris"], problem["ref_pts"], problem["ref_mask"], problem["intr"])
    mode = fitter.IterationMode.ALL
    if group is None:
        verts, tris, pts, mask, intr = (torch.as_tensor(np.array(a)) for a in args)
        tris = tris.to(torch.int32)
        with torch.no_grad():
            pre = fitter.precompute_face_associations(field, verts, tris)
            return fitter.gauss_newton_step(field, verts, tris, mesh_vertex_normals(verts, tris), pre, pts, mask,
                                            intr, config, mode, fitter._max_wing_degree(field))
    if global_slabs:
        pts = spmd.shard_pixel_rows(torch.as_tensor(args[2]), group)
        mask = spmd.shard_pixel_rows(torch.as_tensor(args[3]), group)
        return distributed.distributed_fit_step_global(field, args[0], args[1], pts, mask, args[4], config, mode,
                                                       group, device="cpu")
    return spmd.distributed_fit_step(field, *args, config, mode, group, device="cpu")


def _frame_loop(params, frames, intrinsics, group):
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline, resolve_frame_metrics

    pipe = FusionPipeline(params, intrinsics, device="cpu")
    pipe.initialize(frames[0]["depth"], frames[0]["color"])
    pipe.enable_spmd(group)
    metrics = [resolve_frame_metrics(pipe.process_frame(f["depth"], f["color"])) for f in frames[1:]]
    return {
        "node_translations": pipe.warp_field.node_translations.numpy(),
        "tsdf": pipe.volume.tsdf.numpy(), "weight": pipe.volume.weight.numpy(),
        "data_loss": [m["data_loss"] for m in metrics],
    }


def run(rank: int, world: int, tmp: str) -> None:
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops import native
    from dynamicfuion_python_tpu_torch.ops.rigid_odometry import rigid_odometry_multi_scale
    from dynamicfuion_python_tpu_torch.parallel import distributed, spmd

    tmp = Path(tmp)
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    distributed.initialize(f"file://{tmp / 'store'}", world, rank, "gloo", device="cpu")
    group = spmd.fusion_group()
    solo = torch.distributed.new_group([0])  # every rank takes part in creating it
    out = {}
    out["tiny"] = {}
    for weight in inputs["arap_weights"]:
        config = fitter.FitterConfig(max_iterations=1, use_regularization=True, arap_term_weight=weight)
        step = _step(inputs["tiny"], config, group)
        out["tiny"][weight] = {"node_translations": step[0].node_translations.numpy(), "data_loss": float(step[1])}
    prefix_config = fitter.FitterConfig(max_iterations=1, pixel_compaction_fraction=inputs["prefix_fraction"],
                                        arap_term_weight=inputs["arap_weights"][-1])
    _, data_loss, _, _ = _step(inputs["prefix"], prefix_config, group)
    out["prefix"] = {"data_loss": float(data_loss)}
    res = distributed.distributed_fit_step_global(
        _field(inputs["prefix"]["field"]), inputs["prefix"]["verts"], inputs["prefix"]["tris"],
        *(spmd.shard_pixel_rows(torch.as_tensor(inputs["prefix"][k]), group) for k in ("ref_pts", "ref_mask")),
        inputs["prefix"]["intr"], prefix_config, fitter.IterationMode.ALL, group, device="cpu",
    )
    out["prefix"].update(node_translations=res.field.node_translations.numpy(), cap_kept=float(res.cap_kept))
    if rank == 0:  # a world of one process: the single-process step bit for bit
        got = _step(inputs["tiny"], config, solo, global_slabs=True)
        want = _step(inputs["tiny"], config)
        out["solo"] = {k: (getattr(got, k).numpy(), getattr(want, k).numpy()) for k in ("data_loss", "arap_loss")}
        out["solo"]["node_translations"] = (got.field.node_translations.numpy(), want.field.node_translations.numpy())
    depths = [torch.as_tensor(f["depth"].astype(np.int32)) for f in inputs["odometry_frames"]]
    pose, rmse = rigid_odometry_multi_scale(depths[0], depths[1], torch.as_tensor(inputs["intrinsics"]), group=group)
    out["odometry"] = {"pose": pose.numpy(), "rmse": float(rmse)}
    native.reset_launch_counts()
    out["loop"] = _frame_loop(inputs["params"], inputs["frames"], inputs["intrinsics"], group)
    torch.save(out, tmp / f"rank{rank}.pt")
