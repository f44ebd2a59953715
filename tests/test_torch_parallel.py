"""The port's multi-process layer (parallel/, FusionPipeline.enable_spmd) in
a world of two gloo ranks on the CPU, spawned with a FileStore rendezvous
under tmp_path (no TCP port to collide on) and a deadline, against the JAX
package's single-device step and the port's single-process runs:

- distributed_fit_step on __graft_entry__._tiny_problem(64x32) against the
  port's single-process step and the JAX _gauss_newton_step (translations
  atol 1e-5, data loss rtol 1e-4, as tests/test_parallel.py::TestDistributedFit
  holds). At the default ARAP weight (200) this problem's stem blocks reach
  a condition number of 1e7 and the f32 Schur complement cancels
  catastrophically in both packages (the port escalates its damping 4
  times, JAX's own answer is 35% off the f64 solution), so the two packages
  are held to each other at ARAP weight 20, the weight of
  test_torch_fitter.py, and the distributed step to the single-process one
  at both;
- a frame whose compaction cap binds and whose first slab holds more
  covered pixels than its half of the cap: each rank keeps its pixels whose
  rank in the frame is below the cap, as the single-process step does;
- distributed_fit_step_global in a world of one rank equals the
  single-process step bit for bit;
- rigid odometry with the source rows split over the ranks;
- enable_spmd on tests/test_parallel.py::TestShardedFrameLoop's 64x96 scene
  against the single-process port (translations and TSDF atol 1e-5, weights
  equal, data loss rtol 1e-4).
"""

import dataclasses
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dynamicfuion_python_tpu.models.fitter as JF
import dynamicfuion_python_tpu_torch.models.fitter as PF
from __graft_entry__ import _tiny_problem
from dynamicfuion_python_tpu.ops.normals import mesh_vertex_normals as j_normals

import _torch_spmd_worker as worker

WORLD = 2
DEADLINE_S = 240.0
PREFIX_FRACTION = 0.3
ARAP_WEIGHTS = (200.0, 20.0)  # the default, then the one both packages solve well in f32
LOOP_OVERRIDES = [
    "tsdf.voxel_size=0.01", "tsdf.sdf_truncation_distance=0.04", "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12", "graph.layer_count=2", "graph.erosion_num_iterations=1",
    "alignment.max_iteration_count=2", "alignment.arap_term_weight=20.0", "alignment.use_rigid_alignment=false",
    "fusion.far_clip_distance=2.0", "fusion.extraction_max_triangles=60000", "telemetry.print_runtime=false",
]


def _problem(image_size):
    field, verts, tris, ref_pts, ref_mask, intr = _tiny_problem(image_size=image_size)
    state = {f.name: (np.array(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(field)
             for v in [getattr(field, f.name)]}
    numpy = dict(field=state, verts=np.asarray(verts), tris=np.asarray(tris), ref_pts=np.asarray(ref_pts),
                 ref_mask=np.asarray(ref_mask), intr=np.asarray(intr))
    return (field, verts, tris, ref_pts, ref_mask, intr), numpy


def _jax_step(jax_problem, config):
    field, verts, tris, ref_pts, ref_mask, intr = jax_problem
    pre = JF.precompute_face_associations(field, verts, tris)
    out = JF._gauss_newton_step(field, verts, tris, j_normals(verts, tris), pre, ref_pts, ref_mask, intr, config,
                                JF.IterationMode.ALL, JF._max_wing_degree(field))
    return np.asarray(out[0].node_translations), float(out[1])


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    """Start the two ranks, compute the references while they run, then
    collect both ranks' results."""
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
    from dynamicfuion_python_tpu_torch.parallel import run_ranks
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    tmp = tmp_path_factory.mktemp("spmd")
    tiny_j, tiny_np = _problem((64, 32))
    prefix_j, prefix_np = _problem((64, 64))
    params = apply_overrides(Parameters(), LOOP_OVERRIDES)
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = [{"depth": f.depth, "color": f.color} for f in seq]
    torch.save({"tiny": tiny_np, "prefix": prefix_np, "prefix_fraction": PREFIX_FRACTION,
                "arap_weights": ARAP_WEIGHTS, "params": params,
                "frames": frames, "intrinsics": np.asarray(seq.intrinsics), "odometry_frames": frames[:2]},
               tmp / "inputs.pt")
    failure = []

    def ranks():
        try:
            run_ranks(worker.run, WORLD, (str(tmp),), timeout_s=DEADLINE_S)
        except Exception as exc:  # re-raised in the test thread
            failure.append(exc)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = {
            "tiny_jax": _jax_step(tiny_j, JF.FitterConfig(max_iterations=1, arap_term_weight=ARAP_WEIGHTS[1])),
            "tiny_port": {w: worker._step(tiny_np, PF.FitterConfig(max_iterations=1, arap_term_weight=w))
                          for w in ARAP_WEIGHTS},
            "prefix_jax": _jax_step(prefix_j, JF.FitterConfig(max_iterations=1, arap_term_weight=ARAP_WEIGHTS[1],
                                                              pixel_compaction_fraction=PREFIX_FRACTION)),
            "prefix_port": _port_prefix_reference(prefix_np),
            "loop": _single_loop(params, frames, seq.intrinsics),
            "odometry": _single_odometry(frames, seq.intrinsics),
        }
    finally:
        thread.join()
    if failure:
        raise failure[0]
    return ref, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _port_prefix_reference(problem):
    """The single-process port step on the prefix frame, and the covered
    pixels of each half of the frame (from the face term's arguments)."""
    seen = {}
    face = PF._DATA_TERMS["face"]

    def record(*args, **kwargs):
        seen["frag"], seen["mask"] = args[7], args[9]
        return face(*args, **kwargs)

    PF._DATA_TERMS["face"] = record
    try:
        out = worker._step(problem, PF.FitterConfig(max_iterations=1, pixel_compaction_fraction=PREFIX_FRACTION,
                                                    arap_term_weight=ARAP_WEIGHTS[1]))
    finally:
        PF._DATA_TERMS["face"] = face
    covered = ((seen["frag"] >= 0) & seen["mask"]).sum(dim=1)
    half = covered.shape[0] // 2
    return {"node_translations": out.field.node_translations.numpy(), "data_loss": float(out.data_loss),
            "cap_kept": float(out.cap_kept), "covered_halves": (int(covered[:half].sum()), int(covered[half:].sum())),
            "cap": PF.compaction_cap(seen["frag"].numel(), PREFIX_FRACTION)}


def _single_loop(params, frames, intrinsics):
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline, resolve_frame_metrics

    pipe = FusionPipeline(params, intrinsics, device="cpu")
    pipe.initialize(frames[0]["depth"], frames[0]["color"])
    metrics = [resolve_frame_metrics(pipe.process_frame(f["depth"], f["color"])) for f in frames[1:]]
    return {"node_translations": pipe.warp_field.node_translations.numpy(), "tsdf": pipe.volume.tsdf.numpy(),
            "weight": pipe.volume.weight.numpy(), "data_loss": [m["data_loss"] for m in metrics]}


def _single_odometry(frames, intrinsics):
    from dynamicfuion_python_tpu_torch.ops.rigid_odometry import rigid_odometry_multi_scale

    d0, d1 = (torch.as_tensor(f["depth"].astype(np.int32)) for f in frames[:2])
    pose, rmse = rigid_odometry_multi_scale(d0, d1, torch.as_tensor(np.asarray(intrinsics)))
    return {"pose": pose.numpy(), "rmse": float(rmse)}


@pytest.mark.parametrize("weight", ARAP_WEIGHTS)
def test_distributed_fit_step_matches_the_single_step(spmd_run, weight):
    ref, ranks = spmd_run
    single = ref["tiny_port"][weight]
    for out in ranks:
        got = out["tiny"][weight]
        np.testing.assert_allclose(got["node_translations"], single.field.node_translations.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["data_loss"], float(single.data_loss), rtol=1e-4)
        if weight == ARAP_WEIGHTS[1]:
            want_t, want_loss = ref["tiny_jax"]
            np.testing.assert_allclose(got["node_translations"], want_t, atol=1e-5)
            np.testing.assert_allclose(got["data_loss"], want_loss, rtol=1e-4)
    np.testing.assert_array_equal(ranks[0]["tiny"][weight]["node_translations"],
                                  ranks[1]["tiny"][weight]["node_translations"])


def test_compaction_cap_is_the_frame_s(spmd_run):
    ref, ranks = spmd_run
    port = ref["prefix_port"]
    top, bottom = port["covered_halves"]
    # the cap binds, and the first slab alone holds more covered pixels than
    # its half of the cap: a per-slab cap would keep other pixels
    assert top + bottom > port["cap"] and top > port["cap"] // 2 and port["cap_kept"] < 1.0
    want_t, want_loss = ref["prefix_jax"]
    np.testing.assert_allclose(port["node_translations"], want_t, atol=1e-5)
    for out in ranks:
        got = out["prefix"]
        assert got["cap_kept"] == port["cap_kept"]
        np.testing.assert_allclose(got["node_translations"], port["node_translations"], atol=1e-5)
        np.testing.assert_allclose(got["node_translations"], want_t, atol=1e-5)
        np.testing.assert_allclose(got["data_loss"], port["data_loss"], rtol=1e-4)
        np.testing.assert_allclose(got["data_loss"], want_loss, rtol=1e-4)


def test_global_step_in_a_world_of_one_is_the_single_step(spmd_run):
    _, ranks = spmd_run
    for key, (got, want) in ranks[0]["solo"].items():
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_odometry_over_row_slabs(spmd_run):
    ref, ranks = spmd_run
    for out in ranks:
        np.testing.assert_allclose(out["odometry"]["pose"], ref["odometry"]["pose"], atol=1e-6)
        np.testing.assert_allclose(out["odometry"]["rmse"], ref["odometry"]["rmse"], rtol=1e-5)


def test_enable_spmd_frame_loop_matches_single_process(spmd_run):
    ref, ranks = spmd_run
    want = ref["loop"]
    for out in ranks:
        got = out["loop"]
        np.testing.assert_allclose(got["node_translations"], want["node_translations"], atol=1e-5)
        np.testing.assert_allclose(got["tsdf"], want["tsdf"], atol=1e-5)
        np.testing.assert_array_equal(got["weight"], want["weight"])
        for a, b in zip(got["data_loss"], want["data_loss"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # the ranks hold the same replicated state
    for key in ("node_translations", "tsdf", "weight"):
        np.testing.assert_array_equal(ranks[0]["loop"][key], ranks[1]["loop"][key])


def test_shard_helpers_without_a_group(monkeypatch):
    """The row and block splits the ranks use: contiguous, covering, the
    shares differing by at most one."""
    from dynamicfuion_python_tpu_torch.parallel import spmd

    for world in (1, 2, 3, 8):
        for count in (0, 5, 64, 481):
            bounds = []
            for rank in range(world):
                monkeypatch.setattr(spmd, "group_size", lambda g, w=world: w)
                monkeypatch.setattr(spmd, "group_rank", lambda g, r=rank: r)
                bounds.append(spmd.shard_blocks(count, None))
                assert spmd.row_range(count, None) == bounds[-1]
            assert bounds[0][0] == 0 and bounds[-1][1] == count
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            sizes = [b - a for a, b in bounds]
            assert max(sizes) - min(sizes) <= 1
    monkeypatch.setattr(spmd, "group_size", lambda g: 2)
    with pytest.raises(ValueError, match="evenly"):
        spmd.shard_pixel_rows(torch.zeros(5, 3), None)
