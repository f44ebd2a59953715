"""The fusion pipeline with the neural tracking prior, the port against the
JAX package on the CPU: TestNeuralPrior's laterally shifted plane with its
oracle flow, the tracking-span modes (keyframe rolls, a 3-frame
KEYFRAME_TO_CURRENT run, shortest-path pixel anchors), the correspondence
telemetry, and the prior's DeformNet loaded from a checkpoint file."""

import dataclasses

import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.apps import fusion_pipeline as JF
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.ops import graph_construction as JGC
from dynamicfuion_python_tpu.settings import Parameters as JParams
from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply
from dynamicfuion_python_tpu.utils.telemetry import TelemetryRecorder as JTelemetry
from dynamicfuion_python_tpu_torch.apps import fusion_pipeline as PF
from dynamicfuion_python_tpu_torch.settings import Parameters as PParams
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides as p_apply
from dynamicfuion_python_tpu_torch.utils.telemetry import TelemetryRecorder as PTelemetry
from test_fusion_pipeline import ShiftedPlaneSequence

# TestNeuralPrior's overrides, plus a 65536-face mesh bucket: the JAX
# fitter's splat rasterizer then holds every face of the ~1.6 px faces here
OVERRIDES = [
    "tsdf.voxel_size=0.01",
    "tsdf.sdf_truncation_distance=0.04",
    "tsdf.initial_block_count=1024",
    "graph.node_coverage=0.12",
    "graph.layer_count=2",
    "graph.erosion_num_iterations=1",
    "alignment.max_iteration_count=4",
    "alignment.arap_term_weight=20.0",
    "alignment.use_rigid_alignment=false",
    "fusion.far_clip_distance=2.0",
    "fusion.extraction_max_triangles=120000",
    "fusion.mesh_capacity_hint=65536",
    "telemetry.print_runtime=false",
]


def _pipelines(overrides, intrinsics):
    jp = JF.FusionPipeline(j_apply(JParams(), overrides), intrinsics)
    pp = PF.FusionPipeline(p_apply(PParams(), overrides), intrinsics, device="cpu")
    # small faces: a 16x16 tile holds more than the default 256
    pp.fitter_config = dataclasses.replace(pp.fitter_config, max_faces_per_bin=1024)
    return jp, pp


def _shifted_run(overrides, frames: int, flow_from_keyframe: bool, telemetry_dir=None):
    """Both pipelines over the shifted plane with the oracle flow from the
    tracking source (frame 0, or the keyframe) to each frame."""
    seq = ShiftedPlaneSequence(shift=0.08)
    jp, pp = _pipelines(overrides, seq.intrinsics)
    if telemetry_dir is not None:
        jp.telemetry = JTelemetry(jp.params.telemetry, "jax")
        pp.telemetry = PTelemetry(pp.params.telemetry, "port")
    f0 = seq.load_frame(0)
    jp.initialize(f0.depth, f0.color)
    pp.initialize(f0.depth, f0.color)
    rows = []
    keyframe = 0
    for i in range(1, frames):
        f = seq.load_frame(i)
        flow = seq.oracle_flow(i) * (i - keyframe if flow_from_keyframe else 1)
        jm = JF.resolve_frame_metrics(jp.process_frame(f.depth, f.color, prior_flow=flow))
        pm = pp.process_frame(f.depth, f.color, prior_flow=flow)
        rows.append((jm, pm, np.asarray(jp.warp_field.node_translations), pp.warp_field.node_translations.numpy()))
        if pp._keyframe_should_roll():
            keyframe = i
    return jp, pp, rows


def _assert_translations_match(pt, jt):
    # the surface normal (z for this fronto-parallel plane) at 1e-4 m; x / y
    # at 2e-3 m, the pipeline tests' bound for the fit's in-plane null
    # direction (ROADMAP C)
    np.testing.assert_allclose(pt[:, 2], jt[:, 2], atol=1e-4)
    np.testing.assert_allclose(pt[:, :2], jt[:, :2], atol=2e-3)


@pytest.fixture(scope="module")
def shifted_pair(tmp_path_factory):
    """TestNeuralPrior's two frames through both pipelines, with the
    correspondence recorders on."""
    out = tmp_path_factory.mktemp("prior_telemetry")
    overrides = OVERRIDES + ["telemetry.record_correspondences=true", f"telemetry.output_directory={out}"]
    _, _, rows = _shifted_run(overrides, 2, flow_from_keyframe=False, telemetry_dir=out)
    return rows, out


def test_prior_bootstraps_the_fitter_like_jax(shifted_pair):
    """TestNeuralPrior: the oracle flow's prior lets the fit recover the
    8 cm lateral shift that point-to-plane fitting alone cannot see."""
    ((jm, pm, jt, pt),), _ = shifted_pair
    assert pm["prior_valid"] is True and jm["prior_valid"] is True
    assert pm["prior_matches"] == jm["prior_matches"] > 100
    assert pm["valid_solve"] == jm["valid_solve"]
    _assert_translations_match(pt, jt)
    # the JAX test's gates
    np.testing.assert_allclose(float(np.median(pt[:, 0])), 0.08, atol=0.02)
    assert float(np.median(np.abs(pt[:, 1]))) < 0.02


def test_correspondence_telemetry_matches_jax(shifted_pair):
    _, out = shifted_pair
    want = np.load(out / "jax" / "000001_correspondences.npz")
    got = np.load(out / "port" / "000001_correspondences.npz")
    assert sorted(got.files) == sorted(want.files) == ["correspondence_mask", "source_points"]
    np.testing.assert_allclose(got["source_points"], want["source_points"], atol=1e-6)
    np.testing.assert_array_equal(got["correspondence_mask"], want["correspondence_mask"])
    assert got["correspondence_mask"].sum() > 100


@pytest.mark.parametrize("anchors", ["EUCLIDEAN", "SHORTEST_PATH"])
def test_keyframe_to_current_three_frames(anchors):
    """KEYFRAME_TO_CURRENT with keyframe_interval=2: frames 1 and 2 track
    from frame 0, then the keyframe rolls to frame 2."""
    overrides = OVERRIDES + [
        "fusion.tracking_span_mode=KEYFRAME_TO_CURRENT", "fusion.keyframe_interval=2",
        f"fusion.pixel_anchor_computation_mode={anchors}",
    ]
    _, pp, rows = _shifted_run(overrides, 3, flow_from_keyframe=True)
    for frame, (jm, pm, jt, pt) in enumerate(rows, start=1):
        assert pm["prior_valid"] == jm["prior_valid"] is True
        assert pm["prior_matches"] == jm["prior_matches"] > 100
        _assert_translations_match(pt, jt)
        np.testing.assert_allclose(float(np.median(pt[:, 0])), 0.08 * frame, atol=0.02)
    assert pp.frames_processed == 2
    np.testing.assert_array_equal(pp.keyframe_source[0].numpy(), ShiftedPlaneSequence(shift=0.08).load_frame(2).depth)
    np.testing.assert_array_equal(pp.keyframe_translations.numpy(), pp.warp_field.node_translations.numpy())
    assert pp.keyframe_anchors is None  # recomputed from the new keyframe
    # the node graph: the JAX function on the port's nodes (the two graphs'
    # node positions agree to 1e-6 m, not bit for bit, and equidistant grid
    # neighbours then tie-break apart)
    want = JGC.compute_edges_euclidean(pp.warp_field.node_positions.numpy(), 8, 0.12)[0]
    np.testing.assert_array_equal(pp._node_graph_edges(), want)


def test_previous_to_current_rolls_keyframe():
    """tests/test_fusion_pipeline.py's keyframe test on the port (no prior):
    the keyframe is the previous frame and its transforms."""
    overrides = OVERRIDES + ["fusion.tracking_span_mode=PREVIOUS_TO_CURRENT"]
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(96, 128), bend_per_frame=0.01, focal=160.0)
    frames = [seq.load_frame(i) for i in range(3)]
    _, pp = _pipelines(overrides, seq.intrinsics)
    pp.initialize(frames[0].depth, frames[0].color)
    np.testing.assert_array_equal(pp.keyframe_source[0].numpy(), frames[0].depth)
    pp.process_frame(frames[1].depth, frames[1].color)
    np.testing.assert_array_equal(pp.keyframe_translations.numpy(), pp.warp_field.node_translations.numpy())
    np.testing.assert_array_equal(pp.keyframe_source[0].numpy(), frames[1].depth)


def test_checkpoint_prior_runs_on_every_fitted_frame(tmp_path):
    """fusion.use_neural_prior with a DeformNet checkpoint (seeded weights,
    written as .pt) on a 64x128 bending plane with rigid odometry on: the
    prior runs through the loaded network on every fitted frame and every
    output stays finite. Random weights give no meaningful flow, so the
    prior's validity is not held to anything."""
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict

    path = tmp_path / "deform_net.pt"
    torch.save(seeded_state_dict(DeformNet(), torch.Generator().manual_seed(0)), path)
    params = p_apply(PParams(), OVERRIDES[:-1] + [
        "alignment.use_rigid_alignment=true", "alignment.max_iteration_count=2",
        "fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}",
        f"telemetry.output_directory={tmp_path}", "telemetry.print_runtime=false",
    ])
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 128), bend_per_frame=0.02, focal=90.0)
    result = PF.run_fusion(seq, params, run_name="prior", device="cpu")
    fitted = result.summary["frames"][1:]
    assert len(fitted) == 2
    for frame in fitted:
        assert isinstance(frame["prior_valid"], bool) and frame["prior_matches"] >= 0
        assert all(np.isfinite(frame["data_loss"]))
    assert np.isfinite(result.warp_field.node_translations.numpy()).all()
    assert np.isfinite(result.canonical_mesh).all() and len(result.canonical_mesh) > 100
