"""The neural prior's rendered source-image modes and the rendered-mesh
recorder, the port against the JAX package on the CPU: TestNeuralPrior's
shifted plane at 64x64 with its oracle flow, PREVIOUS_TO_CURRENT (the
keyframe is the model's state before each fit, which is what the renderer
draws), in RENDERED_ONLY and RENDERED_WITH_PREVIOUS_FRAME_OVERLAY. The
rendered source rgbxyz and the final node translations are held to the
tolerances of test_torch_prior_pipeline.py, and the recorder's PNGs to the
JAX recorder's."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from dynamicfuion_python_tpu.apps import fusion_pipeline as JF
from dynamicfuion_python_tpu.settings import Parameters as JParams
from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply
from dynamicfuion_python_tpu.utils.telemetry import TelemetryRecorder as JTelemetry
from dynamicfuion_python_tpu_torch.apps import fusion_pipeline as PF
from dynamicfuion_python_tpu_torch.settings import Parameters as PParams
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides as p_apply
from dynamicfuion_python_tpu_torch.utils.telemetry import TelemetryRecorder as PTelemetry
from test_fusion_pipeline import ShiftedPlaneSequence

SHIFT = 0.08
# test_torch_prior_pipeline.py's overrides (TestNeuralPrior's) with the
# previous frame as the tracking source
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
    "fusion.tracking_span_mode=PREVIOUS_TO_CURRENT",
    "telemetry.print_runtime=false",
    "telemetry.record_rendered_warped_mesh=true",
]


@pytest.fixture(scope="module", params=["RENDERED_ONLY", "RENDERED_WITH_PREVIOUS_FRAME_OVERLAY"])
def rendered_runs(request, tmp_path_factory):
    """Both pipelines, frame 0 and two fitted frames, each with the oracle
    flow of one frame of motion; the prior's source rgbxyz of each frame."""
    out = tmp_path_factory.mktemp("rendered")
    overrides = OVERRIDES + [f"fusion.source_image_mode={request.param}", f"telemetry.output_directory={out}"]
    seq = ShiftedPlaneSequence(shift=SHIFT, image_size=(64, 64), focal=82.0)
    jp = JF.FusionPipeline(j_apply(JParams(), overrides), seq.intrinsics)
    pp = PF.FusionPipeline(p_apply(PParams(), overrides), seq.intrinsics, device="cpu")
    # ~0.8 px faces: a 16x16 tile holds more than the default 256
    pp.fitter_config = dataclasses.replace(pp.fitter_config, max_faces_per_bin=1024)
    jp.telemetry = JTelemetry(jp.params.telemetry, "jax")
    pp.telemetry = PTelemetry(pp.params.telemetry, "port")
    sources = {"jax": [], "port": []}
    for name, pipe in (("jax", jp), ("port", pp)):
        original = pipe._prior_source_rgbxyz

        def record(original=original, name=name):
            value = original()
            sources[name].append(np.asarray(value) if name == "jax" else value.numpy())
            return value

        pipe._prior_source_rgbxyz = record
    f0 = seq.load_frame(0)
    jp.initialize(f0.depth, f0.color)
    pp.initialize(f0.depth, f0.color)
    rows = []
    for i in (1, 2):
        f = seq.load_frame(i)
        flow = seq.oracle_flow(i)
        jm = JF.resolve_frame_metrics(jp.process_frame(f.depth, f.color, prior_flow=flow))
        pm = pp.process_frame(f.depth, f.color, prior_flow=flow)
        rows.append((jm, pm))
    return request.param, rows, sources, jp, pp, out


def _silhouette(covered: np.ndarray) -> np.ndarray:
    """Pixels with a 4-neighbour of the other coverage."""
    edge = np.zeros_like(covered)
    edge[1:] |= covered[1:] != covered[:-1]
    edge[:-1] |= covered[:-1] != covered[1:]
    edge[:, 1:] |= covered[:, 1:] != covered[:, :-1]
    edge[:, :-1] |= covered[:, :-1] != covered[:, 1:]
    return edge


def _assert_coverage(got: np.ndarray, want: np.ndarray, exact: bool) -> np.ndarray:
    """The covered pixels equal, or (after a fit, ``exact`` False) equal but
    on the reference's silhouette: the fit's in-plane null direction leaves
    the two packages' node x / y up to 2e-3 m apart (0.16 px at this focal),
    which moves the rendered patch edge across pixel centers. Returns the
    pixels both cover."""
    assert want.sum() > 500
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        differ = got != want
        assert not (differ & ~_silhouette(want)).any() and differ.sum() <= 0.05 * want.sum()
    return got & want


def test_rendered_source_matches_jax(rendered_runs):
    mode, rows, sources, _, _, _ = rendered_runs
    assert len(sources["port"]) == len(sources["jax"]) == 2
    for frame, (got, want) in enumerate(zip(sources["port"], sources["jax"]), start=1):
        assert got.shape == want.shape == (64, 64, 6)
        # frame 1 renders the unwarped canonical mesh; frame 2 the mesh as
        # each package's frame-1 fit warped it
        both = _assert_coverage(got[..., 5] > 0, want[..., 5] > 0, exact=frame == 1)
        atol = 1e-6 if frame == 1 else 2e-3
        np.testing.assert_allclose(got[both][:, 3:], want[both][:, 3:], atol=atol)  # points
        # colors: the normal shader's gray where the mesh was hit (the
        # scene's keyframes have no color to lay over it), the white
        # background elsewhere; truncated to 8 bits in both
        shaded = _assert_coverage((got[..., :3] < 1).any(-1), (want[..., :3] < 1).any(-1), exact=frame == 1)
        np.testing.assert_allclose(got[shaded][:, :3], want[shaded][:, :3], atol=1.0 / 255 + 1e-6)
        if mode == "RENDERED_ONLY":
            np.testing.assert_array_equal(shaded, both)


def test_rendered_prior_node_translations_match_jax(rendered_runs):
    _, rows, _, jp, pp, _ = rendered_runs
    for jm, pm in rows:
        assert pm["prior_valid"] is True and jm["prior_valid"] is True
        assert pm["prior_matches"] > 100
        assert abs(pm["prior_matches"] - jm["prior_matches"]) <= 0.05 * jm["prior_matches"]
        assert pm["valid_solve"] == jm["valid_solve"]
    jt = np.asarray(jp.warp_field.node_translations)
    pt = pp.warp_field.node_translations.numpy()
    # test_torch_prior_pipeline.py's bounds: the surface normal (z) at
    # 1e-4 m, x / y at 2e-3 m (the fit's in-plane null direction)
    np.testing.assert_allclose(pt[:, 2], jt[:, 2], atol=1e-4)
    np.testing.assert_allclose(pt[:, :2], jt[:, :2], atol=2e-3)
    # the prior recovered the slide: two frames of 8 cm
    np.testing.assert_allclose(float(np.median(pt[:, 0])), 2 * SHIFT, atol=0.02)


def test_rendered_mesh_recorder_files_match_jax(rendered_runs):
    _, _, _, _, _, out = rendered_runs
    names = sorted(p.name for p in (out / "port").glob("*_rendered_*.png"))
    assert names == sorted(p.name for p in (out / "jax").glob("*_rendered_*.png")) and len(names) == 4
    for name in names:
        got = np.asarray(Image.open(out / "port" / name)).astype(np.int64)
        want = np.asarray(Image.open(out / "jax" / name)).astype(np.int64)
        assert got.shape == want.shape and got.shape[:2] == (64, 64)
        if "depth" in name:
            # the mesh after each frame's fit: coverage up to the silhouette
            both = _assert_coverage(got > 0, want > 0, exact=False)
            # millimetres, truncated: the normal (z) agrees to 1e-4 m
            assert np.abs(got - want)[both].max() <= 1
        else:  # the shaded gray, truncated to 8 bits, where both hit the mesh
            both = _assert_coverage((got != 255).any(-1), (want != 255).any(-1), exact=False)
            assert np.abs(got - want)[both].max() <= 1
