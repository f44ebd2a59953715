"""The port's default configuration against the JAX package, on the CPU:
the fusion loop with rigid odometry on, and the depth-image and loaded-graph
modes (with the loaded graph's coverage crop). NTIO files, checkpoints,
``run_fusion``, telemetry and the CLI are in ``test_torch_run_fusion.py``.

The pipeline runs the 64x96 bending plane of ``test_torch_fusion_pipeline.py``
with rigid odometry on. On the 96x128 plane with the overrides of
``tests/test_fusion_pipeline.py`` frame 2's odometry slides the camera
~14 cm along the bend, GN iterations 2-4 fail the valid-solve guard in both
packages, and the JAX package alone moves its final node translations by
2e-4 m for a 1e-6 m change of its state after frame 1: no port can be held
to 1e-4 m there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.apps import fusion_pipeline as JF
from dynamicfuion_python_tpu.apps.create_graph_data import save_graph_data
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.settings import Parameters as JParams
from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply
from dynamicfuion_python_tpu_torch.apps import fusion_pipeline as PF
from dynamicfuion_python_tpu_torch.data.frame_sequence import FrameSequenceDataset
from dynamicfuion_python_tpu_torch.settings import Parameters as PParams
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides as p_apply

OVERRIDES = [
    "tsdf.voxel_size=0.01",
    "tsdf.sdf_truncation_distance=0.04",
    "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12",
    "graph.layer_count=2",
    "graph.erosion_num_iterations=1",
    "alignment.max_iteration_count=2",
    "alignment.arap_term_weight=20.0",
    "fusion.far_clip_distance=2.0",
    "fusion.extraction_max_triangles=60000",
    "fusion.mesh_capacity_hint=65536",
    "telemetry.print_runtime=false",
]
EMPTY_KEY = 2**31 - 1


def _seq(frames: int):
    return SyntheticBendingPlaneSequence(frame_count=frames, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)


def _port_pipeline(params, intrinsics):
    pp = PF.FusionPipeline(params, intrinsics, device="cpu")
    # ~1 px faces: a 16x16 tile holds ~400 of them
    pp.fitter_config = dataclasses.replace(pp.fitter_config, max_faces_per_bin=1024)
    return pp


# -- the fusion loop with rigid odometry on ----------------------------------


@pytest.fixture(scope="module")
def rigid_runs():
    seq = _seq(4)
    frames = list(seq)
    jp = JF.FusionPipeline(j_apply(JParams(), OVERRIDES), seq.intrinsics)
    pp = _port_pipeline(p_apply(PParams(), OVERRIDES), seq.intrinsics)
    assert pp.params.alignment.use_rigid_alignment  # the default
    jp.initialize(frames[0].depth, frames[0].color)
    pp.initialize(frames[0].depth, frames[0].color)
    rows = []
    for f in frames[1:]:
        jm = JF.resolve_frame_metrics(jp.process_frame(f.depth, f.color))
        pm = pp.process_frame(f.depth, f.color)
        rows.append((jm, pm, np.asarray(jp.extrinsics), pp.extrinsics.numpy()))
    return jp, pp, rows


def test_rigid_pipeline_poses_and_metrics(rigid_runs):
    _, _, rows = rigid_runs
    for frame, (jm, pm, jx, px) in enumerate(rows, start=1):
        np.testing.assert_allclose(px, jx, atol=1e-4)
        assert abs(pm["rigid_rmse"] - jm["rigid_rmse"]) <= 1e-4
        assert pm["valid_solve"] == jm["valid_solve"]
        assert pm["active_blocks"] == jm["active_blocks"] > 0
        # the first fitted frame runs no odometry: initialize leaves the
        # previous depth unset, in both packages
        assert (pm["rigid_rmse"] > 0) == (frame >= 2)
    assert np.abs(rows[-1][3][:3, 3]).max() > 1e-3  # the camera did move


def test_rigid_pipeline_node_translations(rigid_runs):
    jp, pp, _ = rigid_runs
    jt = np.asarray(jp.warp_field.node_translations)
    pt = pp.warp_field.node_translations.numpy()
    # the normal (z) component tight; in-plane sliding is the fit's null
    # direction (test_torch_fusion_pipeline.py)
    np.testing.assert_allclose(pt[:, 2], jt[:, 2], atol=1e-4)
    np.testing.assert_allclose(pt[:, :2], jt[:, :2], atol=2e-3)


def test_rigid_pipeline_independent_of_the_thread_count(rigid_runs):
    """The port's rigid run with 2 CPU threads equals the fixture's run with
    the default count, bit for bit. Before the odometry's pixel sums went to
    f64 the two differed by up to 1.5e-4 m in the final node translations
    (1-8 threads), which made test_rigid_pipeline_node_translations pass or
    fail with the machine's core count (test_torch_rigid_odometry.py)."""
    _, pp, rows = rigid_runs
    seq = _seq(4)
    frames = list(seq)
    default = torch.get_num_threads()
    torch.set_num_threads(2 if default != 2 else 1)
    try:
        other = _port_pipeline(p_apply(PParams(), OVERRIDES), seq.intrinsics)
        other.initialize(frames[0].depth, frames[0].color)
        for f in frames[1:]:
            other.process_frame(f.depth, f.color)
    finally:
        torch.set_num_threads(default)
    assert torch.equal(other.extrinsics, pp.extrinsics)
    assert torch.equal(other.warp_field.node_translations, pp.warp_field.node_translations)


# -- graph modes -------------------------------------------------------------


def test_depth_image_graph_mode():
    seq = _seq(1)
    frame = seq.load_frame(0)
    mode = ["fusion.graph_generation_mode=FIRST_FRAME_DEPTH_IMAGE"]
    jp = JF.FusionPipeline(j_apply(JParams(), OVERRIDES + mode), seq.intrinsics)
    pp = _port_pipeline(p_apply(PParams(), OVERRIDES + mode), seq.intrinsics)
    jp.initialize(frame.depth, frame.color)
    pp.initialize(frame.depth, frame.color)
    assert pp.warp_field.num_nodes == jp.warp_field.num_nodes >= 4
    np.testing.assert_allclose(pp.warp_field.node_positions.numpy(), np.asarray(jp.warp_field.node_positions), atol=1e-6)


def _write_sequence(seq_dir, seq, nodes):
    """A DeepDeform-layout directory + graph blobs written by the JAX
    package (as tests/test_fusion_pipeline.py's loaded-graph test does)."""
    from PIL import Image

    (seq_dir / "depth").mkdir(parents=True)
    for i, frame in enumerate(seq):
        Image.fromarray(frame.depth).save(seq_dir / "depth" / f"{i:06d}.png")
    np.savetxt(seq_dir / "intrinsics.txt", seq.intrinsics)
    n = len(nodes)
    edges = np.full((n, 2), -1, np.int32)
    edges[:-1, 0] = np.arange(1, n)
    h, w = seq.image_size
    save_graph_data(
        seq_dir, "000000", 0.12, nodes, edges, np.where(edges >= 0, 1.0, 0.0).astype(np.float32),
        np.zeros(n, np.int32), np.zeros((h, w, 4), np.int32), np.full((h, w, 4), 0.25, np.float32),
    )


def test_loaded_graph_mode(tmp_path):
    seq = _seq(2)
    nodes = np.asarray([[x, y, 1.0] for x in (-0.15, 0.0, 0.15) for y in (-0.15, 0.0, 0.15)], np.float32)
    _write_sequence(tmp_path / "seq000", seq, nodes)
    ds = FrameSequenceDataset(tmp_path / "seq000")
    graph = ds.get_frame_graph(0)
    assert graph is not None and set(graph) == {
        "nodes", "edges", "edge_weights", "clusters", "node_deformations", "pixel_anchors", "pixel_weights",
    }
    np.testing.assert_array_equal(graph["nodes"], nodes)
    np.testing.assert_array_equal(ds.intrinsics, seq.intrinsics)
    frame = ds.load_frame(0)
    np.testing.assert_array_equal(frame.depth, seq.load_frame(0).depth)

    mode = ["fusion.graph_generation_mode=FIRST_FRAME_LOADED_GRAPH"]
    jp = JF.FusionPipeline(j_apply(JParams(), OVERRIDES + mode), ds.intrinsics)
    pp = _port_pipeline(p_apply(PParams(), OVERRIDES + mode), ds.intrinsics)
    jp.initialize(frame.depth, frame.color, frame_graph=graph)
    pp.initialize(frame.depth, frame.color, frame_graph=graph)
    assert pp.warp_field.num_nodes == 9
    np.testing.assert_allclose(pp.warp_field.node_positions.numpy(), np.asarray(jp.warp_field.node_positions), atol=1e-6)
    np.testing.assert_array_equal(pp.volume.slot_keys.numpy(), np.asarray(jp.volume.slot_keys))
    with pytest.raises(ValueError, match="no precomputed graph"):
        _port_pipeline(p_apply(PParams(), OVERRIDES + mode), ds.intrinsics).initialize(frame.depth, None)


def _crop_scene():
    """TestGraphCoverageCrop's scene: a near subject square over a far
    background, nodes on the subject."""
    depth = np.full((96, 128), 1800, np.uint16)
    depth[24:72, 40:88] = 1000
    intr = np.asarray([[160.0, 0, 64.0], [0, 160.0, 48.0], [0, 0, 1.0]], np.float32)
    nodes = np.asarray([[x, y, 1.0] for x in (-0.12, 0.0, 0.12) for y in (-0.12, 0.0, 0.12)], np.float32)
    return depth, intr, nodes


def test_coverage_crop_matches_jax(record_property):
    depth, intr, nodes = _crop_scene()
    radius = 2 * 0.12
    want = np.asarray(JF._crop_depth_to_coverage_program(
        jnp.asarray(depth), jnp.asarray(nodes), jnp.asarray(intr), 1000.0, 2.0, radius
    ))
    got = PF.crop_depth_to_coverage(
        torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(nodes), torch.as_tensor(intr), 1000.0, 2.0, radius
    ).numpy()
    # pixels within 1e-6 m^2 of the radius^2 may round either way (XLA fuses
    # the squared-distance sum into FMAs)
    v, u = np.mgrid[0:96, 0:128]
    z = depth / 1000.0
    pts = np.stack([(u - intr[0, 2]) / intr[0, 0] * z, (v - intr[1, 2]) / intr[1, 1] * z, z], -1)
    d2 = ((pts[:, :, None, :] - nodes[None, None].astype(np.float64)) ** 2).sum(-1).min(-1)
    tied = np.abs(d2 - radius * radius) <= 1e-6
    record_property("tied_pixels", int(tied.sum()))
    np.testing.assert_array_equal((got > 0)[~tied], (want > 0)[~tied])
    np.testing.assert_array_equal(got[got > 0], depth[got > 0])
    assert 0 < (got > 0).sum() < depth.size


@pytest.mark.parametrize("crop", [True, False])
def test_coverage_crop_background_gates(crop):
    """TestGraphCoverageCrop's gates on the port: with the crop the far
    background is not integrated and every surface vertex lies in the
    graph's coverage region; without it the background is."""
    depth, intr, nodes = _crop_scene()
    overrides = OVERRIDES + [
        "tsdf.initial_block_count=1024",
        "fusion.graph_generation_mode=FIRST_FRAME_LOADED_GRAPH",
        f"fusion.crop_to_graph_coverage={str(crop).lower()}",
    ]
    pp = _port_pipeline(p_apply(PParams(), overrides), intr)
    pp.initialize(depth, None, frame_graph={"nodes": nodes})
    verts = pp.canonical_vertices.numpy()
    verts = verts[np.abs(verts).sum(axis=1) > 0]  # drop capacity padding
    assert len(verts) > 0
    if crop:
        assert verts[:, 2].max() < 1.5
        d = np.linalg.norm(verts[:, None, :] - nodes[None], axis=-1).min(axis=1)
        assert d.max() <= 2 * 0.12 + 0.08
    else:
        assert verts[:, 2].max() > 1.5
