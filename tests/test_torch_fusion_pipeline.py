"""The slice as a whole: three bending-plane frames (64x96, focal 120, the
overrides of the JAX package's sharded-loop test) through the JAX package's
FusionPipeline and the port's, compared frame by frame and at the end."""

import dataclasses

import numpy as np
import pytest

from dynamicfuion_python_tpu.apps.fusion_pipeline import FusionPipeline as JPipe, resolve_frame_metrics
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.settings import Parameters as JParams
from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply
from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline as PPipe
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
    "alignment.use_rigid_alignment=false",
    "fusion.far_clip_distance=2.0",
    "fusion.extraction_max_triangles=60000",
    # a 65536-face bucket: rasterize_splat's default tier caps (which the
    # JAX fitter uses) then hold every face of this ~1 px-per-face mesh
    "fusion.mesh_capacity_hint=65536",
]
EMPTY_KEY = 2**31 - 1


@pytest.fixture(scope="module")
def runs():
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    jp = JPipe(j_apply(JParams(), OVERRIDES), seq.intrinsics)
    pp = PPipe(p_apply(PParams(), OVERRIDES), seq.intrinsics, device="cpu")
    # ~1 px faces: a 16x16 tile holds ~400 of them
    pp.fitter_config = dataclasses.replace(pp.fitter_config, max_faces_per_bin=1024)
    jp.initialize(frames[0].depth, frames[0].color)
    pp.initialize(frames[0].depth, frames[0].color)
    jm = [resolve_frame_metrics(jp.process_frame(f.depth, f.color)) for f in frames[1:]]
    pm = [pp.process_frame(f.depth, f.color) for f in frames[1:]]
    return jp, pp, jm, pm


def test_graph_and_per_frame_metrics(runs):
    jp, pp, jm, pm = runs
    assert pp.warp_field.layer_node_counts == jp.warp_field.layer_node_counts
    np.testing.assert_allclose(pp.warp_field.node_positions.numpy(), np.asarray(jp.warp_field.node_positions), atol=1e-6)
    for j, p in zip(jm, pm):
        assert p["valid_solve"] == j["valid_solve"] == [True, True]
        assert p["active_blocks"] == j["active_blocks"] > 0
        assert p["dropped_bin_entries"] == [0, 0] and p["dropped_large_faces"] == [0, 0]
        # f32 sums in another order (index_add_ vs XLA's one-hot
        # contractions), compounded through the second frame's start state
        np.testing.assert_allclose(p["data_loss"], j["data_loss"], rtol=1e-2)
        np.testing.assert_allclose(p["arap_loss"], j["arap_loss"], rtol=1e-2, atol=1e-12)
        assert p["data_loss"][-1] < p["data_loss"][0]
    np.testing.assert_allclose(pm[0]["data_loss"], jm[0]["data_loss"], rtol=1e-3)


def test_final_node_translations(runs):
    jp, pp, _, _ = runs
    jt = np.asarray(jp.warp_field.node_translations)
    pt = pp.warp_field.node_translations.numpy()
    # normal (z) component tight; in-plane sliding is a null direction of the
    # point-to-plane fit held only by the 1e-3 LM damping (see
    # test_torch_fitter.py), so x / y carry the summation-order noise
    np.testing.assert_allclose(pt[:, 2], jt[:, 2], atol=1e-4)
    np.testing.assert_allclose(pt[:, :2], jt[:, :2], atol=2e-3)
    assert np.abs(jt[:, 2]).max() > 1e-3  # the plane did bend


def test_tsdf_of_occupied_blocks(runs):
    jp, pp, _, _ = runs
    jk = np.asarray(jp.volume.slot_keys)
    np.testing.assert_array_equal(pp.volume.slot_keys.numpy(), jk)
    occ = jk != EMPTY_KEY
    jw, pw = np.asarray(jp.volume.weight)[occ], pp.volume.weight.numpy()[occ]
    jt, pt = np.asarray(jp.volume.tsdf)[occ], pp.volume.tsdf.numpy()[occ]
    observed = (jw > 0) | (pw > 0)
    same = (jw == pw) & (jw > 0)
    # the in-plane difference of the fields moves a few voxels across a
    # pixel or the truncation band: a bounded share of voxels differs
    assert ((jw != pw) & observed).sum() / observed.sum() < 0.01
    diff = np.abs(jt - pt)[same]
    assert np.quantile(diff, 0.99) < 1e-3
    assert diff.max() < 5e-2
    np.testing.assert_allclose(pt[~observed], jt[~observed], atol=1e-4)
