"""PyTorch port vs JAX package: the fitter's options on one Gauss-Newton
step (iteration modes, robust penalties, unlumped Hessian) and the
coarse-to-fine schedule, on the scene of test_torch_fitter.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dynamicfuion_python_tpu.models.fitter as JF
import dynamicfuion_python_tpu_torch.models.fitter as PF
from dynamicfuion_python_tpu.apps.fusion_pipeline import FusionPipeline, _observed_points_program
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.models.voxel_block_grid import extract_mesh_fitter_arrays
from dynamicfuion_python_tpu.ops.normals import mesh_vertex_normals as j_normals
from dynamicfuion_python_tpu.settings import Parameters
from dynamicfuion_python_tpu.utils.config import apply_overrides
from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals as p_normals
from dynamicfuion_python_tpu_torch.utils.state_conversion import warp_field_from_numpy

OVERRIDES = [
    "tsdf.voxel_size=0.01", "tsdf.sdf_truncation_distance=0.04", "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12", "graph.layer_count=2", "graph.erosion_num_iterations=1",
    "alignment.use_rigid_alignment=false", "fusion.far_clip_distance=2.0",
]


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticBendingPlaneSequence(frame_count=2, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    pipe = FusionPipeline(apply_overrides(Parameters(), OVERRIDES), seq.intrinsics)
    pipe.initialize(frames[0].depth, frames[0].color)
    # 32768-face bucket: rasterize_splat's tier caps hold every face
    verts, faces, _, _ = extract_mesh_fitter_arrays(pipe.volume, 8192, 32768, 0.0)
    points, mask = _observed_points_program(jnp.asarray(frames[1].depth), pipe.intrinsics, jnp.eye(4), 1000.0, 2.0, False)
    jf = pipe.warp_field
    state = {f.name: (np.array(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(jf) for v in [getattr(jf, f.name)]}
    return dict(jf=jf, pf=warp_field_from_numpy(state, device="cpu"), verts=verts, faces=faces, points=points, mask=mask, k=pipe.intrinsics)


@pytest.mark.parametrize(
    "mode,options",
    [
        ("TRANSLATION_ONLY", {}),
        ("ROTATION_ONLY", {}),
        ("ALL", dict(use_tukey_penalty=True, tukey_cutoff=0.02, use_huber_penalty=True, huber_constant=1e-4, lump_data_hessian=False)),
    ],
)
def test_step_options(scene, mode, options):
    s = scene
    jcfg = JF.FitterConfig(arap_term_weight=20.0, **options)
    # ~1 px faces: a 16x16 tile holds ~400 of them
    pcfg = PF.FitterConfig(arap_term_weight=20.0, max_faces_per_bin=1024, **options)
    jpre = JF.precompute_face_associations(s["jf"], s["verts"], s["faces"])
    ppre = PF.precompute_face_associations(s["pf"], _t(s["verts"]), _t(s["faces"]))
    jn = j_normals(s["verts"], s["faces"])
    pn = p_normals(_t(s["verts"]), _t(s["faces"]))
    jout = JF._gauss_newton_step(s["jf"], s["verts"], s["faces"], jn, jpre, s["points"], s["mask"], s["k"], jcfg, JF.IterationMode[mode], JF._max_wing_degree(s["jf"]))
    pout = PF.gauss_newton_step(s["pf"], _t(s["verts"]), _t(s["faces"]), pn, ppre, _t(s["points"]), _t(s["mask"]), _t(s["k"]), pcfg, PF.IterationMode[mode], PF._max_wing_degree(s["pf"]))
    assert bool(pout.valid_solve) == bool(jout[3])
    np.testing.assert_allclose(float(pout.data_loss), float(jout[1]), rtol=1e-4)
    np.testing.assert_allclose(pout.field.node_translations.numpy(), np.asarray(jout[0].node_translations), atol=1e-5)
    np.testing.assert_allclose(pout.field.node_rotations.numpy(), np.asarray(jout[0].node_rotations), atol=1e-5)
    if mode == "TRANSLATION_ONLY":
        np.testing.assert_array_equal(pout.field.node_rotations.numpy(), s["pf"].node_rotations.numpy())
    if mode == "ROTATION_ONLY":
        np.testing.assert_array_equal(pout.field.node_translations.numpy(), s["pf"].node_translations.numpy())


def test_coarse_to_fine_schedule(scene):
    s = scene
    kw = dict(max_iterations=3, coarse_iterations=2, coarse_factor=2, arap_term_weight=20.0)
    jfield, jd = JF.fit_to_image(s["jf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], JF.FitterConfig(**kw))
    # the 2x-strided frame makes ~0.6 px faces: a 16x16 tile holds ~1000
    pcfg = PF.FitterConfig(max_faces_per_bin=4096, **kw)
    pfield, pd = PF.fit_to_image(s["pf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], pcfg, device="cpu")
    assert (pd["dropped_bin_entries"] == 0).all()
    np.testing.assert_array_equal(pd["valid_solve"].numpy(), np.asarray(jd["valid_solve"]))
    np.testing.assert_allclose([float(x) for x in pd["data_loss"]], [float(x) for x in jd["data_loss"]], rtol=1e-4)
    jt = np.asarray(jd["node_translations_per_iteration"])
    pt = pd["node_translations_per_iteration"].numpy()
    # normal component tight; x / y: the in-plane null direction (see
    # test_torch_fitter.py)
    np.testing.assert_allclose(pt[..., 2], jt[..., 2], atol=1e-5)
    np.testing.assert_allclose(pt[..., :2], jt[..., :2], atol=1e-3)
