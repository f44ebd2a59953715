"""PyTorch port vs JAX package: one Gauss-Newton step and a whole
fit_to_image from the same converted warp field and canonical mesh on a small
hierarchical scene (the first bending-plane frame's extracted mesh and
graph, fitted to the second frame)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dynamicfuion_python_tpu.models.fitter as JF
import dynamicfuion_python_tpu_torch.models.fitter as PF
from dynamicfuion_python_tpu.apps.fusion_pipeline import FusionPipeline, _observed_points_program
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.models.voxel_block_grid import extract_mesh_fitter_arrays
from dynamicfuion_python_tpu.ops.linalg import solve_block_sparse_arrowhead as j_solve
from dynamicfuion_python_tpu.ops.normals import mesh_vertex_normals as j_normals
from dynamicfuion_python_tpu.settings import Parameters
from dynamicfuion_python_tpu.utils.config import apply_overrides
from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals as p_normals
from dynamicfuion_python_tpu_torch.utils.state_conversion import warp_field_from_numpy

OVERRIDES = [
    "tsdf.voxel_size=0.01",
    "tsdf.sdf_truncation_distance=0.04",
    "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12",
    "graph.layer_count=2",
    "graph.erosion_num_iterations=1",
    "alignment.use_rigid_alignment=false",
    "fusion.far_clip_distance=2.0",
]


def _state(obj) -> dict:
    return {f.name: (np.array(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticBendingPlaneSequence(frame_count=2, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    pipe = FusionPipeline(apply_overrides(Parameters(), OVERRIDES), seq.intrinsics)
    pipe.initialize(frames[0].depth, frames[0].color)
    # 32768-face bucket: rasterize_splat's default tier caps then hold every
    # face of this ~1 px-per-face mesh (smaller buckets drop faces there)
    verts, faces, _, _ = extract_mesh_fitter_arrays(pipe.volume, 8192, 32768, 0.0)
    points, mask = _observed_points_program(jnp.asarray(frames[1].depth), pipe.intrinsics, jnp.eye(4), 1000.0, 2.0, False)
    jcfg = JF.FitterConfig(max_iterations=3, arap_term_weight=20.0)
    # ~1 px faces: a 16x16 tile holds ~400 of them
    pcfg = PF.FitterConfig(max_iterations=3, arap_term_weight=20.0, max_faces_per_bin=1024)
    jf = pipe.warp_field
    return dict(
        jf=jf, pf=warp_field_from_numpy(_state(jf), device="cpu"), verts=verts, faces=faces, points=points,
        mask=mask, k=pipe.intrinsics, jcfg=jcfg, pcfg=pcfg,
    )


def test_one_gauss_newton_step(scene, monkeypatch):
    s = scene
    jf, pf = s["jf"], s["pf"]
    jpre = JF.precompute_face_associations(jf, s["verts"], s["faces"])
    ppre = PF.precompute_face_associations(pf, _t(s["verts"]), _t(s["faces"]))
    for a, b in zip(jpre, ppre):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    jn = j_normals(s["verts"], s["faces"])
    pn = p_normals(_t(s["verts"]), _t(s["faces"]))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-6)
    mode_j, mode_p = JF.IterationMode.ALL, PF.IterationMode.ALL
    # the JAX step does not return its solver's escalation count and corner
    # damping: a callback traced into the step records them
    solves = []

    def recording_solve(*args, **kwargs):
        out = j_solve(*args, **kwargs)
        jax.debug.callback(lambda e, m: solves.append((int(e), float(m))), out[1], out[2])
        return out

    monkeypatch.setattr(JF, "solve_block_sparse_arrowhead", recording_solve)
    step = jax.jit(JF._gauss_newton_step_impl, static_argnames=("config", "mode", "max_deg"))
    jout = step(jf, s["verts"], s["faces"], jn, jpre, s["points"], s["mask"], s["k"], s["jcfg"], mode_j, JF._max_wing_degree(jf))
    pout = PF.gauss_newton_step(pf, _t(s["verts"]), _t(s["faces"]), pn, ppre, _t(s["points"]), _t(s["mask"]), _t(s["k"]), s["pcfg"], mode_p, PF._max_wing_degree(pf))
    jax.block_until_ready(jout)
    jax.effects_barrier()
    assert solves == [(int(pout.escalations), float(pout.corner_damping))]
    assert bool(pout.valid_solve) == bool(jout[3]) is True
    np.testing.assert_allclose(float(pout.data_loss), float(jout[1]), rtol=1e-4)
    np.testing.assert_allclose(float(pout.arap_loss), float(jout[2]), rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(pout.field.node_translations.numpy(), np.asarray(jout[0].node_translations), atol=1e-5)
    np.testing.assert_allclose(pout.field.node_rotations.numpy(), np.asarray(jout[0].node_rotations), atol=1e-5)
    assert int(pout.overflow["dropped_bin_entries"]) == 0


def test_fit_to_image(scene):
    s = scene
    jfield, jd = JF.fit_to_image(s["jf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], s["jcfg"])
    pfield, pd = PF.fit_to_image(s["pf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], s["pcfg"], device="cpu")
    np.testing.assert_array_equal(pd["valid_solve"].numpy(), np.asarray(jd["valid_solve"]))
    assert pd["valid_solve"].all()
    np.testing.assert_allclose([float(x) for x in pd["data_loss"]], [float(x) for x in jd["data_loss"]], rtol=1e-4)
    # the ARAP loss also sees the in-plane null direction described below
    np.testing.assert_allclose([float(x) for x in pd["arap_loss"]], [float(x) for x in jd["arap_loss"]], rtol=1e-3)
    assert float(pd["data_loss"][-1]) < float(pd["data_loss"][0])
    jt = np.asarray(jd["node_translations_per_iteration"])
    pt = pd["node_translations_per_iteration"].numpy()
    # along the surface normal (z for this fronto-parallel plane) the fits
    # agree to 1e-5 m; in-plane sliding is a null direction of point-to-plane
    # residuals held only by the 1e-3 LM damping, where f32 summation-order
    # noise (index_add_ vs one-hot matmuls) grows ~100x per step in both
    # packages alike, so x / y get 1e-3 m
    np.testing.assert_allclose(pt[..., 2], jt[..., 2], atol=1e-5)
    np.testing.assert_allclose(pt[..., :2], jt[..., :2], atol=1e-3)
    assert (pd["damping_escalations"] >= 0).all() and (pd["dropped_bin_entries"] == 0).all()


def test_other_data_terms_are_refused(scene):
    s = scene
    cfg = dataclasses.replace(s["pcfg"], data_term_impl="bogus")
    with pytest.raises(ValueError, match="data_term_impl"):
        PF.fit_to_image(s["pf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], cfg, device="cpu")
    # use_fast_data_term=False selects the autodiff oracle whatever the name
    assert PF.data_term_impl(dataclasses.replace(cfg, use_fast_data_term=False)) == "autodiff"


@pytest.mark.parametrize("impl", ["fast", "autodiff"])
def test_fit_to_image_other_data_terms(scene, impl):
    """A whole fit with the "fast" / "autodiff" data term equals the fit
    with the "face" term without compaction: the same math (each term is
    held to its JAX counterpart in test_data_terms_match_jax)."""
    s = scene
    face = dataclasses.replace(s["pcfg"], max_iterations=2, pixel_compaction_fraction=0.0)
    other = dataclasses.replace(face, data_term_impl=impl, use_fast_data_term=impl != "autodiff")
    _, want = PF.fit_to_image(s["pf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], face, device="cpu")
    _, got = PF.fit_to_image(s["pf"], s["verts"], s["faces"], s["points"], s["mask"], s["k"], other, device="cpu")
    assert got["valid_solve"].all() and torch.equal(got["valid_solve"], want["valid_solve"])
    np.testing.assert_allclose([float(x) for x in got["data_loss"]], [float(x) for x in want["data_loss"]], rtol=1e-5)
    pt = got["node_translations_per_iteration"].numpy()
    wt = want["node_translations_per_iteration"].numpy()
    # test_fit_to_image's bounds: the surface normal tight, in-plane 1e-3
    np.testing.assert_allclose(pt[..., 2], wt[..., 2], atol=1e-5)
    np.testing.assert_allclose(pt[..., :2], wt[..., :2], atol=1e-3)


# -- the three data terms (tests/test_fitter.py::TestFaceDataTermParity) -----


@functools.lru_cache(maxsize=2)
def _cached_parity_fixture(seed: int):
    from test_fitter import _parity_fixture

    return _parity_fixture(seed=seed)


# the JAX data terms jitted (config and node count static): eager, their
# per-pixel vmaps dispatch op by op
_JAX_TERMS = {
    name: jax.jit(getattr(JF, f"_data_term_{name}"), static_argnums=(11, 12)) for name in ("face", "fast", "autodiff")
}


def _parity_args(seed: int, frac: float, tukey: bool, nan_outside_mask: bool = False):
    """tests/test_fitter.py's parity fixture as the JAX and the port data
    terms' argument tuples (the port's from the same numpy arrays)."""
    from test_fitter import INTR

    field, verts, tris, normals, pre, frag_faces, ref_pts, ref_mask = _cached_parity_fixture(seed)
    if nan_outside_mask:
        ref_pts = jnp.where(ref_mask[..., None], ref_pts, jnp.nan)
    kw = dict(use_tukey_penalty=tukey, tukey_cutoff=0.1, pixel_compaction_fraction=frac)
    jargs = (
        field.virtual_positions(), field.virtual_rotations(), field.virtual_translations(), verts, normals, tris,
        pre, frag_faces, ref_pts, ref_mask, INTR, JF.FitterConfig(**kw), field.num_nodes,
    )
    ppre = PF.FacePrecompute(_t(pre.anchors), _t(pre.weights), _t(pre.face_nodes), _t(pre.slot_of_vertex_anchor).long())
    pargs = (*(_t(a) for a in jargs[:6]), ppre, *(_t(a) for a in jargs[7:11]), PF.FitterConfig(**kw), field.num_nodes)
    return jargs, pargs


def _assert_terms_close(got, want):
    # the JAX test's tolerances (tests/test_fitter.py:408-426)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("frac", [0.0, 0.6])
@pytest.mark.parametrize("tukey", [True, False])
def test_data_terms_match_jax(frac, tukey):
    """All three data terms in both packages on the JAX parity fixture: each
    port term against its JAX counterpart, and against the port's other two
    (the compaction cap is above the covered-pixel count here, so "face"
    drops no row)."""
    jargs, pargs = _parity_args(4, frac, tukey)
    port = {}
    for name in ("face", "fast", "autodiff"):
        want = _JAX_TERMS[name](*jargs)
        port[name] = [x.numpy() for x in PF._DATA_TERMS[name](*pargs)]
        _assert_terms_close(port[name], want)
    assert np.abs(port["face"][0]).max() > 0
    _assert_terms_close(port["face"], port["fast"])
    _assert_terms_close(port["face"], port["autodiff"])


@pytest.mark.parametrize("impl", ["face", "fast", "autodiff"])
def test_data_terms_finite_with_nan_outside_the_mask(impl):
    """Masked pixels carry non-finite observed points (invalid depth): every
    term stays finite, as the JAX terms do."""
    jargs, pargs = _parity_args(11, 0.6, False, nan_outside_mask=True)
    got = PF._DATA_TERMS[impl](*pargs)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_terms_close([x.numpy() for x in got], _JAX_TERMS[impl](*jargs))


def test_autodiff_jacobians_under_no_grad():
    """fit_to_image runs under torch.no_grad(): torch.func's jacrev still
    differentiates there."""
    _, pargs = _parity_args(4, 0.0, False)
    with torch.no_grad():
        inside = PF._data_term_autodiff(*pargs)
    outside = PF._data_term_autodiff(*pargs)
    assert float(inside[0].abs().max()) > 0
    for a, b in zip(inside, outside):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
