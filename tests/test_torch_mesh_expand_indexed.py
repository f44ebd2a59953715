"""The port's indexed-mesh rasterizer against the JAX package, on the CPU:
ExpansionPlan's face order on the sphere of tests/test_mesh_expand.py,
_remap_fragment_ids, and rasterize_indexed (kernel B2's plain version on the
plan's sorted faces, then the splat rasterizer, then the id remap) against
the JAX package's (its Pallas kernel in interpret mode) on a welded grid
whose pixels tie at equal depth: face ids in the caller's numbering, equal.
On a card, chip_smoke.py's indexed phase runs the CUDA kernel at 4.47M
faces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.ops.pallas import mesh_expand as JM
from dynamicfuion_python_tpu.ops.rasterize import extract_face_vertices as j_extract
from dynamicfuion_python_tpu_torch.ops import mesh_expand as PM
from dynamicfuion_python_tpu_torch.ops.rasterize import rasterize_splat

from test_mesh_expand import _sphere

SIZE = (64, 64)
# focal and principal point powers of two: the grid's vertices project to
# integer pixels exactly, so pixel centers lie on edges and faces tie
GRID_INTR = np.asarray([[128.0, 0.0, 32.0], [0.0, 128.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def test_plan_order_matches_jax():
    verts, faces = _sphere()
    jplan = JM.ExpansionPlan(faces, len(verts), chunk=128)
    pplan = PM.ExpansionPlan(faces, len(verts), device="cpu")
    np.testing.assert_array_equal(pplan.perm.numpy(), np.asarray(jplan.perm))
    np.testing.assert_array_equal(pplan.sorted_to_original.numpy(), np.asarray(jplan.sorted_to_original))
    np.testing.assert_array_equal(pplan.sorted_triangles.numpy(), faces[np.asarray(jplan.perm)])
    assert (pplan.perm.numpy() != np.arange(len(faces))).any()
    # B2 on the sorted faces == the JAX plan's kernel output (interpret mode)
    verts[::7, 2] = 0.01  # a non-trivial clip mask
    intr = np.asarray([[120.0, 0.0, 32.0], [0.0, 120.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
    jfv, jvalid, _ = JM.expand_project_faces(jnp.asarray(verts), jplan, jnp.asarray(intr))
    pfv, pvalid, _ = PM.expand_project_faces(torch.as_tensor(verts), pplan.sorted_triangles, torch.as_tensor(intr))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    # the interpreter's FMA order differs from the plain version's by an ulp
    np.testing.assert_allclose(pfv.numpy(), np.asarray(jfv), rtol=2e-6, atol=1e-6)


def test_headline_scene_is_the_bench_scene():
    """chip_smoke.py's indexed phase runs the port's own copy of the
    rasterizer bench's scene: the same 4,470,784 faces."""
    import sys
    from pathlib import Path

    from dynamicfuion_python_tpu_torch.apps.profile_frame import build_scene

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from bench_rasterizer import build_scene as bench_scene

    verts, faces = build_scene()
    want_v, want_f = bench_scene()
    assert faces.shape == (4_470_784, 3) and verts.shape == (2_235_520, 3)
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)


def test_remap_fragment_ids():
    s2o = np.asarray([4, 2, 0, 1, 3], np.int32)
    frag = np.asarray([[0, -1], [4, 2]], np.int32)
    want = np.asarray(JM._remap_fragment_ids(jnp.asarray(frag), jnp.asarray(s2o)))
    got = PM._remap_fragment_ids(torch.as_tensor(frag), torch.as_tensor(s2o).long())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[4, -1], [3, 0]])


def _tied_grid(nx=20, ny=16, cell=2, origin=(10, 12)):
    """A welded camera-space grid at z = 1 whose vertices project to integer
    pixels, with shuffled vertex and face ids (the plan's order is then not
    the caller's)."""
    rng = np.random.default_rng(7)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
    u = origin[0] + cell * ii.ravel()
    v = origin[1] + cell * jj.ravel()
    verts = np.stack([(u - 32) / 128.0, (v - 32) / 128.0, np.ones_like(u, dtype=np.float64)], -1).astype(np.float32)
    vperm = rng.permutation(len(verts))
    new_id = np.empty_like(vperm)
    new_id[vperm] = np.arange(len(vperm))
    vid = lambda i, j: new_id[i * (ny + 1) + j]  # noqa: E731
    faces = []
    for i in range(nx):
        for j in range(ny):
            faces.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            faces.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    faces = np.asarray(faces, np.int32)[rng.permutation(2 * nx * ny)]
    return verts[vperm], faces


@pytest.mark.parametrize("k", [1, 3])
def test_rasterize_indexed_matches_jax_on_ties(k):
    verts, faces = _tied_grid()
    jplan = JM.ExpansionPlan(faces, len(verts), chunk=128)
    pplan = PM.ExpansionPlan(faces, len(verts), device="cpu")
    jfrag, jo = JM.rasterize_indexed(jnp.asarray(verts), jplan, jnp.asarray(GRID_INTR), SIZE, faces_per_pixel=k)
    pfrag, po = PM.rasterize_indexed(torch.as_tensor(verts), pplan, torch.as_tensor(GRID_INTR), SIZE,
                                     faces_per_pixel=k)
    for key in jo:
        assert int(po[key]) == int(jo[key]) == 0
    got, want = pfrag.face_indices.numpy(), np.asarray(jfrag.face_indices)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] >= 0).sum() > 1000
    cov = want >= 0
    np.testing.assert_allclose(pfrag.depths.numpy()[cov], np.asarray(jfrag.depths)[cov], atol=1e-5)
    np.testing.assert_allclose(pfrag.barycentrics.numpy()[cov], np.asarray(jfrag.barycentrics)[cov], atol=1e-5)
    # the ties are real: rasterizing in the caller's order picks other faces
    fv, valid = j_extract(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(GRID_INTR), SIZE)
    caller = rasterize_splat(torch.as_tensor(np.asarray(fv)), torch.as_tensor(np.asarray(valid)), SIZE,
                             faces_per_pixel=k)
    assert (caller.face_indices.numpy() != got).sum() > 100
