"""PyTorch port vs JAX package: camera, normals, KNN (with exact distance
ties), anchors, blend warp and compaction; atol 1e-5."""

import numpy as np
import jax.numpy as jnp
import torch

from dynamicfuion_python_tpu.ops import anchors as JA, camera as JC, compaction as JCo, knn as JK
from dynamicfuion_python_tpu.ops import normals as JN, warp as JW
from dynamicfuion_python_tpu_torch.ops import anchors as PA, camera as PC, compaction as PCo, knn as PK
from dynamicfuion_python_tpu_torch.ops import normals as PN, warp as PW

ATOL = 1e-5
K = np.asarray([[120.0, 0, 48.0], [0, 120.0, 32.0], [0, 0, 1]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _depth(rng, h=32, w=48):
    d = (1000 + 200 * rng.random((h, w))).astype(np.uint16)
    d[rng.random((h, w)) < 0.1] = 0
    return d


def test_camera(rng):
    d = _depth(rng)
    jp, jm = JC.unproject_depth_image(jnp.asarray(d), jnp.asarray(K), 1000.0, 1.1)
    pp, pm = PC.unproject_depth_image(_t(d.astype(np.int32)), _t(K), 1000.0, 1.1)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    juv, jok = JC.project_points(jnp.asarray(pts), jnp.asarray(K))
    puv, pok = PC.project_points(_t(pts), _t(K))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(puv.numpy(), np.asarray(juv), rtol=1e-6, atol=ATOL)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray(
        __import__("dynamicfuion_python_tpu.ops.linalg", fromlist=["x"]).axis_angle_to_matrix(jnp.asarray([0.1, -0.2, 0.3]))
    )
    m[:3, 3] = [0.1, 0.2, -0.3]
    np.testing.assert_allclose(
        PC.transform_points(_t(pts), _t(m)).numpy(), np.asarray(JC.transform_points(jnp.asarray(pts), jnp.asarray(m))), atol=ATOL
    )


def test_normals(rng):
    d = _depth(rng)
    jp, _ = JC.unproject_depth_image(jnp.asarray(d), jnp.asarray(K), 1000.0, 2.0)
    np.testing.assert_allclose(
        PN.point_image_normals(_t(jp)).numpy(), np.asarray(JN.point_image_normals(jp)), atol=ATOL
    )
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, size=(80, 3)).astype(np.int32)
    np.testing.assert_allclose(
        PN.mesh_vertex_normals(_t(verts), _t(tris)).numpy(),
        np.asarray(JN.mesh_vertex_normals(jnp.asarray(verts), jnp.asarray(tris))),
        atol=ATOL,
    )


def test_knn_random(rng):
    q = (rng.normal(size=(700, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    r = (rng.normal(size=(40, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    jd, ji = JK.knn(jnp.asarray(q), jnp.asarray(r), 4)
    pd, pi = PK.knn(_t(q), _t(r), 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_knn_exact_ties_on_a_grid():
    # integer grid: every distance is exact, so ties are exact and both must
    # list equidistant nodes in ascending index order
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), [0], indexing="ij"), -1).reshape(-1, 3)
    refs = g.astype(np.float32)
    queries = (g + np.asarray([0.5, 0.5, 0.0])).astype(np.float32)
    jd, ji = JK.knn(jnp.asarray(queries), jnp.asarray(refs), 4)
    pd, pi = PK.knn(_t(queries), _t(refs), 4)
    assert (np.asarray(jd)[:, 0] == np.asarray(jd)[:, 3]).any()  # genuine 4-way ties
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_anchors_and_blend_warp(rng):
    nodes = (rng.normal(size=(30, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    pts = (rng.normal(size=(500, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)
    cov = (0.04 + 0.02 * rng.random(30)).astype(np.float32) ** 2
    for kwargs in (
        dict(node_coverage=0.05),
        dict(node_coverage=0.05, use_threshold=True, minimum_valid_anchor_count=3),
    ):
        ja, jw, jv = JA.compute_anchors_euclidean(jnp.asarray(pts), jnp.asarray(nodes), 4, **kwargs)
        pa, pw, pv = PA.compute_anchors_euclidean(_t(pts), _t(nodes), 4, **kwargs)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=ATOL)
    ja, jw, _ = JA.compute_anchors_euclidean(jnp.asarray(pts), jnp.asarray(nodes), 4, node_coverage_squared=jnp.asarray(cov))
    pa, pw, _ = PA.compute_anchors_euclidean(_t(pts), _t(nodes), 4, node_coverage_squared=_t(cov))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=ATOL)

    from dynamicfuion_python_tpu.ops.linalg import axis_angle_to_matrix

    rot = np.asarray(axis_angle_to_matrix(jnp.asarray((0.1 * rng.normal(size=(30, 3))).astype(np.float32))))
    trans = (0.01 * rng.normal(size=(30, 3))).astype(np.float32)
    normals = rng.normal(size=(500, 3)).astype(np.float32)
    anchors = np.asarray(ja).copy()
    anchors[::7, 2] = -1  # skipped slots
    jwp, jwn = JW.blend_warp(jnp.asarray(pts), jnp.asarray(nodes), jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(anchors), jw, normals=jnp.asarray(normals))
    pwp, pwn = PW.blend_warp(_t(pts), _t(nodes), _t(rot), _t(trans), _t(anchors), _t(jw), normals=_t(normals))
    np.testing.assert_allclose(pwp.numpy(), np.asarray(jwp), atol=ATOL)
    np.testing.assert_allclose(pwn.numpy(), np.asarray(jwn), atol=ATOL)


def test_compaction(rng):
    mask = rng.random(1000) < 0.3
    for size, fill in ((100, None), (500, 0), (1000, 7)):
        ji, jc = JCo.compact_mask_indices(jnp.asarray(mask), size, fill_value=fill)
        pi, pc = PCo.compact_mask_indices(_t(mask), size, fill_value=fill)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        assert int(pc) == int(jc)
