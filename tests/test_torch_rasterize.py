"""Kernel B1 (per-tile nearest fragment) and the binned rasterizer around it.

The port's rasterize_binned (plain phase 2 here) against the JAX package's
rasterize_binned with the Pallas kernel in interpret mode and against
rasterize_naive on tie-free random soups; face ids against the JAX fitter's
rasterize_splat on a welded grid mesh whose shared edges give exact depth
ties (the lower-face-id rule); equal overflow counts. On a card, the CUDA
kernel against the plain version
(tests/test_torch_kernels_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfuion_python_tpu.ops import rasterize as J
from dynamicfuion_python_tpu_torch.ops import rasterize as P

SIZE = (64, 80)
INTR = np.asarray([[100.0, 0.0, 40.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _random_soup(rng, n_faces):
    verts = rng.uniform(-0.4, 0.4, size=(n_faces * 3, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(0.8, 2.0, size=n_faces * 3)
    tris = np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)
    fv, valid = J.extract_face_vertices(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(INTR), SIZE)
    return np.array(fv), np.array(valid)


def _welded_grid(cell=2, nx=24, ny=20, origin=(5, 7)):
    """Pixel-space welded grid: vertices on integer pixels at z = 1, two
    triangles per cell. Every pixel center lies on a vertex or an edge, so
    the faces around it tie at exactly equal depth."""
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
    uv = np.stack([origin[0] + cell * ii, origin[1] + cell * jj], -1).reshape(-1, 2)
    verts = np.concatenate([uv, np.ones((len(uv), 1))], 1).astype(np.float32)
    vid = lambda i, j: i * (ny + 1) + j  # noqa: E731
    faces = []
    for i in range(nx):
        for j in range(ny):
            faces.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            faces.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    faces = np.asarray(faces)
    order = np.random.default_rng(3).permutation(len(faces))  # ids not in scan order
    return verts[faces[order]], np.ones(len(faces), bool)


def _check_covered(got, ref, atol=1e-5):
    gf = got.face_indices.numpy()
    rf = np.asarray(ref.face_indices)
    np.testing.assert_array_equal(gf, rf)
    cov = rf >= 0
    assert cov.sum() > 200
    np.testing.assert_allclose(got.depths.numpy()[cov], np.asarray(ref.depths)[cov], atol=atol)
    np.testing.assert_allclose(got.barycentrics.numpy()[cov], np.asarray(ref.barycentrics)[cov], atol=atol)
    # squared pixel distances reach tens of px^2, and XLA fuses their
    # products into FMAs: relative tolerance
    np.testing.assert_allclose(got.distances.numpy()[cov], np.asarray(ref.distances)[cov], rtol=1e-4, atol=atol)
    assert (got.depths.numpy()[~cov] == P.BG_DEPTH).all()


@pytest.mark.parametrize("perspective,cull", [(True, False), (False, True)])
def test_binned_matches_pallas_kernel_and_naive(rng, perspective, cull):
    fv, valid = _random_soup(rng, 120)
    kw = dict(faces_per_pixel=1, perspective_correct=perspective, cull_back_faces=cull)
    jb = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, tile_size=16, max_faces_per_bin=128, use_pallas="force", **kw)
    jn = J.rasterize_naive(jnp.asarray(fv), jnp.asarray(valid), SIZE, **kw)
    pb = P.rasterize_binned(_t(fv), _t(valid), SIZE, tile_size=16, max_faces_per_bin=128, **kw)
    pn = P.rasterize_naive(_t(fv), _t(valid), SIZE, **kw)
    _check_covered(pb, jb)
    _check_covered(pb, jn)
    _check_covered(pn, jn)


def test_blur_and_clip_match_xla_binned(rng):
    fv, valid = _random_soup(rng, 60)
    kw = dict(faces_per_pixel=1, blur_radius=0.7, clip_barycentrics=True, tile_size=8, max_faces_per_bin=96)
    jb = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, use_pallas="never", **kw)
    pb = P.rasterize_binned(_t(fv), _t(valid), SIZE, **kw)
    _check_covered(pb, jb)


def test_welded_grid_ties_pick_the_lowest_face_id():
    fv, valid = _welded_grid()
    js = J.rasterize_splat(jnp.asarray(fv), jnp.asarray(valid), SIZE, faces_per_pixel=1, perspective_correct=True)
    pb = P.rasterize_binned(_t(fv), _t(valid), SIZE, max_faces_per_bin=256)
    pf = pb.face_indices.numpy()
    sf = np.asarray(js.face_indices)
    assert (sf >= 0).sum() > 1500
    np.testing.assert_array_equal(pf, sf)
    # and the rule is the one stated: among all faces hit at a tied pixel
    naive = P.rasterize_naive(_t(fv), _t(valid), SIZE)
    np.testing.assert_array_equal(naive.face_indices.numpy(), sf)


def test_overflow_counts_match(rng):
    fv, valid = _random_soup(rng, 300)
    fv[:40] *= [3.0, 3.0, 1.0]  # a few large faces
    kw = dict(faces_per_pixel=1, tile_size=16, max_faces_per_bin=32, max_large_faces=8)
    _, jo = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, use_pallas="never", return_overflow=True, **kw)
    _, po = P.rasterize_binned(_t(fv), _t(valid), SIZE, return_overflow=True, **kw)
    assert int(jo["dropped_bin_entries"]) > 0 and int(jo["dropped_large_faces"]) > 0
    assert int(po["dropped_bin_entries"]) == int(jo["dropped_bin_entries"])
    assert int(po["dropped_large_faces"]) == int(jo["dropped_large_faces"])


def test_k_above_one_is_refused(rng):
    fv, valid = _random_soup(rng, 10)
    with pytest.raises(NotImplementedError):
        P.rasterize_binned(_t(fv), _t(valid), SIZE, faces_per_pixel=2)

