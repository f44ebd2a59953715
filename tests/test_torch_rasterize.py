"""Kernel B1 (per-tile nearest fragment) and the binned rasterizer around it.

The port's rasterize_binned (plain phase 2 here) against the JAX package's
rasterize_binned with the Pallas kernel in interpret mode and against
rasterize_naive on tie-free random soups; face ids against the JAX fitter's
rasterize_splat on a welded grid mesh whose shared edges give exact depth
ties (the lower-face-id rule); equal overflow counts; invalid faces never
binned, so phase 2 reads the faces unmasked; the plain phase 2's [H, W]
output against the Pallas kernel's tile-major one on a ragged image; the
work count behind B1's bound against a brute-force count; K = 2 through
the binned path equals the naive oracle. On a card, the
CUDA kernel against the plain version (tests/test_torch_kernels_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfuion_python_tpu.ops import rasterize as J
from dynamicfuion_python_tpu.ops.pallas.rasterize_tiles import rasterize_tiles_pallas
from dynamicfuion_python_tpu_torch.ops import rasterize as P

SIZE = (64, 80)
INTR = np.asarray([[100.0, 0.0, 40.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


RAGGED = (70, 90)  # not a multiple of the 16-px tile
INTR_RAGGED = np.asarray([[100.0, 0.0, 45.0], [0.0, 100.0, 35.0], [0.0, 0.0, 1.0]], np.float32)


def _random_soup(rng, n_faces, intr=INTR, size=SIZE):
    verts = rng.uniform(-0.4, 0.4, size=(n_faces * 3, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(0.8, 2.0, size=n_faces * 3)
    tris = np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)
    fv, valid = J.extract_face_vertices(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(intr), size)
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
    """K > 1 was refused until the port had it; now the binned path at K = 2
    must run and equal the naive oracle (test_torch_rasterize_k.py holds both
    against the JAX package)."""
    fv, valid = _random_soup(rng, 10)
    got = P.rasterize_binned(_t(fv), _t(valid), SIZE, faces_per_pixel=2)
    want = P.rasterize_naive(_t(fv), _t(valid), SIZE, faces_per_pixel=2)
    assert got.face_indices.shape == (*SIZE, 2)
    np.testing.assert_array_equal(got.face_indices.numpy(), want.face_indices.numpy())



def test_invalid_faces_are_never_binned_so_phase_two_reads_them_unmasked(rng):
    fv, valid = _random_soup(rng, 150)
    order = rng.permutation(150)
    hidden, offscreen = order[:25], order[25:50]
    # invalid faces: copies of valid ones, twice as near; they would win
    # every pixel they cover if the unmasked kernel ever saw them
    fv[hidden] = fv[order[50:75]] * [1.0, 1.0, 0.5]
    valid[hidden] = False
    fv[offscreen, :, 0] += 1000.0  # valid, but right of the image
    bins = P.bin_faces(_t(fv), _t(valid), SIZE, tile_size=16, max_faces_per_bin=128)
    listed = np.unique(bins.table.numpy())
    listed = listed[listed >= 0]
    assert len(listed) > 50
    assert valid[listed].all()
    assert not np.isin(listed, offscreen).any()
    kw = dict(faces_per_pixel=1, tile_size=16, max_faces_per_bin=128)
    jb = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, use_pallas="force", **kw)
    pb = P.rasterize_binned(_t(fv), _t(valid), SIZE, **kw)
    _check_covered(pb, jb)


def test_plain_phase_two_image_layout_matches_the_pallas_tile_major_output(rng):
    h, w = RAGGED
    fv, valid = _random_soup(rng, 120, INTR_RAGGED, RAGGED)
    bins = P.bin_faces(_t(fv), _t(valid), RAGGED, tile_size=16, max_faces_per_bin=128)
    th, tw = bins.tiles_h, bins.tiles_w
    assert (th * 16, tw * 16) == (80, 96)
    faces9 = fv.reshape(-1, 9)
    face, depth, bary, dist = P.rasterize_tiles_plain(_t(faces9), bins.table, RAGGED, 16)
    assert face.shape == (h, w) and bary.shape == (h, w, 3) and depth.shape == dist.shape == (h, w)

    # the TPU kernel's tile-major contract, de-tiled and cropped
    table = jnp.asarray(bins.table.numpy())
    gathered = jnp.asarray(faces9)[jnp.maximum(table, 0)]  # [T, K, 9]
    soa = jnp.zeros((th * tw, 16, 128), jnp.float32).at[:, :9, :].set(gathered.transpose(0, 2, 1))
    face_t, depth_t, bary_t, d2_t = rasterize_tiles_pallas(soa, table, 0.0, 16, tw, interpret=True)

    def image(a, extra=()):
        return np.asarray(J._detile(a.reshape(th * tw, 16, 16, *extra), th, tw, 16, extra))[:h, :w]

    want = J.Fragments(
        image(face_t)[..., None], image(depth_t)[..., None],
        image(bary_t.transpose(0, 2, 1), (3,))[:, :, None, :], image(d2_t)[..., None],
    )
    got = P.Fragments(face[..., None], depth[..., None], bary[:, :, None, :], dist[..., None])
    _check_covered(got, want)
    # ragged edge: the last tile row and column are cut, not padded
    assert (face.numpy()[-1] >= 0).any() or (face.numpy()[:, -1] >= 0).any()


def _pixels_in_box(px, py, u, v, r):
    return int(((px >= u.min() - r) & (px <= u.max() + r) & (py >= v.min() - r) & (py <= v.max() + r)).sum())


@pytest.mark.parametrize("blur", [0.0, 0.7])
def test_rasterize_tiles_work_counts_pixels_in_each_face_box(rng, blur):
    h, w = RAGGED
    fv, valid = _random_soup(rng, 120, INTR_RAGGED, RAGGED)
    fv[:10] *= [4.0, 4.0, 1.0]  # some faces span several tiles
    bins = P.bin_faces(_t(fv), _t(valid), RAGGED, blur_radius=blur, tile_size=16, max_faces_per_bin=128)
    faces9 = fv.reshape(-1, 9)
    work = P.rasterize_tiles_work(_t(faces9), bins.table, RAGGED, 16, blur)

    table = bins.table.numpy()
    tw = bins.tiles_w
    entries = tests = tile_tests = ends = 0
    listed = set()
    for t, row in enumerate(table):
        x0, y0 = (t % tw) * 16, (t // tw) * 16
        xs = np.arange(x0, min(x0 + 16, w))
        ys = np.arange(y0, min(y0 + 16, h))
        px, py = np.meshgrid(xs, ys)
        ends += int((row < 0).any())
        for fid in row[row >= 0]:
            u = faces9[fid, 0::3].astype(np.float64)
            v = faces9[fid, 1::3].astype(np.float64)
            entries += 1
            listed.add(int(fid))
            tests += _pixels_in_box(px, py, u, v, blur)
            tile_tests += px.size
    assert entries > 100 and 0 < tests < tile_tests
    assert ends > 0 and 0 < len(listed) < entries  # faces in several bins are read once
    assert work["entries"] == entries
    assert work["tests"] == tests
    assert work["tile_tests"] == tile_tests
    assert work["distinct_faces"] == len(listed)
    assert work["operations"] == tests * P.RASTER_OPS_PER_TEST + entries * P.RASTER_OPS_PER_ENTRY
    # bin entries + the -1 ending each bin that is not full, each listed
    # face's 9 floats once, the four outputs
    assert work["bytes"] == (entries + ends) * 4 + len(listed) * 36 + h * w * 24
