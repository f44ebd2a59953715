"""K > 1 fragments and the splat rasterizer of the port against the JAX
package, on the CPU: the naive and binned rasterizers at K in {1, 4} (face
ids equal, the rest to 1e-4, as tests/test_rasterize.py holds naive against
binned); rasterize_splat at K in {1, 4} and blur in {0, 2} against the JAX
splat and naive paths, with the large-face merge and the tier-overflow
report; _merge_fragments on equal depths; project_face_soup and the NDC
round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.ops import rasterize as J
from dynamicfuion_python_tpu_torch.ops import rasterize as P

INTR = np.asarray([[100.0, 0.0, 32.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)
SIZE = (64, 64)


def _t(x):
    return torch.as_tensor(np.array(x))


def _random_cloud(rng, n_faces=80, z0=0.8, z1=2.0):
    verts = rng.uniform(-0.4, 0.4, size=(n_faces * 3, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(z0, z1, size=n_faces * 3)
    return verts, np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3)


def _quad(z=1.0, half=0.2):
    verts = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]], np.float32)
    return verts, np.array([[0, 2, 1], [0, 3, 2]], np.int32)


def _faces(verts, tris):
    fv, valid = J.extract_face_vertices(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(INTR), SIZE)
    return np.array(fv), np.array(valid)


def _with_large_faces(rng):
    """tests/test_rasterize.py's screen-filling quad + 30 small faces."""
    big_v, big_t = _quad(z=2.0, half=1.2)
    small_v, small_t = _random_cloud(rng, n_faces=30, z0=0.8, z1=1.5)
    return _faces(np.concatenate([big_v, small_v]), np.concatenate([big_t, small_t + 4]))


def _assert_same(got, want, atol):
    np.testing.assert_array_equal(got.face_indices.numpy(), np.asarray(want.face_indices))
    # with a blur radius, pixels outside a face extrapolate its perspective-
    # corrected barycentrics, and depths there reach ~60 m; XLA's FMA
    # contraction moves those by ~5e-6 relative (the port's naive and splat
    # paths agree with each other there): a relative term beside the atol
    np.testing.assert_allclose(got.depths.numpy(), np.asarray(want.depths), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.barycentrics.numpy(), np.asarray(want.barycentrics), rtol=1e-5, atol=atol)
    # squared pixel distances reach tens of px^2 and XLA fuses their products
    # into FMAs: relative tolerance
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("k", [1, 4])
def test_naive_and_binned_match_jax(rng, k):
    fv, valid = _faces(*_random_cloud(rng))
    kw = dict(faces_per_pixel=k, perspective_correct=True)
    jn = J.rasterize_naive(jnp.asarray(fv), jnp.asarray(valid), SIZE, **kw)
    jb = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, tile_size=16, max_faces_per_bin=128,
                            use_pallas="never", **kw)
    pn = P.rasterize_naive(_t(fv), _t(valid), SIZE, **kw)
    pb = P.rasterize_binned(_t(fv), _t(valid), SIZE, tile_size=16, max_faces_per_bin=128, **kw)
    assert pn.face_indices.shape == (*SIZE, k)
    assert (np.asarray(jn.face_indices)[..., k - 1] >= 0).sum() > 100  # the K-th layer is populated
    _assert_same(pn, jn, 1e-4)
    _assert_same(pb, jb, 1e-4)
    _assert_same(pb, jn, 1e-4)


def test_binned_k_with_blur_clip_and_large_faces(rng):
    fv, valid = _with_large_faces(rng)
    kw = dict(faces_per_pixel=3, blur_radius=0.7, clip_barycentrics=True, tile_size=8, max_faces_per_bin=96,
              small_span=2, max_large_faces=64, return_overflow=True)
    jb, jo = J.rasterize_binned(jnp.asarray(fv), jnp.asarray(valid), SIZE, use_pallas="never", **kw)
    pb, po = P.rasterize_binned(_t(fv), _t(valid), SIZE, **kw)
    assert int(po["dropped_large_faces"]) == int(jo["dropped_large_faces"]) == 0
    assert int(po["dropped_bin_entries"]) == int(jo["dropped_bin_entries"])
    _assert_same(pb, jb, 1e-4)


def test_fewer_faces_than_k_pad_with_empty_fragments():
    fv, valid = _faces(*_quad())
    jn = J.rasterize_naive(jnp.asarray(fv), jnp.asarray(valid), SIZE, faces_per_pixel=5)
    pn = P.rasterize_naive(_t(fv), _t(valid), SIZE, faces_per_pixel=5)
    assert pn.face_indices.shape == (*SIZE, 5)
    _assert_same(pn, jn, 1e-5)
    assert (pn.face_indices.numpy()[..., 2:] == -1).all() and (pn.depths.numpy()[..., 2:] == P.BG_DEPTH).all()


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("blur", [0.0, 2.0])
def test_splat_matches_jax_splat_and_naive(rng, k, blur):
    fv, valid = _faces(*_random_cloud(rng))
    kw = dict(faces_per_pixel=k, blur_radius=blur, perspective_correct=True)
    js, jo = J.rasterize_splat(jnp.asarray(fv), jnp.asarray(valid), SIZE, return_overflow=True, **kw)
    ps, po = P.rasterize_splat(_t(fv), _t(valid), SIZE, return_overflow=True, **kw)
    for key in jo:
        assert int(po[key]) == int(jo[key])
    _assert_same(ps, js, 1e-4)
    # and the naive oracle, as the JAX test holds its splat path
    _assert_same(ps, J.rasterize_naive(jnp.asarray(fv), jnp.asarray(valid), SIZE, **kw), 1e-4)


def test_splat_large_faces_merge_like_jax(rng):
    fv, valid = _with_large_faces(rng)
    js, jo = J.rasterize_splat(jnp.asarray(fv), jnp.asarray(valid), SIZE, faces_per_pixel=2, return_overflow=True)
    ps, po = P.rasterize_splat(_t(fv), _t(valid), SIZE, faces_per_pixel=2, return_overflow=True)
    assert int(po["dropped_large_faces"]) == int(jo["dropped_large_faces"]) == 0
    assert int(po["dropped_bin_entries"]) == int(jo["dropped_bin_entries"]) == 0
    _assert_same(ps, js, 1e-4)
    assert (ps.face_indices.numpy() <= 1).any()  # the big quad is in the merge


def test_splat_tier_overflow_is_reported_like_jax(rng):
    fv, valid = _faces(*_random_cloud(rng, n_faces=200))
    kw = dict(quad_cap=4, hex_cap=4, max_large_faces=0, return_overflow=True)
    js, jo = J.rasterize_splat(jnp.asarray(fv), jnp.asarray(valid), SIZE, **kw)
    ps, po = P.rasterize_splat(_t(fv), _t(valid), SIZE, **kw)
    assert int(po["dropped_large_faces"]) + int(po["dropped_bin_entries"]) > 0
    for key in jo:
        assert int(po[key]) == int(jo[key])
    _assert_same(ps, js, 1e-4)  # the same faces dropped


def test_splat_ties_pick_the_lowest_face_id():
    """A welded grid with every pixel on an edge or vertex: faces tie at
    exactly equal depth, and the lowest face id must win (the JAX splat
    path's three-key sort; here two stable sorts)."""
    ii, jj = np.meshgrid(np.arange(13), np.arange(11), indexing="ij")
    uv = np.stack([5 + 2 * ii, 7 + 2 * jj], -1).reshape(-1, 2)
    verts = np.concatenate([uv, np.ones((len(uv), 1))], 1).astype(np.float32)
    vid = lambda i, j: i * 11 + j  # noqa: E731
    faces = np.asarray([f for i in range(12) for j in range(10) for f in (
        [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)], [vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])])
    fv = verts[faces[np.random.default_rng(3).permutation(len(faces))]]
    valid = np.ones(len(fv), bool)
    for k in (1, 3):
        js = J.rasterize_splat(jnp.asarray(fv), jnp.asarray(valid), SIZE, faces_per_pixel=k)
        ps = P.rasterize_splat(_t(fv), _t(valid), SIZE, faces_per_pixel=k)
        np.testing.assert_array_equal(ps.face_indices.numpy(), np.asarray(js.face_indices))
        assert (ps.face_indices.numpy()[..., 0] >= 0).sum() > 300
        if k == 3:  # several faces tie at a vertex: ascending ids
            f = ps.face_indices.numpy()
            both = (f[..., 1] >= 0)
            assert both.sum() > 100 and (f[..., 0][both] < f[..., 1][both]).all()


def test_merge_fragments_on_ties():
    """Equal depths: the first buffer's fragments come first, then each
    buffer's own order (jax.lax.top_k's rule)."""
    rng = np.random.default_rng(1)
    h, w, k = 4, 5, 3
    depths = rng.choice([1.0, 2.0, P.BG_DEPTH], size=(2, h, w, k)).astype(np.float32)
    depths.sort(-1)
    faces = rng.integers(0, 50, size=(2, h, w, k)).astype(np.int32)
    bary = rng.uniform(size=(2, h, w, k, 3)).astype(np.float32)
    dist = rng.uniform(size=(2, h, w, k)).astype(np.float32)
    a, b = ([J.Fragments(jnp.asarray(faces[i]), jnp.asarray(depths[i]), jnp.asarray(bary[i]), jnp.asarray(dist[i]))
             for i in range(2)])
    pa, pb = ([P.Fragments(_t(faces[i]), _t(depths[i]), _t(bary[i]), _t(dist[i])) for i in range(2)])
    want = J._merge_fragments(a, b, k)
    got = P._merge_fragments(pa, pb, k)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_project_face_soup_and_ndc_round_trip(rng):
    verts, tris = _random_cloud(rng, n_faces=40)
    soup = verts[tris]
    soup[:3, 0, 2] = 0.01  # behind the near plane
    valid_in = rng.random(len(soup)) > 0.2
    jfv, jok = J.project_face_soup(jnp.asarray(soup), jnp.asarray(INTR), valid=jnp.asarray(valid_in))
    pfv, pok = P.project_face_soup(_t(soup), _t(INTR), valid=_t(valid_in))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(pfv.numpy(), np.asarray(jfv), rtol=1e-6)
    assert not pok.numpy()[:3].any()
    # the indexed form projects the same faces the same way
    efv, _ = P.extract_face_vertices(_t(verts), _t(tris), _t(INTR), SIZE)
    np.testing.assert_array_equal(efv.numpy(), P.project_face_soup(_t(verts[tris]), _t(INTR))[0].numpy())
    ndc = P.pixel_to_ndc(pfv, SIZE)
    np.testing.assert_allclose(ndc.numpy(), np.asarray(J.pixel_to_ndc(jfv, SIZE)), rtol=1e-6)
    np.testing.assert_allclose(P.ndc_to_pixel(ndc, SIZE).numpy(), pfv.numpy(), atol=1e-4)


@pytest.mark.parametrize("cap", [5, 40, 200])
def test_compact_indices_matches_jax(rng, cap):
    mask = rng.random(100) > 0.7
    want = [np.asarray(x) for x in J._compact_indices(jnp.asarray(mask), cap)]
    got = [x.numpy() for x in P._compact_indices(_t(mask), cap)]
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
