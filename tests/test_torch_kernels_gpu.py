"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.ops import rasterize as rz

INTR = np.asarray([[672.0, 0.0, 320.0], [0.0, 672.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
SIZE = (480, 640)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mesh(rng, n_verts, n_faces):
    verts = (rng.normal(size=(n_verts, 3)) * [0.2, 0.2, 0.1] + [0, 0, 1.5]).astype(np.float32)
    verts[::7, 2] = 0.0005  # behind the near plane
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    return verts, faces


def _unproject(uv, z):
    """Pixel coordinates + depth -> camera-space vertices under INTR."""
    x = (uv[..., 0] - INTR[0, 2]) * z / INTR[0, 0]
    y = (uv[..., 1] - INTR[1, 2]) * z / INTR[1, 1]
    return np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)


def _pixel_soup(rng, n, lo, hi, half=4.0):
    """n separate faces with corners within ``half`` px of centers uniform in
    the pixel box [lo, hi], each corner at its own depth in [1, 2]."""
    centers = rng.uniform(lo, hi, size=(n, 1, 2))
    uv = centers + rng.uniform(-half, half, size=(n, 3, 2))
    z = rng.uniform(1.0, 2.0, size=(n, 1)) + rng.uniform(-0.01, 0.01, size=(n, 3))
    return uv, z


def _sliver_mesh(rng, n=20_000):
    """Near-collinear faces, doubled pixel-space area log-uniform in
    [1e-9, 1] px^2 before rounding, every tenth exactly degenerate (a
    repeated vertex), mixed with n / 2 ordinary faces."""
    a = rng.uniform([10, 10], [630, 470], size=(n, 2))
    d = rng.normal(size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = rng.uniform(1.0, 12.0, size=(n, 1))
    b = a + d * length
    offset = 10.0 ** rng.uniform(-9, 0, size=(n, 1)) / length  # area / base
    c = a + rng.uniform(0, 1, size=(n, 1)) * (b - a) + np.stack([-d[:, 1], d[:, 0]], 1) * offset
    z = rng.uniform(1.0, 2.0, size=(n, 1)) + rng.uniform(-0.01, 0.01, size=(n, 3))
    uv, zz = _pixel_soup(rng, n // 2, [0, 0], [640, 480], half=2.0)
    verts = np.concatenate([_unproject(np.stack([a, b, c], 1), z), _unproject(uv, zz)])
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    faces[: n : 10, 2] = faces[: n : 10, 0]  # exactly zero area
    return verts, faces


def _skewed_bin_mesh(rng):
    """256 faces inside the one tile x in [192, 208), y in [160, 176): its
    bin is full; other faces elsewhere keep clear of that tile."""
    uv_in = rng.uniform([192.5, 160.5], [207.0, 175.0], size=(256, 3, 2))
    z_in = rng.uniform(1.0, 2.0, size=(256, 1)) + rng.uniform(-0.01, 0.01, size=(256, 3))
    uv, z = _pixel_soup(rng, 12_000, [0, 0], [640, 480], half=2.0)
    lo, hi = uv.min(1), uv.max(1)
    clear = (hi[:, 0] < 190) | (lo[:, 0] > 210) | (hi[:, 1] < 158) | (lo[:, 1] > 178)
    verts = np.concatenate([_unproject(uv_in, z_in), _unproject(uv[clear], z[clear])])
    return verts, np.arange(len(verts), dtype=np.int32).reshape(-1, 3)


def _grid_mesh(n=240, pitch=0.0025, z=1.0):
    """A welded plane of ~1.7 px triangles: full, tied bins."""
    ii, jj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    xy = (np.stack([ii, jj], -1).reshape(-1, 2) - n / 2) * pitch
    verts = np.concatenate([xy, np.full((len(xy), 1), z)], 1).astype(np.float32)
    a = (ii[:-1, :-1] * (n + 1) + jj[:-1, :-1]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + n + 1, a + n + 2], 1), np.stack([a, a + n + 2, a + 1], 1)])
    return verts, faces.astype(np.int32)


@pytest.mark.gpu
def test_mesh_expand_kernel_is_bit_equal(card):
    rng = np.random.default_rng(0)
    verts, faces = _mesh(rng, 40_000, 65_536)
    v, f, k = (torch.as_tensor(a, device=card) for a in (verts, faces, INTR))
    before = native.launch_counts["mesh_expand"]
    fv, valid, s2o = me.expand_project_faces(v, f, k, 1e-3, 10.0)
    torch.cuda.synchronize()
    assert native.launch_counts["mesh_expand"] == before + 1
    pfv, pvalid = me.expand_project_faces_plain(v, f, k, 1e-3, 10.0)
    assert torch.equal(valid, pvalid) and 0 < int(valid.sum()) < len(faces)
    # --fmad=false: every operation rounds as PyTorch's elementwise ops do
    assert torch.equal(fv, pfv)
    assert torch.equal(s2o, torch.arange(len(faces), device=card))


@pytest.mark.gpu
def test_mesh_expand_kernel_checks_its_inputs(card):
    v = torch.zeros((4, 3), device=card)
    f = torch.zeros((2, 3), dtype=torch.int64, device=card)
    k = torch.eye(3, device=card)
    with pytest.raises(ValueError, match="int32"):
        me.expand_project_faces_cuda(v, f, k)


@pytest.mark.gpu
def test_mesh_expand_kernel_is_bit_equal_on_slivers(card):
    verts, faces = _sliver_mesh(np.random.default_rng(2))
    v, f, k = (torch.as_tensor(a, device=card) for a in (verts, faces, INTR))
    fv, valid, _ = me.expand_project_faces(v, f, k, 1e-3, 10.0)
    pfv, pvalid = me.expand_project_faces_plain(v, f, k, 1e-3, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(valid, pvalid) and bool(valid.all())
    assert torch.equal(fv, pfv)


# (mesh, image size, tile size, bin capacity, rasterizer options); tiles
# above 16 px run the kernel's 256-thread variant
RASTER_CASES = {
    "random": ("random", SIZE, 16, 256, {}),
    "grid": ("grid", SIZE, 16, 256, {}),
    "sliver": ("sliver", SIZE, 16, 256, {"blur_radius": 0.5}),
    "blur_clip_cull": ("random", SIZE, 16, 256, {"blur_radius": 0.7, "clip_barycentrics": True, "cull_back_faces": True}),
    "ragged": ("ragged", (470, 630), 16, 256, {}),
    "skewed_bin": ("skewed_bin", SIZE, 16, 256, {}),
    "tile8_ragged": ("ragged", (470, 630), 8, 256, {}),
    "tile32_ragged": ("ragged", (470, 630), 32, 256, {}),
    "tile32_deep_bins": ("random", SIZE, 32, 512, {}),  # up to 374 entries: 3 chunks
}


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", list(RASTER_CASES))
def test_rasterize_tiles_kernel_matches_plain(card, mesh):
    rng = np.random.default_rng(1)
    kind, size, tile_size, capacity, opts = RASTER_CASES[mesh]
    if kind == "random":
        # a soup of small faces at random depths: overlapping, tie-free
        centers = rng.uniform(-0.3, 0.3, size=(20_000, 1, 3)) + [0, 0, 1.4]
        verts = (centers + rng.uniform(-0.01, 0.01, size=(20_000, 3, 3))).reshape(-1, 3).astype(np.float32)
        faces = np.arange(60_000, dtype=np.int32).reshape(-1, 3)
    elif kind == "grid":
        verts, faces = _grid_mesh()
    elif kind == "sliver":
        verts, faces = _sliver_mesh(rng)
    elif kind == "ragged":
        # faces up to and across the right and bottom edges
        uv, z = _pixel_soup(rng, 20_000, [-5, -5], [635, 475])
        verts, faces = _unproject(uv, z), np.arange(60_000, dtype=np.int32).reshape(-1, 3)
    else:
        verts, faces = _skewed_bin_mesh(rng)
    v, f, k = (torch.as_tensor(a, device=card) for a in (verts, faces, INTR))
    fv, valid, _ = me.expand_project_faces(v, f, k, 1e-3, 10.0)
    bins = rz.bin_faces(
        fv, valid, size, blur_radius=opts.get("blur_radius", 0.0), tile_size=tile_size,
        max_faces_per_bin=capacity,
    )
    assert int(bins.dropped_bin_entries) == 0 and int(bins.dropped_large_faces) == 0
    if kind == "skewed_bin":
        assert int((bins.table >= 0).sum(1).max()) == 256
    if mesh == "tile32_deep_bins":
        assert int((bins.table >= 0).sum(1).max()) > 256
    faces9 = fv.reshape(-1, 9)
    before = native.launch_counts["rasterize_tiles"]
    got = rz.rasterize_tiles(faces9, bins.table, size, tile_size, **opts)
    torch.cuda.synchronize()
    assert native.launch_counts["rasterize_tiles"] == before + 1
    want = rz.rasterize_tiles_plain(faces9, bins.table, size, tile_size, **opts)
    assert got[0].shape == size and got[2].shape == (*size, 3)
    assert int((got[0] >= 0).sum()) > 10_000
    if kind == "ragged":
        assert bool((got[0][-1] >= 0).any()) and bool((got[0][:, -1] >= 0).any())
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_binned_rasterizer_on_the_card_matches_the_cpu(card):
    verts, faces = _grid_mesh()
    cpu = rz.rasterize_binned(*me.expand_project_faces(
        torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(INTR), 1e-3, 10.0
    )[:2], SIZE)
    gpu = rz.rasterize_binned(*me.expand_project_faces(
        torch.as_tensor(verts, device=card), torch.as_tensor(faces, device=card),
        torch.as_tensor(INTR, device=card), 1e-3, 10.0,
    )[:2], SIZE)
    assert torch.equal(gpu.face_indices.cpu(), cpu.face_indices)
    assert float((gpu.depths.cpu() - cpu.depths).abs().max()) <= 1e-5
