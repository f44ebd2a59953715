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
@pytest.mark.parametrize("mesh", ["random", "grid"])
def test_rasterize_tiles_kernel_matches_plain(card, mesh):
    rng = np.random.default_rng(1)
    if mesh == "random":
        # a soup of small faces at random depths: overlapping, tie-free
        centers = rng.uniform(-0.3, 0.3, size=(20_000, 1, 3)) + [0, 0, 1.4]
        verts = (centers + rng.uniform(-0.01, 0.01, size=(20_000, 3, 3))).reshape(-1, 3).astype(np.float32)
        faces = np.arange(60_000, dtype=np.int32).reshape(-1, 3)
    else:
        verts, faces = _grid_mesh()
    v, f, k = (torch.as_tensor(a, device=card) for a in (verts, faces, INTR))
    fv, valid, _ = me.expand_project_faces(v, f, k, 1e-3, 10.0)
    bins = rz.bin_faces(fv, valid, SIZE, max_faces_per_bin=256)
    assert int(bins.dropped_bin_entries) == 0
    faces9 = torch.where(valid[:, None, None], fv, -1e9).reshape(-1, 9).contiguous()
    before = native.launch_counts["rasterize_tiles"]
    got = rz.rasterize_tiles(faces9, bins.table, 16, bins.tiles_w)
    torch.cuda.synchronize()
    assert native.launch_counts["rasterize_tiles"] == before + 1
    want = rz.rasterize_tiles_plain(faces9, bins.table, 16, bins.tiles_w)
    assert int((got[0] >= 0).sum()) > 10_000
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
