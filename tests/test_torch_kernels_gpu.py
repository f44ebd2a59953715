"""The hand-written CUDA kernels (B1, B2 and the fitter's face data term rows)
against their plain PyTorch versions, the segment sums' card forms against the CPU's ``index_add_``, the training
step's backwards (gathers, flow upsampling, bilinear sampling, convolutions
under ``fp32_step``) repeating bit for bit, a frame's waits on the card
all going through ``utils/trace.py``, the SOD loop's resampler and
batched U2NET forward, and the rigid odometry's CUDA graph against its
eager loop, on the card.
Every test here needs a CUDA device and skips without one; the file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import collections
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu_torch.ops import mesh_expand as me
from dynamicfuion_python_tpu_torch.ops import rasterize as rz
from dynamicfuion_python_tpu_torch.ops import segment_sum as ss
from dynamicfuion_python_tpu_torch.utils import trace

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
    before = trace.counter("b2.launches")
    fv, valid, s2o = me.expand_project_faces(v, f, k, 1e-3, 10.0)
    torch.cuda.synchronize()
    assert trace.counter("b2.launches") == before + 1
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
    before = trace.counter("b1.launches")
    got = rz.rasterize_tiles(faces9, bins.table, size, tile_size, **opts)
    torch.cuda.synchronize()
    assert trace.counter("b1.launches") == before + 1
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


# the segment sums at the main path's shapes (the 480x640 slice: 126 nodes,
# 117 stems and 9 corner nodes; the DeformNet prior on the 448x640 plane):
# (rows, row shape, segments)
SUM_SITES = {
    "data_term": (2_211_840, (42,), 126),
    "arap_blocks": (486, (36,), 117),
    "arap_gradient": (486, (3,), 126),
    "arap_corner": (486, (36,), 9),
    "schur_pairs": (1872, (36,), 81),
    "wing_t": (468, (6,), 9),
    "mesh_vertex_normals": (196_608, (3,), 32_768),
    "prior_system": (4_591_552, (6, 6), 15_876),
    "prior_gradient": (1_148_896, (6,), 126),
    "deform_net_weights": (1_146_880, (), 126),
}


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(SUM_SITES))
def test_segment_sums_repeat_bit_for_bit(card, site):
    """``segment_sum`` (the form the site gets) and each card form that
    applies, 20 calls each on seeded inputs (a tenth of the rows dropped
    and NaN): bit-equal every time, and within 1e-6 of the largest entry of
    the CPU's ``index_add_`` sum accumulated in f64."""
    rows, shape, n = SUM_SITES[site]
    gen = torch.Generator().manual_seed(11)
    values = torch.randn((rows, *shape), generator=gen)
    seg = torch.randint(0, n, (rows,), generator=gen)
    seg[::10] = n
    values[::10] = float("nan")
    want = ss._index_add_sum(values.double(), seg, n)
    v, s = values.to(card), seg.to(card)
    forms = [ss.segment_sum, ss.segment_sum_sorted]
    if n <= ss.ONEHOT_MAX_SEGMENTS:
        forms.append(ss.segment_sum_onehot)
    for form in forms:
        first = form(v, s, n)
        for _ in range(19):
            assert torch.equal(form(v, s, n), first), form.__name__
        err = float((first.double().cpu() - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), (form.__name__, err)


@pytest.mark.gpu
def test_onehot_sum_runs_without_tf32(card):
    """With TF32 turned on globally the one-hot product still rounds as
    FP32 (TF32 would be ~1e-3 off), and the flag is the caller's again
    after the call."""
    rows, shape, n = SUM_SITES["data_term"]
    gen = torch.Generator().manual_seed(12)
    values, seg = torch.randn((rows // 8, *shape), generator=gen), torch.randint(0, n, (rows // 8,), generator=gen)
    want = ss._index_add_sum(values.double(), seg, n)
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ss.segment_sum_onehot(values.to(card), seg.to(card), n)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert float((got.double().cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.gpu
def test_phase_upsampling_repeats_bit_for_bit(card):
    """Every 2x upsampling of PWC-Net's decoders and of MaskNet at the
    prior's 448x640 input, on the card (cuDNN TF32 off, as DeformNet runs
    it): 20 calls bit-equal, and within 1e-5 of the largest entry of the
    CPU's transposed convolution in f64 (FP32 sums of up to 2,388 products:
    1.4e-6 measured on an H100; TF32 would be ~1e-3)."""
    from dynamicfuion_python_tpu_torch.models.deform_net import fp32_convolutions
    from dynamicfuion_python_tpu_torch.models.mask_net import FEATURES2_CHANNELS
    from dynamicfuion_python_tpu_torch.models.pwcnet import Decoder, PhaseConvTranspose2d

    layers = []
    for level in range(2, 6):  # a decoder upsamples the level above it
        cin = Decoder(level).moduleUpfeat.in_channels
        size = (448 >> (level + 1), 640 >> (level + 1))
        layers += [(2, 2, size), (cin, 2, size)]
    layers += [(FEATURES2_CHANNELS, 32, (112, 160)), (32, 16, (224, 320))]
    gen = torch.Generator().manual_seed(13)
    for cin, cout, (h, w) in layers:
        module = PhaseConvTranspose2d(cin, cout)
        x = torch.randn((1, cin, h, w), generator=gen)
        with torch.no_grad(), fp32_convolutions():  # as DeformNet runs them: TF32 off
            want = torch.nn.functional.conv_transpose2d(
                x.double(), module.weight.double(), module.bias.double(), stride=2, padding=1)
            module, xc = module.to(card), x.to(card)
            first = module(xc)
            for _ in range(19):
                assert torch.equal(module(xc), first), (cin, cout, h, w)
        err = float((first.double().cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (cin, cout, h, w, err)


# the training step's backwards at the shapes of the JAX train()'s defaults
# (448x640, batch 4, 128 node slots, 10,000 matches): each must repeat bit
# for bit over 20 calls on the card (no float atomics) and agree with the
# CPU in f64. Gathers: (rows, row shape) into 128 nodes
GATHER_SITES = {
    "warp_loss_anchors": (286_720 * 4, (3, 3)),  # blend_warp of every pixel
    "gn_match_anchors": (10_000 * 4, (3, 3)),  # the GN's rotations per match
    "gn_arap_edges": (128 * 8, (3,)),  # the ARAP residual's translations
}


@pytest.mark.gpu
@pytest.mark.parametrize("site", sorted(GATHER_SITES))
def test_gather_rows_backward_repeats_bit_for_bit(card, site):
    """``gather_rows``' backward (a ``segment_sum`` of the gradient's rows)
    20 times bit-equal, within 1e-6 of the largest entry of the CPU's sum
    in f64."""
    from dynamicfuion_python_tpu_torch.ops.warp import gather_rows

    rows, shape = GATHER_SITES[site]
    gen = torch.Generator().manual_seed(14)
    table = torch.randn((128, *shape), generator=gen)
    index = torch.randint(0, 128, (rows,), generator=gen)
    grad = torch.randn((rows, *shape), generator=gen)
    want = torch.zeros((128, *shape), dtype=torch.float64).index_add_(0, index, grad.double())
    t, i, g = table.to(card).requires_grad_(), index.to(card), grad.to(card)
    first = torch.autograd.grad(gather_rows(t, i), t, g)[0]
    for _ in range(19):
        assert torch.equal(torch.autograd.grad(gather_rows(t, i), t, g)[0], first)
    assert float((first.double().cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [((112, 160), (448, 640)), ((7, 13), (30, 41))], ids=["flow2", "odd"])
def test_bilinear_resize_backward_repeats_bit_for_bit(card, sizes):
    """PWC-Net's flow upsampling: the forward equals ``F.interpolate`` on
    the card bit for bit; the backward (the transposed resize) 20 times
    bit-equal, within 1e-6 of the largest entry of autograd's own backward
    on the card and on the CPU."""
    import torch.nn.functional as F

    from dynamicfuion_python_tpu_torch.models.pwcnet import bilinear_resize

    size_in, size_out = sizes
    gen = torch.Generator().manual_seed(15)
    x = torch.randn((4, 2, *size_in), generator=gen)
    grad = torch.randn((4, 2, *size_out), generator=gen)
    xc, gc = x.to(card).requires_grad_(), grad.to(card)
    up = bilinear_resize(xc, size_out)
    assert torch.equal(up, F.interpolate(xc, size=size_out, mode="bilinear", align_corners=False))
    first = torch.autograd.grad(up, xc, gc)[0]
    for _ in range(19):
        assert torch.equal(torch.autograd.grad(bilinear_resize(xc, size_out), xc, gc)[0], first)
    for device in (card, torch.device("cpu")):
        xd = x.to(device).requires_grad_()
        up = F.interpolate(xd, size=size_out, mode="bilinear", align_corners=False)
        want = torch.autograd.grad(up, xd, grad.to(device))[0].cpu()
        assert float((first.cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max()), device


@pytest.mark.gpu
def test_bilinear_sample_backward_repeats_bit_for_bit(card):
    """PWC-Net's backward warp of the second image's level-2 features
    (112x160, 32 channels) by a flow: advanced indexing's backward (a
    sort-based ``index_put_``) 20 times bit-equal for the image and the
    flow, within 1e-6 of the largest entry of the CPU's (in f32: the same
    tap weights, the sums in another order; f64 weights differ by ~7e-6)."""
    from dynamicfuion_python_tpu_torch.ops.image_warp import backward_warp

    gen = torch.Generator().manual_seed(16)
    image = torch.randn((112, 160, 32), generator=gen)
    flow = torch.randn((112, 160, 2), generator=gen) * 4.0
    grad = torch.randn((112, 160, 32), generator=gen)

    def grads(device, dtype):
        im = image.to(device, dtype).requires_grad_()
        fl = flow.to(device, dtype).requires_grad_()
        return torch.autograd.grad(backward_warp(im, fl), (im, fl), grad.to(device, dtype))

    first = grads(card, torch.float32)
    for _ in range(19):
        assert all(torch.equal(a, b) for a, b in zip(grads(card, torch.float32), first))
    for got, want in zip(first, grads("cpu", torch.float32)):
        assert float((got.cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("layer", ["extractor_one", "refiner_one"])
def test_conv_backward_repeats_under_fp32_step(card, layer):
    """A PWC-Net convolution's backward (input and weight gradients) inside
    ``fp32_step`` (TF32 off, cuDNN deterministic), at batch 4 of the
    448x640 crop: the extractor's first stride-2 convolution on the images
    and the refiner's first on 112x160 features: 20 times bit-equal, within
    2e-4 of the largest entry of the CPU's in f64 (the bound of
    chip_smoke.py's card-vs-CPU training gradients; the refiner's weight
    gradient, FP32 sums of 71,680 products each by cuDNN's deterministic
    algorithm, was 4.9e-5 off on an H100)."""
    from dynamicfuion_python_tpu_torch.apps.train import fp32_step
    from dynamicfuion_python_tpu_torch.models.pwcnet import PWCNet

    net = PWCNet()
    conv, size = {"extractor_one": (net.moduleExtractor.moduleOne[0], (448, 640)),
                  "refiner_one": (net.moduleRefiner.moduleMain[0], (112, 160))}[layer]
    gen = torch.Generator().manual_seed(17)
    x = torch.randn((4, conv.in_channels, *size), generator=gen)
    with torch.no_grad():
        grad = torch.randn((4, *conv(x[:1]).shape[1:]), generator=gen)

    def grads(device, dtype):
        module = conv.to(device, dtype)
        xd = x.to(device, dtype).requires_grad_()
        with fp32_step():
            return torch.autograd.grad(module(xd), (xd, module.weight, module.bias), grad.to(device, dtype))

    first = grads(card, torch.float32)
    for _ in range(19):
        assert all(torch.equal(a, b) for a, b in zip(grads(card, torch.float32), first))
    for got, want in zip(first, grads("cpu", torch.float64)):
        assert float((got.double().cpu() - want).abs().max()) <= 2e-4 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True], ids=["fusion480", "prior448"])
def test_a_frame_waits_on_the_card_only_through_the_trace_module(card, prior, tmp_path):
    """One steady frame of the 480x640 slice (448x640 with the neural prior
    on seeded DeformNet weights) under ``set_sync_debug_mode("warn")`` with
    tracing on: every synchronizing call the card reports happens inside a
    ``host_read.*`` or ``host_write.*`` span of ``utils/trace.py``; any
    other is named by its innermost frames in the port."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import PRIOR_IMAGE_SIZE, SLICE_IMAGE_SIZE, make_slice
    from dynamicfuion_python_tpu_torch.models import deform_net as dn
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    params, seq = make_slice(5, PRIOR_IMAGE_SIZE if prior else SLICE_IMAGE_SIZE)
    if prior:
        path = tmp_path / "deform_net.pt"
        torch.save(dn.seeded_state_dict(dn.DeformNet(), torch.Generator().manual_seed(3)), path)
        params = apply_overrides(params, ["fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}"])
    frames = list(seq)
    pipe = FusionPipeline(params, seq.intrinsics)
    pipe.initialize(frames[0].depth, frames[0].color)
    for f in frames[1:4]:
        pipe.process_frame(f.depth, f.color)
    torch.cuda.synchronize()
    package = str(Path(trace.__file__).resolve().parents[1])
    counted, outside = 0, collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        nonlocal counted
        if "called a synchronizing CUDA operation" not in str(message):
            return
        open_spans = [s.name for s in trace.spans() if not s.end_ns]
        if open_spans and open_spans[-1].startswith(("host_read.", "host_write.")):
            counted += 1
            return
        here = [fr for fr in traceback.extract_stack()[:-1] if fr.filename.startswith(package)][-3:]
        outside[" <- ".join(f"{Path(fr.filename).name}:{fr.lineno}" for fr in reversed(here))] += 1

    trace.reset()
    trace.enable(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            # the mode's own notice ("... does not yet detect all synchronizing
            # operations", once a process) is raised here, before ``show``
            torch.cuda.set_sync_debug_mode("warn")
            warnings.showwarning = show
            try:
                pipe.process_frame(frames[4].depth, frames[4].color)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        waits = {k: v for k, v in trace.snapshot()["counters"].items() if k.startswith(("host_read.", "host_write."))}
    finally:
        trace.enable(False)
        trace.reset()
    assert not outside, f"synchronizing calls outside the trace module: {dict(outside)}"
    # torch.unique's wait is counted (``blocking``) but not reported by the card
    assert 0 < counted <= sum(waits.values()), (counted, waits)


# -- the face data term's rows (csrc/face_data_rows.cu) ----------------------


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN (torch.equal with NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _face_rows_both(args, shard=None):
    """The face term's rows from the kernel and from the plain functions on
    the same arguments (``fitter._data_term_face``'s), compacted as the
    term compacts them."""
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops.face_data_rows import face_data_rows_cuda

    call = fitter._face_row_inputs(*args[:13], shard)
    return face_data_rows_cuda(*call), fitter._face_rows_plain(*call)


def _record_face_terms(prior: bool, tmp_path, frames: int = 4, every: int = 5):
    """Every ``every``-th call's arguments of the face data term over the
    first ``frames`` fitted frames of the 480x640 slice (448x640 with the
    neural prior on seeded DeformNet weights), on the card."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import PRIOR_IMAGE_SIZE, SLICE_IMAGE_SIZE, make_slice
    from dynamicfuion_python_tpu_torch.models import deform_net as dn
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    params, seq = make_slice(frames + 1, PRIOR_IMAGE_SIZE if prior else SLICE_IMAGE_SIZE)
    if prior:
        path = tmp_path / "deform_net.pt"
        torch.save(dn.seeded_state_dict(dn.DeformNet(), torch.Generator().manual_seed(3)), path)
        params = apply_overrides(params, ["fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}"])
    recorded, calls = [], [0]
    term = fitter._DATA_TERMS["face"]

    def record(*args, **kwargs):
        if calls[0] % every == 0:
            recorded.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        calls[0] += 1
        return term(*args, **kwargs)

    fitter._DATA_TERMS["face"] = record
    try:
        seq_frames = list(seq)
        pipe = FusionPipeline(params, seq.intrinsics)
        pipe.initialize(seq_frames[0].depth, seq_frames[0].color)
        for f in seq_frames[1:]:
            pipe.process_frame(f.depth, f.color)
    finally:
        fitter._DATA_TERMS["face"] = term
    return recorded


@pytest.mark.gpu
@pytest.mark.parametrize("prior", [False, True], ids=["fusion480", "prior448"])
def test_face_rows_kernel_is_bit_equal_on_the_main_path(card, prior, tmp_path):
    """The kernel's rows, segments, weights and residuals, and the sums and
    loss the term returns, equal the plain functions' on the GN inputs of
    four fitted frames of the 480x640 slice (448x640 with the prior)."""
    from dynamicfuion_python_tpu_torch.models import fitter

    recorded = _record_face_terms(prior, tmp_path)
    assert len(recorded) >= 4
    for args in recorded:
        got, want = _face_rows_both(args)
        for g, w in zip(got, want):
            assert _same(g, w)
        assert bool(torch.isfinite(got[0]).all()) and int((got[1] < args[12]).sum()) > 0
        sums = fitter._data_term_face(*args)
        plain = fitter._sum_rows(*want, args[12])
        assert all(torch.equal(a, b) for a, b in zip(sums, plain))


# the synthetic cases: (name, compaction fraction, Tukey cutoff or None,
# lumped blocks, a row shard (first row, budget) or None)
FACE_ROW_CASES = {
    "compacted": (0.6, None, True, None),  # covered > cap: every compacted pixel kept
    "cap_below_cover": (0.1, None, True, None),
    "every_pixel": (0.0, None, True, None),  # no compaction: masked rows read NaN points
    "tukey": (0.6, 0.05, True, None),
    "tukey_every_pixel": (0.0, 0.05, False, None),
    "not_lumped": (0.6, None, False, None),
    "shard": (0.6, None, True, (32, 300)),
    "shard_every_pixel": (0.0, None, True, (32, None)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FACE_ROW_CASES))
def test_face_rows_kernel_is_bit_equal_on_edge_cases(card, case):
    """Synthetic faces (tests/_face_rows_inputs.py): dropped anchors (fewer
    than 12 distinct nodes), zero and near-zero area, corners at and below
    the 1e-6 depth clamp, non-finite corners read only by masked rows, NaN
    points outside the mask; compacted with the cap above and below the
    covered count, uncompacted, Tukey weights, unlumped blocks, and a row
    shard with its first row and budget: the kernel equals the plain
    functions, NaN for NaN."""
    from _face_rows_inputs import synthetic_face_inputs

    from dynamicfuion_python_tpu_torch.models import fitter

    frac, cutoff, lump, shard = FACE_ROW_CASES[case]
    config = fitter.FitterConfig(pixel_compaction_fraction=frac, use_tukey_penalty=cutoff is not None,
                                 tukey_cutoff=cutoff or 0.01, lump_data_hessian=lump)
    args = [a.to(card) if isinstance(a, torch.Tensor) else fitter.FacePrecompute(*(t.to(card) for t in a))
            for a in synthetic_face_inputs(5)]
    row_shard = None
    if shard is not None:
        row0, budget = shard
        h = args[7].shape[0]
        args[7:10] = [t[row0:] for t in args[7:10]]
        row_shard = fitter.RowShard(row0, h, None if budget is None else torch.tensor(budget, device=card))
    args = (*args, config, args[0].shape[0])
    got, want = _face_rows_both(args, row_shard)
    for g, w in zip(got, want):
        assert _same(g, w)
    weight, seg = want[2], want[1]
    assert (weight > 0).any() and bool((seg == args[12]).any())  # kept rows and dropped slots
    assert bool(torch.isnan(want[0]).any())  # the degenerate faces reach kept rows


@pytest.mark.gpu
def test_face_rows_kernel_repeats_bit_for_bit(card, tmp_path):
    """20 launches on one 480x640 GN input: the same bits every time."""
    args = _record_face_terms(False, tmp_path, frames=1, every=100)[0]
    first, _ = _face_rows_both(args)
    for _ in range(19):
        again, _ = _face_rows_both(args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_fusion_loop_with_the_kernel_equals_the_plain_loop(card, monkeypatch):
    """Five fitted frames of the 480x640 slice with the kernel, then with the
    plain functions patched in its place: the same field, TSDF and mesh,
    bit for bit; the kernel launched once per GN iteration run."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice
    from dynamicfuion_python_tpu_torch.models import fitter

    params, seq = make_slice(6)
    frames = list(seq)

    def run():
        pipe = FusionPipeline(params, seq.intrinsics)
        pipe.initialize(frames[0].depth, frames[0].color)
        for f in frames[1:]:
            pipe.process_frame(f.depth, f.color)
        field, volume = pipe.warp_field, pipe.volume
        occupied = volume.occupied_mask()
        return [field.node_positions, field.node_rotations, field.node_translations, volume.slot_keys,
                volume.tsdf[occupied], volume.weight[occupied], pipe.canonical_vertices, pipe.canonical_triangles]

    trace.reset()
    with_kernel = run()
    launches, iterations = trace.counter("face_rows.launches"), trace.counter("fit.gn_iterations")
    assert launches == iterations > 0
    monkeypatch.setattr(fitter, "face_data_rows_cuda", fitter._face_rows_plain)
    plain = run()
    assert trace.counter("face_rows.launches") == launches
    trace.reset()
    assert all(torch.equal(a, b) for a, b in zip(with_kernel, plain))


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [3, 1], ids=["RGB", "L"])
@pytest.mark.parametrize("shape, size", [((480, 640), (320, 320)), ((320, 320), (480, 640)), ((37, 53), (20, 71))],
                         ids=["down", "up", "odd"])
def test_resize_images_on_the_card_equals_numpy(card, channels, shape, size):
    from dynamicfuion_python_tpu_torch.data.images import resize_bicubic, resize_images

    rng = np.random.default_rng(30)
    images = rng.integers(0, 256, size=(4, *shape, channels), dtype=np.uint8)
    images[1, :, ::2] = 255
    images[1, :, 1::2] = 0
    got = resize_images(torch.as_tensor(images, device=card), size).cpu().numpy()
    for image, g in zip(images, got):
        want = resize_bicubic(image if channels == 3 else image[..., 0], size)
        np.testing.assert_array_equal(g if channels == 3 else g[..., 0], want)


@pytest.mark.gpu
def test_batched_u2net_forward_runs_without_tf32(card, tmp_path):
    """The SOD loop's batched U2NET forward on the card, with TF32 turned on
    globally beforehand: every convolution runs with TF32 off, and the fused
    output of two frames of the batch agrees with the CPU's within 1e-4."""
    from dynamicfuion_python_tpu_torch.apps import sod
    from dynamicfuion_python_tpu_torch.models.u2net import U2NetFull, seeded_state_dict
    from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

    rng = np.random.default_rng(31)
    frames = []
    for i in range(5):
        frames.append(tmp_path / "color" / f"{i:06d}.png")
        frames[-1].parent.mkdir(exist_ok=True)
        write_png(frames[-1], rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8))
    cpu = U2NetFull()
    cpu.load_state_dict(seeded_state_dict(cpu, torch.Generator().manual_seed(32)))
    cpu.eval()
    model = U2NetFull()
    model.load_state_dict(cpu.state_dict())
    model.to(card).eval()
    flags, seen = set(), []

    def before(module, args):
        if isinstance(module, torch.nn.Conv2d):
            flags.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    hooks = [m.register_forward_pre_hook(before) for m in model.modules()]
    hooks.append(model.register_forward_hook(lambda m, args, out: seen.append((args[0].cpu(), out[0].cpu()))))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    trace.reset()
    try:
        written = sod.masks_for_frames(model, frames, tmp_path / "sod", batch_size=4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for h in hooks:
            h.remove()
    assert flags == {(False, False)}
    assert len(written) == 5 and [x.shape[0] for x, _ in seen] == [4, 1]
    assert trace.counter("host_read.sod.masks") == trace.counter("sod.batches") == 2
    x, fused = seen[0]
    with torch.no_grad():
        want = cpu(x[[0, 3]])[0]
    assert float((fused[[0, 3]] - want).abs().max()) <= 1e-4


# -- rigid odometry as one CUDA graph (ops/rigid_odometry.py) ---------------


def _odometry_pairs(size, pairs: int):
    """``pairs`` successive depth pairs of the slice at ``size`` on the card,
    with its intrinsics and the pipeline's odometry settings."""
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice

    params, seq = make_slice(pairs + 1, size)
    depths = [torch.as_tensor(np.asarray(f.depth).astype(np.int32), device="cuda") for f in seq]
    intrinsics = torch.as_tensor(np.asarray(seq.intrinsics), dtype=torch.float32, device="cuda")
    settings = dict(depth_scale=params.fusion.depth_scale, depth_max=params.fusion.far_clip_distance)
    return [(depths[i], depths[i + 1], intrinsics) for i in range(pairs)], settings


def _eager_odometry(args, settings):
    """The call as the CPU and process groups run it: op by op."""
    from dynamicfuion_python_tpu_torch.ops import rigid_odometry as ro

    return ro._odometry(*args, None, **{**dict(levels=(4, 2, 1), iterations_per_level=10, distance_threshold=0.07),
                                        **settings})


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(480, 640), (448, 640)], ids=["480x640", "448x640"])
def test_odometry_replay_equals_the_eager_loop(card, size, monkeypatch):
    """Seven successive frame pairs of the slice: the first call runs eagerly
    and captures, the six after it replay on new inputs; every pose and
    rmse equals the eager loop's bit for bit."""
    from dynamicfuion_python_tpu_torch.ops import rigid_odometry as ro

    monkeypatch.setattr(ro, "_GRAPHS", {})
    pairs, settings = _odometry_pairs(size, 7)
    trace.reset()
    for args in pairs:
        got = ro.rigid_odometry_multi_scale(*args, **settings)
        want = _eager_odometry(args, settings)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], torch.eye(4, device=card))  # the camera moved
    counters = trace.snapshot()["counters"]
    trace.reset()
    assert (counters["odometry.eager"], counters["odometry.graph_captures"], counters["odometry.graph_replays"]) == \
        (1, 1, 6)


@pytest.mark.gpu
def test_odometry_captures_a_graph_per_key(card, monkeypatch):
    """Another ``depth_max``, another shape and a start transform each
    capture their own graph, and each replay equals its eager call."""
    from dynamicfuion_python_tpu_torch.ops import rigid_odometry as ro

    monkeypatch.setattr(ro, "_GRAPHS", {})
    (args, again), settings = _odometry_pairs(SIZE, 2)
    start = torch.eye(4, device=card)
    start[:3, 3] = torch.tensor([0.001, -0.002, 0.0], device=card)
    crop = tuple(t[:240] for t in args[:2]) + args[2:]
    calls = [(args, settings, None), (args, {**settings, "depth_max": 2.0}, None), (crop, settings, None),
             (args, settings, start)]
    for n, (a, s, t0) in enumerate(calls, 1):
        ro.rigid_odometry_multi_scale(*a, t0, **s)
        assert len(ro._GRAPHS) == n
    for (a, s, t0), b in zip(calls, [again, again, tuple(t[:240] for t in again[:2]) + again[2:], again]):
        got = ro.rigid_odometry_multi_scale(*b, t0, **s)
        want = ro._odometry(*b, t0, **{**dict(levels=(4, 2, 1), iterations_per_level=10, distance_threshold=0.07),
                                        **s})
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(ro._GRAPHS) == 4


@pytest.mark.gpu
def test_a_returned_odometry_pose_outlives_the_next_replay(card, monkeypatch):
    """The pose and rmse a replay returns are the caller's: the next call's
    replay on other inputs leaves them as they were."""
    from dynamicfuion_python_tpu_torch.ops import rigid_odometry as ro

    monkeypatch.setattr(ro, "_GRAPHS", {})
    pairs, settings = _odometry_pairs(SIZE, 3)
    ro.rigid_odometry_multi_scale(*pairs[0], **settings)
    pose, rmse = ro.rigid_odometry_multi_scale(*pairs[1], **settings)
    kept = pose.clone(), rmse.clone()
    nxt = ro.rigid_odometry_multi_scale(*pairs[2], **settings)
    assert not torch.equal(nxt[0], pose)
    assert torch.equal(pose, kept[0]) and torch.equal(rmse, kept[1])


@pytest.mark.gpu
def test_fusion_loop_with_the_odometry_graph_equals_the_eager_loop(card, monkeypatch):
    """Six frames of the 480x640 slice with the odometry replayed, then with
    the eager odometry forced: the same poses, node transforms and TSDF,
    bit for bit."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.apps.profile_frame import make_slice
    from dynamicfuion_python_tpu_torch.ops import rigid_odometry as ro

    params, seq = make_slice(7)
    frames = list(seq)

    def run():
        pipe = FusionPipeline(params, seq.intrinsics)
        pipe.initialize(frames[0].depth, frames[0].color)
        poses = []
        for f in frames[1:]:
            pipe.process_frame(f.depth, f.color)
            poses.append(pipe.extrinsics.clone())
        field, volume = pipe.warp_field, pipe.volume
        occupied = volume.occupied_mask()
        return [*poses, field.node_positions, field.node_rotations, field.node_translations, volume.slot_keys,
                volume.tsdf[occupied], volume.weight[occupied]]

    monkeypatch.setattr(ro, "_GRAPHS", {})
    trace.reset()
    graphed = run()
    assert trace.counter("odometry.graph_replays") == 4 and trace.counter("odometry.eager") == 1
    monkeypatch.setattr(ro, "_replays", lambda device, group: False)
    eager = run()
    assert trace.counter("odometry.graph_replays") == 4 and trace.counter("odometry.eager") == 6
    trace.reset()
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
