"""The port's neural tracker against the JAX package on the CPU: the cost
volume, the image warps, PWC-Net, MaskNet and DeformNet (JAX-initialized
weights carried by ``deform_net_state_from_jax``), the point-cloud GN solver
and its guards, ``track_from_flow``, the patch-wise mask threshold, the
shortest-path pixel anchors and Euclidean node edges, and the reference
checkpoint loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.models import deform_net as JD
from dynamicfuion_python_tpu.models import gn_point_cloud_optimizer as JG
from dynamicfuion_python_tpu.models import pwcnet as JP
from dynamicfuion_python_tpu.ops import correlation as JC
from dynamicfuion_python_tpu.ops import graph_construction as JGC
from dynamicfuion_python_tpu.ops import image_warp as JW
from dynamicfuion_python_tpu_torch.models import deform_net as PD
from dynamicfuion_python_tpu_torch.models import gn_point_cloud_optimizer as PG
from dynamicfuion_python_tpu_torch.models import pwcnet as PP
from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import load_deform_net_checkpoint
from dynamicfuion_python_tpu_torch.ops import correlation as PC
from dynamicfuion_python_tpu_torch.ops import graph_construction as PGC
from dynamicfuion_python_tpu_torch.ops import image_warp as PW
from dynamicfuion_python_tpu_torch.utils.state_conversion import deform_net_state_from_jax

INTR = np.asarray([[100.0, 0.0, 32.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


# -- ops ---------------------------------------------------------------------


def test_correlation_matches_jax(rng):
    first = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    second = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    want = np.asarray(JC.correlation(jnp.asarray(first), jnp.asarray(second)))
    got = PC.correlation(_t(first).permute(0, 3, 1, 2), _t(second).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 12, 10, 81)
    _close(got, want, atol=1e-6)


def _coords(rng, shape, lo, hi):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def test_bilinear_sample_and_grid_sample(rng):
    """Including taps outside the image: zero there, as in the JAX package
    (and as zeros_outside=False, the clamped edge)."""
    img = rng.normal(size=(9, 11, 3)).astype(np.float32)
    u = _coords(rng, (40,), -3.0, 14.0)
    v = _coords(rng, (40,), -3.0, 12.0)
    for zeros in (True, False):
        want = JW.bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), zeros_outside=zeros)
        _close(PW.bilinear_sample(_t(img), _t(u), _t(v), zeros_outside=zeros), want, atol=1e-6)
    assert (np.abs(np.asarray(PW.bilinear_sample(_t(img), _t(u), _t(v)))) > 0).any()
    coords = _coords(rng, (5, 7, 2), -1.3, 1.3)
    want = JW.grid_sample_normalized(jnp.asarray(img), jnp.asarray(coords))
    _close(PW.grid_sample_normalized(_t(img), _t(coords)), want, atol=1e-6)


def test_backward_warp_warp_flow_and_warp_rigid(rng):
    img = rng.normal(size=(16, 20, 4)).astype(np.float32)
    flow = rng.normal(scale=3.0, size=(16, 20, 2)).astype(np.float32)
    want = JW.backward_warp(jnp.asarray(img), jnp.asarray(flow))
    _close(PW.backward_warp(_t(img), _t(flow)), want, atol=1e-6)
    _close(PW.warp_flow(_t(img), _t(flow)), JW.warp_flow(jnp.asarray(img), jnp.asarray(flow)), atol=1e-6)
    depth = (1000 + 100 * rng.random((16, 20))).astype(np.float32)
    depth[:2] = 0
    k = np.asarray([[20.0, 0, 10.0], [0, 20.0, 8.0], [0, 0, 1]], np.float32)
    transform = np.eye(4, dtype=np.float32)
    transform[:3, 3] = [0.02, -0.01, 0.05]
    want = JW.warp_rigid(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(k), jnp.asarray(transform))
    _close(PW.warp_rigid(_t(img), _t(depth), _t(k), _t(transform)), want, atol=1e-5)


def test_upsample_flow_to_full(rng):
    flow2 = rng.normal(size=(1, 16, 24, 2)).astype(np.float32)
    want = JP.upsample_flow_to_full(jnp.asarray(flow2), (64, 96))
    _close(PP.upsample_flow_to_full(_t(flow2), (64, 96)), want, atol=2e-5)


# -- the networks and DeformNet ------------------------------------------------


def _deform_inputs(rng, h=64, w=64, n=9):
    """tests/test_neural_tracker.py::test_deform_net_forward's inputs."""
    source = np.zeros((1, h, w, 6), np.float32)
    source[..., :3] = rng.uniform(size=(1, h, w, 3))
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    source[..., 3] = (u - 32) / 100
    source[..., 4] = (v - 32) / 100
    source[..., 5] = 1.0
    target = source.copy()
    target[..., 5] += 0.02
    nodes = np.zeros((1, n, 3), np.float32)
    nodes[0, :, :2] = np.stack(np.meshgrid(np.linspace(-0.2, 0.2, 3), np.linspace(-0.2, 0.2, 3)), -1).reshape(-1, 2)
    nodes[0, :, 2] = 1.0
    edges = np.full((1, n, 2), -1, np.int32)
    edges[0, :-1, 0] = np.arange(1, n)
    edge_w = np.where(edges >= 0, 1.0, 0.0).astype(np.float32)
    clusters = np.zeros((1, n), np.int32)
    d2 = ((source[0, ..., 3:].reshape(-1, 3)[:, None] - nodes[0][None]) ** 2).sum(-1)
    anchors = np.argsort(d2, 1)[:, :4].astype(np.int32).reshape(1, h, w, 4)
    aw = np.exp(-np.sort(d2, 1)[:, :4] / (2 * 0.2**2))
    aw = (aw / aw.sum(1, keepdims=True)).astype(np.float32).reshape(1, h, w, 4)
    return (source, target, nodes, edges, edge_w, clusters, anchors, aw)


@pytest.fixture(scope="module")
def deform_pair():
    """The JAX DeformNet with its Flax-initialized weights, its forward on
    the JAX test's inputs, and the port's DeformNet with the same weights."""
    rng = np.random.default_rng(0)
    inputs = _deform_inputs(rng)
    gn = dict(num_iterations=1, lm_factor=0.1)
    # 9 nodes and a 64x64 image: the cluster threshold scaled to this size
    guard = dict(min_num_correspondences_per_cluster=100.0)
    from dynamicfuion_python_tpu.models.mask_net import MaskNet as JMaskNet

    jnet = JD.DeformNet(use_mask=True, num_nodes=9, gn_config=JG.GnConfig(**gn), **guard)
    jargs = [jnp.asarray(x) for x in inputs] + [jnp.asarray(INTR)]
    # the two networks initialized apart and jitted: DeformNet's own eager
    # init takes minutes on the CPU (its parameter tree is these two)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    flow_net = jax.jit(JP.PWCNet().init)(k1, jargs[0][..., :3], jargs[1][..., :3])["params"]
    mask_net = jax.jit(JMaskNet().init)(k2, jnp.zeros((1, 16, 16, 565)), jnp.zeros((1, 64, 64, 12)))["params"]
    params = {"params": {"flow_net": flow_net, "mask_net": mask_net}}
    jout = jax.jit(jnet.apply)(params, *jargs)
    pnet = PD.DeformNet(use_mask=True, num_nodes=9, gn_config=PG.GnConfig(**gn), **guard)
    pnet.load_state_dict(deform_net_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return inputs, params, jout, pnet


def test_pwcnet_matches_jax(deform_pair):
    inputs, params, _, pnet = deform_pair
    source, target = inputs[0][..., :3], inputs[1][..., :3]
    want = jax.jit(JP.PWCNet().apply)({"params": params["params"]["flow_net"]}, jnp.asarray(source), jnp.asarray(target))
    with torch.no_grad():
        got = pnet.flow_net(_t(source), _t(target))
    assert got[0].shape == (1, 16, 16, 2) and got[4].shape == (1, 1, 1, 2) and got[5].shape == (1, 16, 16, 565)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_mask_net_matches_jax(deform_pair, rng):
    from dynamicfuion_python_tpu.models.mask_net import MaskNet as JMaskNet

    _, params, _, pnet = deform_pair
    features2 = rng.normal(size=(1, 16, 16, 565)).astype(np.float32)
    x = rng.uniform(size=(1, 64, 64, 12)).astype(np.float32)
    want = jax.jit(JMaskNet().apply)({"params": params["params"]["mask_net"]}, jnp.asarray(features2), jnp.asarray(x))
    with torch.no_grad():
        got = pnet.mask_net(_t(features2), _t(x))
    _close(got, want, atol=1e-5)


def test_deform_net_matches_jax(deform_pair):
    """The whole forward: flows, mask, correspondences and the GN solve
    (1e-4 on the flows, which feed everything after them)."""
    inputs, _, jout, pnet = deform_pair
    with torch.no_grad():
        pout = pnet(*[_t(x) for x in inputs], _t(INTR))
    for g, w in zip(pout.flows, jout.flows):
        _close(g, w, atol=1e-4, rtol=1e-4)
    _close(pout.mask_prediction, jout.mask_prediction, atol=1e-5)
    np.testing.assert_array_equal(pout.valid_correspondence_mask.numpy(), np.asarray(jout.valid_correspondence_mask))
    np.testing.assert_array_equal(pout.valid_solve.numpy(), np.asarray(jout.valid_solve))
    _close(pout.correspondence_weights, jout.correspondence_weights, atol=1e-5)
    _close(pout.target_matches, jout.target_matches, atol=1e-5)
    _close(pout.node_translations, jout.node_translations, atol=1e-4)
    _close(pout.node_rotations, jout.node_rotations, atol=1e-4)
    _close(pout.deformed_points, jout.deformed_points, atol=1e-4)
    _close(pout.gn_losses, jout.gn_losses, atol=0.0, rtol=1e-3)
    _close(pout.deformations_validity, jout.deformations_validity, atol=0.0)
    assert np.isfinite(pout.node_translations.numpy()).all()


def test_deform_net_refuses_sizes_off_64(deform_pair):
    inputs, _, _, pnet = deform_pair
    small = [_t(x) for x in inputs]
    small[0], small[1] = small[0][:, :48], small[1][:, :48]
    with pytest.raises(ValueError, match="divisible by 64"):
        pnet(*small, _t(INTR))


def test_checkpoint_files_load_in_both_packages(deform_pair, tmp_path):
    """A seeded state_dict written as .pt, as {"state_dict": ...} .pth and as
    .npz: the port loads it with load_state_dict's names, the JAX package
    converts it, and the two flow nets give equal flows. A Flax msgpack file
    of the JAX weights loads with exactly Flax's weights."""
    from dynamicfuion_python_tpu.models.torch_weight_conversion import convert_deform_net_checkpoint

    inputs, params, _, _ = deform_pair
    net = PD.DeformNet(use_mask=True, num_nodes=9)
    state = PD.seeded_state_dict(net, torch.Generator().manual_seed(5))
    assert set(state) == set(net.state_dict())
    torch.save(state, tmp_path / "model.pt")
    torch.save({"state_dict": state}, tmp_path / "wrapped.pth")
    np.savez(tmp_path / "model.npz", **{k: v.numpy() for k, v in state.items()})
    source, target = inputs[0][..., :3], inputs[1][..., :3]
    apply = jax.jit(JP.PWCNet().apply)
    for name in ("model.pt", "wrapped.pth", "model.npz"):
        pnet = PD.DeformNet(use_mask=True, num_nodes=9)
        load_deform_net_checkpoint(pnet, tmp_path / name)
        jparams = convert_deform_net_checkpoint(tmp_path / name, params_template=params["params"])
        want = apply({"params": jparams["flow_net"]}, jnp.asarray(source), jnp.asarray(target))
        with torch.no_grad():
            got = pnet.flow_net(_t(source), _t(target))
        for g, w in zip(got, want):
            _close(g, w, atol=1e-4, rtol=1e-4)
    # a flow-only file leaves the mask net as it was; a stray name is refused
    flow_only = {k[len("flow_net."):]: v for k, v in state.items() if k.startswith("flow_net.")}
    torch.save(flow_only, tmp_path / "flow.pt")
    pnet = PD.DeformNet(use_mask=True, num_nodes=9)
    mask_before = pnet.mask_net.upconv1.weight.clone()
    load_deform_net_checkpoint(pnet, tmp_path / "flow.pt")
    assert torch.equal(pnet.mask_net.upconv1.weight, mask_before)
    assert torch.equal(pnet.flow_net.moduleRefiner.moduleMain[12].weight, state["flow_net.moduleRefiner.moduleMain.12.weight"])
    torch.save({**state, "flow_net.stray.weight": torch.zeros(1)}, tmp_path / "stray.pt")
    with pytest.raises(ValueError, match="unexpected"):
        load_deform_net_checkpoint(PD.DeformNet(), tmp_path / "stray.pt")
    # a Flax msgpack parameter file loads with Flax's weights
    import flax.serialization

    (tmp_path / "model.msgpack").write_bytes(flax.serialization.msgpack_serialize(jax.tree_util.tree_map(np.asarray, params)))
    pnet = PD.DeformNet(use_mask=True, num_nodes=9)
    load_deform_net_checkpoint(pnet, tmp_path / "model.msgpack")
    restored = flax.serialization.msgpack_restore((tmp_path / "model.msgpack").read_bytes())
    want = deform_net_state_from_jax(jax.tree_util.tree_map(np.asarray, restored))
    assert set(want) == set(pnet.state_dict())
    for name, value in want.items():
        assert torch.equal(pnet.state_dict()[name], value), name


# -- the point-cloud GN solver (tests/test_neural_tracker.py::TestGnOptimizer)


def _alignment_problem(rng, n_nodes=9, n_matches=200, gt_shift=(0.02, -0.01, 0.03)):
    nodes = np.stack(np.meshgrid(np.linspace(-0.2, 0.2, 3), np.linspace(-0.2, 0.2, 3), indexing="ij"), -1)
    nodes = np.concatenate([nodes.reshape(-1, 2), np.ones((n_nodes, 1))], -1).astype(np.float32)
    pts = rng.uniform(-0.2, 0.2, size=(n_matches, 2)).astype(np.float32)
    pts = np.concatenate([pts, np.ones((n_matches, 1))], -1).astype(np.float32)
    moved = pts + np.asarray(gt_shift, np.float32)
    d2 = ((pts[:, None] - nodes[None]) ** 2).sum(-1)
    anchors = np.argsort(d2, axis=1)[:, :4].astype(np.int32)
    w = np.exp(-np.take_along_axis(d2, anchors, 1) / (2 * 0.2**2))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    uv = np.stack([moved[:, 0] / moved[:, 2] * 100 + 32, moved[:, 1] / moved[:, 2] * 100 + 32], -1).astype(np.float32)
    edges = np.full((n_nodes, 2), -1, np.int32)
    edges[:-1, 0] = np.arange(1, n_nodes)
    edges[1:, 1] = np.arange(n_nodes - 1)
    edge_w = np.where(edges >= 0, 0.5, 0.0).astype(np.float32)
    return dict(nodes=nodes, edges=edges, edge_w=edge_w, pts=pts, anchors=anchors, w=w, uv=uv, z=moved[:, 2])


CASES = {
    "recovers_translation": (dict(num_iterations=3, lm_factor=0.01), None),
    "zero_weight_matches_inert": (dict(num_iterations=3, lm_factor=0.01), "corrupt_half"),
    "non_finite_input": (dict(num_iterations=3, lm_factor=0.01), "nan"),
    "condition_number_ok": (dict(num_iterations=2, lm_factor=0.01, check_condition_num=True, max_condition_num=1e12), None),
    "condition_number_trips": (dict(num_iterations=2, lm_factor=0.01, check_condition_num=True, max_condition_num=1.5), None),
    "edge_weighting": (dict(num_iterations=2, lm_factor=0.1, use_edge_weighting=True, lambda_arap=2.0), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gn_optimizer_matches_jax(case):
    cfg, corruption = CASES[case]
    p = _alignment_problem(np.random.default_rng(0))
    cw = np.ones(len(p["pts"]), np.float32)
    uv = p["uv"].copy()
    if corruption == "corrupt_half":
        uv[:100, 0] += 500.0
        cw[:100] = 0.0
    elif corruption == "nan":
        uv[:, 0] = np.nan
    args = [p["nodes"], p["edges"], p["edge_w"], p["pts"], p["anchors"], p["w"], cw, uv, p["z"], INTR]
    want = JG.optimize_point_cloud_alignment(*[jnp.asarray(a) for a in args], num_nodes=9, config=JG.GnConfig(**cfg))
    got = PG.optimize_point_cloud_alignment(*[_t(a) for a in args], num_nodes=9, config=PG.GnConfig(**cfg))
    assert bool(got.valid_solve) == bool(want.valid_solve)
    # the dense system's condition number is ~1e8 here (lm 0.01 beside
    # pixel-unit blocks of ~1e6), so an f32 LU solve on either side moves the
    # transforms by up to 8e-5 (CPU runs of both packages): 2e-4
    _close(got.translations, want.translations, atol=2e-4)
    _close(got.rotations, want.rotations, atol=2e-4)
    finite = np.isfinite(np.asarray(want.losses))
    _close(got.losses.numpy()[finite], np.asarray(want.losses)[finite], atol=1e-6, rtol=1e-4)
    if cfg.get("check_condition_num"):
        # at that conditioning the f32 eigenvalue estimate of the smallest
        # eigenvalue is noise in both packages: both must be finite and far
        # above the strict cutoff
        assert np.isfinite(got.condition_numbers.numpy()).all() and np.isfinite(np.asarray(want.condition_numbers)).all()
        assert float(got.condition_numbers.min()) > 1e3 and float(np.min(want.condition_numbers)) > 1e3
    # the JAX tests' own gates
    if case in ("recovers_translation", "zero_weight_matches_inert"):
        _close(got.translations, [[0.02, -0.01, 0.03]] * 9, atol=3e-3)
        assert bool(got.valid_solve) and float(got.losses[-1]) < float(got.losses[0])
    elif case == "non_finite_input":
        assert not bool(got.valid_solve)
        _close(got.rotations, np.broadcast_to(np.eye(3), (9, 3, 3)), atol=0.0)
        _close(got.translations, np.zeros((9, 3)), atol=0.0)
    elif case == "condition_number_ok":
        assert bool(got.valid_solve) and np.isfinite(got.condition_numbers.numpy()).all()
    elif case == "condition_number_trips":
        assert not bool(got.valid_solve)


def test_gn_optimizer_singular_solve_is_invalid():
    """A singular system (every weight zero, no LM damping): solve_ex
    reports it in its info, and the solve is marked invalid there, as the
    JAX package's NaN solution is."""
    p = _alignment_problem(np.random.default_rng(1))
    args = [p["nodes"], np.full_like(p["edges"], -1), p["edge_w"], p["pts"], p["anchors"], p["w"],
            np.zeros(len(p["pts"]), np.float32), p["uv"], p["z"], INTR]
    cfg = dict(num_iterations=1, lm_factor=0.0)
    got = PG.optimize_point_cloud_alignment(*[_t(a) for a in args], num_nodes=9, config=PG.GnConfig(**cfg))
    want = JG.optimize_point_cloud_alignment(*[jnp.asarray(a) for a in args], num_nodes=9, config=JG.GnConfig(**cfg))
    assert not bool(got.valid_solve) and not bool(want.valid_solve)
    _close(got.translations, np.zeros((9, 3)), atol=0.0)


# -- track_from_flow, patch-wise threshold -------------------------------------


@pytest.mark.parametrize("variant", ["plain", "bidirectional_and_subsampled"])
def test_track_from_flow_matches_jax(variant):
    """The JAX DeformNet fixture's scene with a known flow (one pixel right),
    mask weights, and for the second variant a backward flow that breaks
    consistency on a band, and subsampling from given uniforms."""
    rng = np.random.default_rng(3)
    source, target, nodes, edges, edge_w, clusters, anchors, aw = _deform_inputs(rng)
    flow = np.zeros((1, 64, 64, 2), np.float32)
    flow[..., 0] = 1.0
    mask_w = rng.uniform(0.5, 1.0, size=(1, 64, 64)).astype(np.float32)
    kw = dict(mask_weights=mask_w)
    if variant != "plain":
        back = -flow.copy()
        back[:, 20:30] += 30.0
        kw.update(flow_back=back, max_matches=1500,
                  match_subsample_uniforms=rng.uniform(size=(1, 64, 64)).astype(np.float32))
    guards = dict(min_num_correspondences_per_cluster=100.0)
    cfg = dict(num_iterations=2, lm_factor=0.1)
    intr = np.broadcast_to(INTR, (1, 3, 3)).copy()
    args = [flow, source, target, nodes, edges, edge_w, clusters, anchors, aw, intr]
    track = jax.jit(JD.track_from_flow, static_argnames=("gn_config", "guards", "max_matches"))
    want = track(*[jnp.asarray(a) for a in args], gn_config=JG.GnConfig(**cfg),
                              guards=JD.TrackingGuards(**guards), **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                                                    for k, v in kw.items()})
    got = PD.track_from_flow(*[_t(a) for a in args], gn_config=PG.GnConfig(**cfg), guards=PD.TrackingGuards(**guards),
                             **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    mask = got["valid_correspondence_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(want["valid_correspondence_mask"]))
    if variant != "plain":
        assert 0 < mask.sum() < 2000
    np.testing.assert_array_equal(got["valid_solve"].numpy(), np.asarray(want["valid_solve"]))
    assert int(got["valid_solve"][0]) == 1
    # jitted, XLA contracts the bilinear taps into FMAs: 1e-5 on the samples
    for key in ("correspondence_weights", "target_matches", "deformations_validity"):
        _close(got[key], want[key], atol=1e-5)
    # the GN solve's f32 conditioning, as in test_gn_optimizer_matches_jax
    for key in ("node_translations", "node_rotations", "deformed_points"):
        _close(got[key], want[key], atol=2e-4)
    _close(got["gn_losses"], want["gn_losses"], atol=0.0, rtol=1e-4)


def test_patchwise_threshold_matches_jax():
    m = np.random.default_rng(11).random((2, 64, 96)).astype(np.float32)
    want = np.asarray(JD.patchwise_threshold(jnp.asarray(m), 16))
    got = PD.patchwise_threshold(_t(m), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got.reshape(2, 4, 16, 6, 16) > 0).sum(axis=(2, 4)) == 1).all()
    ragged = m[:, :40, :50]  # remainder rows / columns are zeroed
    np.testing.assert_array_equal(PD.patchwise_threshold(_t(ragged), 16).numpy(),
                                  np.asarray(JD.patchwise_threshold(jnp.asarray(ragged), 16)))


# -- graph construction for the prior ----------------------------------------


def test_shortest_path_pixel_anchors_and_euclidean_edges(rng):
    nodes = rng.uniform(-0.3, 0.3, size=(30, 3)).astype(np.float32)
    nodes[:, 2] += 1.0
    j_edges, j_w = JGC.compute_edges_euclidean(nodes, 8, 0.1)
    p_edges, p_w = PGC.compute_edges_euclidean(nodes, 8, 0.1)
    np.testing.assert_array_equal(p_edges, j_edges)
    np.testing.assert_array_equal(p_w, j_w)
    pts = rng.uniform(-0.3, 0.3, size=(24, 32, 3)).astype(np.float32)
    pts[..., 2] += 1.0
    pts[rng.random((24, 32)) < 0.2, 2] = 0.0  # invalid pixels
    edges = p_edges.copy()
    edges[::7, 4:] = -1  # a thinner graph
    got = PGC.compute_pixel_anchors_shortest_path(pts, nodes, edges, 4, 0.1)
    want = JGC.compute_pixel_anchors_shortest_path(pts, nodes, edges, 4, 0.1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] >= 0).any() and (got[0][pts[..., 2] == 0] == -1).all()
    few = PGC.compute_edges_euclidean(nodes[:3], 8, 0.1)[0]  # fewer nodes than neighbours: -1 pad
    np.testing.assert_array_equal(few, JGC.compute_edges_euclidean(nodes[:3], 8, 0.1)[0])
    assert few.shape == (3, 8) and (few[:, 2:] == -1).all()
