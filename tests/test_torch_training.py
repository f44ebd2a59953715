"""The port's DeformNet training against the JAX package on the CPU: the
losses and metrics (within 1e-5), gradients through the GN solve (against
``jax.grad``), a discarded solve's gradients, the SGD-momentum and Adam
updates against optax (within 1e-5 relative), a frozen stage, one full
training step from JAX-initialized weights, and a two-step ``train()`` with
its checkpoint."""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.apps import train as JT
from dynamicfuion_python_tpu.models import gn_point_cloud_optimizer as JG
from dynamicfuion_python_tpu.models import losses as JL
from dynamicfuion_python_tpu_torch.apps import train as PT
from dynamicfuion_python_tpu_torch.models import gn_point_cloud_optimizer as PG
from dynamicfuion_python_tpu_torch.models import losses as PL
from dynamicfuion_python_tpu_torch.models.deform_net import seeded_state_dict
from dynamicfuion_python_tpu_torch.utils.state_conversion import deform_net_state_from_jax

Out = namedtuple("Out", "flows node_translations deformations_validity deformed_points mask_prediction")
INTR = np.asarray([[100.0, 0.0, 32.0], [0.0, 100.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the CPU suite runs several test files
    at once, and eight spinning threads per file oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


# -- losses and metrics (tests/test_neural_tracker.py::TestLosses and each
# function of models/losses.py on seeded inputs)


def test_loss_cases_of_the_jax_tests(rng):
    gt = rng.normal(size=(1, 64, 64, 2)).astype(np.float32)
    mask = np.ones((1, 64, 64), bool)
    levels = [PL.downscale_gt_flow(_t(gt), _t(mask), s, s)[0] / 20.0 for s in (16, 8, 8)]
    loss = PL.flow_loss((levels[0], levels[1], levels[2], None, None), _t(gt), _t(mask), PL.LossWeights())
    jlevels = [JL.downscale_gt_flow(jnp.asarray(gt), jnp.asarray(mask), s, s)[0] / 20.0 for s in (16, 8, 8)]
    want = JL.flow_loss((jlevels[0], jlevels[1], jlevels[2], None, None), jnp.asarray(gt), jnp.asarray(mask), JL.LossWeights())
    assert float(loss) < 0.05  # the RobustL1 eps floor
    _close(loss, want)
    pred, gt3, validity = torch.zeros((2, 5, 3)), torch.ones((2, 5, 3)) * 0.1, torch.ones((2, 5))
    _close(PL.graph_loss(pred, gt3, validity), 0.03, atol=1e-6, rtol=0)
    _close(PL.epe_3d(pred, gt3, validity > 0), np.sqrt(0.03), atol=1e-5, rtol=0)


def _loss_inputs(rng, b=2, h=64, w=64, n=7):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        flows=(f(b, h // 4, w // 4, 2) * 0.1, f(b, h // 8, w // 8, 2), f(b, h // 16, w // 16, 2) * 0.1, None, None),
        flow_gt=f(b, h, w, 2) * 3, flow_mask=rng.random((b, h, w)) > 0.2,
        node_t=f(b, n, 3) * 0.05, node_t_gt=f(b, n, 3) * 0.05, validity=(rng.random((b, n)) > 0.3).astype(np.float32),
        deformed=f(b, h * w, 3), deformed_gt=f(b, h * w, 3), deformed_mask=(rng.random((b, h * w)) > 0.4).astype(np.float32),
        mask_pred=rng.uniform(0.01, 0.99, (b, h, w, 1)).astype(np.float32), mask_gt=(rng.random((b, h, w)) > 0.5).astype(np.float32),
        mask_valid=rng.random((b, h, w)) > 0.1,
    )


@pytest.mark.parametrize("flow_loss_type", ["RobustL1", "L2"])
def test_losses_match_jax(rng, flow_loss_type):
    x = _loss_inputs(rng)
    jw = JL.LossWeights(use_mask_loss=True, flow_loss_type=flow_loss_type)
    pw = PL.LossWeights(use_mask_loss=True, flow_loss_type=flow_loss_type)
    t = lambda v: None if v is None else _t(v)
    j = lambda v: None if v is None else jnp.asarray(v)
    _close(PL.robust_l1(_t(x["flow_gt"])), JL.robust_l1(j(x["flow_gt"])))
    for hw in ((16, 16), (4, 4), (32, 16)):
        got, want = PL.downscale_gt_flow(_t(x["flow_gt"]), _t(x["flow_mask"]), *hw), JL.downscale_gt_flow(j(x["flow_gt"]), j(x["flow_mask"]), *hw)
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(PL.flow_loss(tuple(map(t, x["flows"])), _t(x["flow_gt"]), _t(x["flow_mask"]), pw),
           JL.flow_loss(tuple(map(j, x["flows"])), j(x["flow_gt"]), j(x["flow_mask"]), jw))
    _close(PL.graph_loss(_t(x["node_t"]), _t(x["node_t_gt"]), _t(x["validity"])), JL.graph_loss(j(x["node_t"]), j(x["node_t_gt"]), j(x["validity"])))
    _close(PL.warp_loss(_t(x["deformed"]), _t(x["deformed_gt"]), _t(x["deformed_mask"])),
           JL.warp_loss(j(x["deformed"]), j(x["deformed_gt"]), j(x["deformed_mask"])))
    for ratio in (0.05, None):
        _close(PL.mask_bce_loss(_t(x["mask_pred"]), _t(x["mask_gt"]), _t(x["mask_valid"]), ratio),
               JL.mask_bce_loss(j(x["mask_pred"]), j(x["mask_gt"]), j(x["mask_valid"]), ratio))
    pout = Out(tuple(map(t, x["flows"])), _t(x["node_t"]), _t(x["validity"]), _t(x["deformed"]), _t(x["mask_pred"]))
    jout = Out(tuple(map(j, x["flows"])), j(x["node_t"]), j(x["validity"]), j(x["deformed"]), j(x["mask_pred"]))
    got_total, got_parts = PL.total_loss(pout, _t(x["flow_gt"]), _t(x["flow_mask"]), _t(x["node_t_gt"]), _t(x["deformed_gt"]),
                                         _t(x["deformed_mask"]), _t(x["mask_gt"]), _t(x["mask_valid"]), pw)
    want_total, want_parts = JL.total_loss(jout, j(x["flow_gt"]), j(x["flow_mask"]), j(x["node_t_gt"]), j(x["deformed_gt"]),
                                           j(x["deformed_mask"]), j(x["mask_gt"]), j(x["mask_valid"]), jw)
    assert sorted(got_parts) == sorted(want_parts) == ["flow", "graph", "mask", "total", "warp"]
    for k in want_parts:
        _close(got_parts[k], want_parts[k])
    _close(got_total, want_total)
    full = rng.normal(size=(2, 64, 64, 2)).astype(np.float32)
    _close(PL.epe_2d(_t(full), _t(x["flow_gt"]), _t(x["flow_mask"])), JL.epe_2d(j(full), j(x["flow_gt"]), j(x["flow_mask"])))
    _close(PL.epe_3d(_t(x["node_t"]), _t(x["node_t_gt"]), _t(x["validity"] > 0)), JL.epe_3d(j(x["node_t"]), j(x["node_t_gt"]), j(x["validity"] > 0)))
    valid_solve = np.asarray([1, 0, 1], np.uint8)
    _close(PL.valid_ratio(_t(valid_solve)), JL.valid_ratio(j(valid_solve)))


def test_baseline_mask_gt_matches_jax(rng):
    b, h, w = 2, 24, 32
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    src = np.stack([(u - w / 2) / 30, (v - h / 2) / 30, np.ones((h, w), np.float32)], -1)[None].repeat(b, 0)
    src[:, :3, :, 2] = 0.0
    tgt = src + rng.normal(size=src.shape).astype(np.float32) * 0.05
    tgt[:, -4:, :, 2] = 7.0
    sf = rng.normal(size=src.shape).astype(np.float32) * 0.1
    flow = rng.normal(size=(b, h, w, 2)).astype(np.float32) * 2
    sf_mask = rng.random((b, h, w)) > 0.1
    boundary = rng.random((b, h, w)) > 0.9
    got = PL.compute_baseline_mask_gt(*[_t(a) for a in (flow, src, tgt, sf, sf_mask, boundary)])
    want = JL.compute_baseline_mask_gt(*[jnp.asarray(a) for a in (flow, src, tgt, sf, sf_mask, boundary)])
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert 0 < float(got[0].sum()) and got[1].sum() > got[0].sum()


# -- gradients through the GN solve (tests/test_neural_tracker.py::
# test_differentiable_through_solve's problem)


def _alignment_problem():
    rng = np.random.default_rng(0)
    nodes = np.stack(np.meshgrid(np.linspace(-0.2, 0.2, 3), np.linspace(-0.2, 0.2, 3), indexing="ij"), -1)
    nodes = np.concatenate([nodes.reshape(-1, 2), np.ones((9, 1))], -1).astype(np.float32)
    pts = np.concatenate([rng.uniform(-0.2, 0.2, size=(200, 2)), np.ones((200, 1))], -1).astype(np.float32)
    moved = pts + np.asarray((0.02, -0.01, 0.03), np.float32)
    d2 = ((pts[:, None] - nodes[None]) ** 2).sum(-1)
    anchors = np.argsort(d2, axis=1)[:, :4].astype(np.int32)
    w = np.exp(-np.take_along_axis(d2, anchors, 1) / (2 * 0.2**2))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    uv = np.stack([moved[:, 0] / moved[:, 2] * 100 + 32, moved[:, 1] / moved[:, 2] * 100 + 32], -1).astype(np.float32)
    edges = np.full((9, 2), -1, np.int32)
    edges[:-1, 0] = np.arange(1, 9)
    edges[1:, 1] = np.arange(8)
    edge_w = np.where(edges >= 0, 0.5, 0.0).astype(np.float32)
    return [nodes, edges, edge_w, pts, anchors, w, np.ones(200, np.float32)], uv, moved[:, 2]


def _jax_grad(cfg: dict, dtype):
    args, uv, z = _alignment_problem()
    cast = lambda a: jnp.asarray(a, dtype) if a.dtype.kind == "f" else jnp.asarray(a)

    def loss(uv_):
        r = JG.optimize_point_cloud_alignment(
            *[cast(a) for a in args], uv_, cast(z), cast(INTR), num_nodes=9, config=JG.GnConfig(**cfg),
            initial_rotations=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (9, 3, 3)), initial_translations=jnp.zeros((9, 3), dtype),
        )
        return jnp.sum(r.translations**2)

    return np.asarray(jax.grad(loss)(jnp.asarray(uv, dtype)))


def _port_grad(cfg: dict, dtype, problem=None):
    args, uv, z = problem or _alignment_problem()
    cast = lambda a: torch.as_tensor(a).to(dtype) if a.dtype.kind == "f" else torch.as_tensor(a)
    uv_ = torch.tensor(uv, dtype=dtype, requires_grad=True)
    r = PG.optimize_point_cloud_alignment(*[cast(a) for a in args], uv_, cast(z), cast(INTR), num_nodes=9, config=PG.GnConfig(**cfg))
    torch.sum(r.translations**2).backward()
    return uv_.grad.numpy(), r


SOLVE = dict(num_iterations=2, lm_factor=0.01)


def test_gradients_through_the_solve_match_jax_grad():
    """In float64 the two packages agree within rtol 1e-4 (both run the
    same arithmetic; JAX under ``jax.enable_x64``). The dense system's
    condition number is ~1e8 here (lm 0.01 beside pixel-unit blocks of
    ~1e6), so in float32 each package's gradient lies up to ~4e-3 of the
    largest entry from the float64 one (JAX 4.3e-3, the port 3.0e-3 on the
    CPU): the float32 gradients are held within 1e-2 of it."""
    with jax.enable_x64(True):
        want64 = _jax_grad(SOLVE, jnp.float64)
    got64, _ = _port_grad(SOLVE, torch.float64)
    assert np.abs(want64).max() > 0
    np.testing.assert_allclose(got64, want64, rtol=1e-4, atol=0)
    scale = np.abs(want64).max()
    for g32 in (_port_grad(SOLVE, torch.float32)[0], _jax_grad(SOLVE, jnp.float32)):
        assert np.isfinite(g32).all() and np.abs(g32 - want64).max() <= 1e-2 * scale


def test_discarded_solve_has_finite_gradients():
    """A solve discarded by the condition-number cutoff gives finite (zero)
    gradients in both packages; so does, in the port, a solve whose
    factorization fails (a node with no match, no edge and no damping),
    where a masked-out NaN would otherwise reach the backward pass."""
    tripped = dict(num_iterations=2, lm_factor=0.01, check_condition_num=True, max_condition_num=1.5)
    want = _jax_grad(tripped, jnp.float32)
    got, result = _port_grad(tripped, torch.float32)
    assert not bool(result.valid_solve)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    args, uv, z = _alignment_problem()
    args[1] = np.full_like(args[1], -1)  # no edges
    args[4] = np.minimum(args[4], 7)  # node 8 anchors nothing: a zero block
    got, result = _port_grad(dict(num_iterations=2, lm_factor=0.0), torch.float32, (args, uv, z))
    assert not bool(result.valid_solve) and np.isfinite(got).all()
    assert np.isfinite(result.translations.detach().numpy()).all()


# -- the optimizers against optax, from JAX-initialized weights


@pytest.fixture(scope="module")
def jax_params():
    """DeformNet's Flax parameters, its two networks initialized apart and
    jitted (the eager init of the whole module takes minutes on the CPU)."""
    from dynamicfuion_python_tpu.models.mask_net import MaskNet
    from dynamicfuion_python_tpu.models.pwcnet import PWCNet

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x = jnp.zeros((1, 64, 64, 3))
    flow_net = jax.jit(PWCNet().init)(k1, x, x)["params"]
    mask_net = jax.jit(MaskNet().init)(k2, jnp.zeros((1, 16, 16, 565)), jnp.zeros((1, 64, 64, 12)))["params"]
    return jax.tree_util.tree_map(np.asarray, {"params": {"flow_net": flow_net, "mask_net": mask_net}})


def _port_model(params, use_mask=True, **kwargs):
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet

    model = DeformNet(use_mask=use_mask, **kwargs)
    state = deform_net_state_from_jax(params)
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()})
    return model


OPTIMIZERS = {
    "sgd_momentum_decay_steplr": dict(use_adam=False, momentum=0.9, use_lr_scheduler=True, step_lr=1, weight_decay=1e-3),
    "sgd_momentum": dict(use_adam=False, momentum=0.9, use_lr_scheduler=False, step_lr=1000, weight_decay=0.0),
    "adam": dict(use_adam=True, momentum=0.9, use_lr_scheduler=True, step_lr=1000, weight_decay=0.0),
}


@pytest.mark.parametrize("opt, stage", [("sgd_momentum_decay_steplr", "3_refine"), ("sgd_momentum", "2_mask"),
                                        ("adam", "3_refine")])
def test_optimizer_steps_match_optax(jax_params, opt, stage):
    """Updates with the same seeded gradients: torch.optim (SGD with
    momentum, weight decay and StepLR, two steps so the momentum and the
    decay count; or one Adam step) against the JAX package's optax chain,
    parameters within 1e-5 relative; a frozen net (the flow net of 2_mask)
    stays bit-equal. (optax's f32 bias correction 1 - 0.999^t loses ~3e-5
    relative at t = 2 against torch's f64 one, more than the tolerance on
    zero-initialized biases: Adam takes one step.)"""
    import optax

    kw = OPTIMIZERS[opt]
    lr = 1e-2
    rng = np.random.default_rng(1)
    steps = 1 if kw["use_adam"] else 2
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, jax_params) for _ in range(steps)]
    jstage, pstage = JT.STAGES[stage], PT.STAGES[stage]
    tx = JT._stage_optimizer(jstage, jax_params, lr, **kw)
    @jax.jit
    def update(params, state, g):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = tx.init(params)
    for g in grads:
        params, state = update(params, state, jax.tree_util.tree_map(jnp.asarray, g))
    want = deform_net_state_from_jax(jax.tree_util.tree_map(np.asarray, params))

    model = _port_model(jax_params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = PT._stage_optimizer(pstage, model, lr, **kw)
    for g in grads:
        gstate = deform_net_state_from_jax(g)
        for name, p in model.named_parameters():
            p.grad = gstate[name].clone() if p.requires_grad else None
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    got = model.state_dict()
    moved = False
    for name, w in want.items():
        # 1e-5 relative to each tensor's largest entry: optax rounds Adam's
        # bias correction 1 - 0.999 in f32 (1.3e-5 relative), so an entry
        # the step moves to near zero differs by more than 1e-5 of itself
        _close(got[name], w, atol=1e-5 * float(np.abs(w.numpy()).max()), rtol=1e-5)
        if stage == "2_mask" and name.startswith("flow_net."):
            assert torch.equal(got[name], before[name])
        moved |= not torch.equal(got[name], before[name])
    assert moved


# -- one full training step and train()


def _split(tmp_path, size=(64, 128)):
    """A labeled synthetic split (two sequences, four pairs) with graphs at
    node coverage 0.08."""
    from dynamicfuion_python_tpu_torch.apps import create_graph_data
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split

    for seq in write_split(tmp_path / "train", size):
        create_graph_data.main([str(seq), "--node-coverage", "0.08", "--frames", "0", "--labels", str(tmp_path / "train.json")])
    return tmp_path


def test_train_step_matches_jax(tmp_path, jax_params):
    """Stage 1_solver at 64x128, batch 2, from JAX-initialized weights, one
    SGD step: the loss and its parts within 1e-4 relative, and the step
    each parameter took (the learning rate times its gradient, through the
    GN solve) within 1e-3 of the tensor's largest step. The learning rate
    is 10, so each step stands far above the parameters' f32 spacing. The
    GN's cluster threshold is scaled to the image (100 matches)."""
    from dynamicfuion_python_tpu.models.deform_net import DeformNet as JaxDeformNet
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset

    _split(tmp_path)
    batch = LabeledDeformDataset(tmp_path, "train", input_size=(64, 128), max_nodes=32).batch([0, 3])
    batch["node_translations_gt"] = PT.node_translations_gt_from_scene_flow(batch)[0]
    batch["match_subsample_uniforms"] = np.random.default_rng(2).uniform(size=batch["target"].shape[:3]).astype(np.float32)
    lr, guard = 10.0, dict(min_num_correspondences_per_cluster=100.0)
    flow_only = {"params": {"flow_net": jax_params["params"]["flow_net"]}}

    jmodel = JaxDeformNet(use_mask=False, num_nodes=32, gn_config=JG.GnConfig(num_iterations=3, lm_factor=0.1),
                          gn_max_matches=1000, **guard)
    tx = JT._stage_optimizer(JT.STAGES["1_solver"], flow_only, lr, use_adam=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, flow_only)
    step = JT.make_train_step(jmodel, tx, JT.STAGES["1_solver"])
    jparams, _, jloss, jparts = step(jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(flow_only, use_mask=False, num_nodes=32, gn_config=PG.GnConfig(num_iterations=3, lm_factor=0.1),
                        gn_max_matches=1000, **guard)
    optimizer, scheduler = PT._stage_optimizer(PT.STAGES["1_solver"], model, lr, use_adam=False)
    loss, parts = PT.make_train_step(model, optimizer, PT.STAGES["1_solver"], scheduler)(PT.batch_to_device(batch, "cpu"))
    assert np.isfinite(float(loss)) and float(parts["graph"]) > 0 and float(parts["warp"]) > 0
    _close(loss, jloss, atol=0, rtol=1e-4)
    for k in jparts:
        _close(parts[k], jparts[k], atol=1e-7, rtol=1e-4)
    want = deform_net_state_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    start = deform_net_state_from_jax(flow_only)
    moved = 0
    for name, w in want.items():
        step_got, step_want = (model.state_dict()[name] - start[name]).numpy(), (w - start[name]).numpy()
        moved += bool(np.abs(step_want).max() > 0)
        np.testing.assert_allclose(step_got, step_want, atol=1e-3 * np.abs(step_want).max(), rtol=0, err_msg=name)
    assert moved > len(want) // 2


def test_two_step_train_and_checkpoint(tmp_path):
    """train() at 64x128, batch 1, on one repeated pair: the loss falls, the
    checkpoint reloads bit-equal, and a frozen stage keeps its flow net."""
    from dynamicfuion_python_tpu_torch.settings import TrainingConfig

    import json

    _split(tmp_path)
    labels = json.loads((tmp_path / "train.json").read_text())
    (tmp_path / "one.json").write_text(json.dumps(labels[:1]))
    cfg = TrainingConfig(shuffle=False)
    kwargs = dict(labeled=True, labels_filename="one", image_size=(64, 128), batch_size=1, max_nodes=32, device="cpu",
                  training_config=cfg)
    model, history = PT.train(str(tmp_path), stage="1_solver", iterations=2, learning_rate=1e-4, eval_every=2,
                              checkpoint_dir=str(tmp_path / "ckpt"), **kwargs)
    assert len(history) == 2 and all(np.isfinite(history)) and history[1] < history[0]
    assert (tmp_path / "ckpt" / "step_1.pt").is_file() and (tmp_path / "ckpt" / "eval_history.json").is_file()
    reloaded = PT.load_checkpoint(tmp_path / "ckpt", PT.build_model(PT.STAGES["1_solver"], 32, 100))
    for name, value in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[name], value.cpu())
    seeded = PT.build_model(PT.STAGES["2_mask"], 32, 100)
    seeded.load_state_dict(seeded_state_dict(seeded, torch.Generator().manual_seed(0)))
    frozen, _ = PT.train(str(tmp_path), stage="2_mask", iterations=1, learning_rate=1e-3, eval_every=0,
                         checkpoint_dir=str(tmp_path / "ckpt2"), **kwargs)
    flow = [k for k in seeded.state_dict() if k.startswith("flow_net.")]
    assert flow and all(torch.equal(frozen.state_dict()[k], seeded.state_dict()[k]) for k in flow)
    assert any(not torch.equal(frozen.state_dict()[k], v) for k, v in seeded.state_dict().items()
               if k.startswith("mask_net."))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        PT.train(str(tmp_path), stage="1_solver", **kwargs)
