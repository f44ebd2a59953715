"""DeformNet training, the 4-stage curriculum (port of
``dynamicfuion_python_tpu/apps/train.py``).

``0_flow`` (flow loss only, solver skipped) -> ``1_solver`` (+ graph and warp
losses through the differentiable GN solve) -> ``2_mask`` (+ MaskNet and the
weighted BCE against ``compute_baseline_mask_gt``'s oracle masks, flow net
frozen) -> ``3_refine`` (everything trains). SGD with momentum and a step
learning-rate decay (or Adam), periodic evaluation (losses, EPE 2D, Graph
Error 3D, EPE 3D, valid-solve ratio), the too-large-translation invalidation
of a solve, and time-throttled checkpoints (``step_<n>.pt``, the model's
``state_dict``, with ``latest.json``); an interrupted run saves one last
checkpoint.

One training step (forward with the GN solve, the loss, backward, the
optimizer) runs on the device with TF32 off for matrix products and cuDNN
convolutions over the whole step, backward included, so the card rounds as
the CPU does. Data loading stays host-side numpy; the shuffles, validation
picks and match-subsampling uniforms come from one
``np.random.default_rng(seed)`` in the JAX package's order, so both packages
see the same batches.

Run: python -m dynamicfuion_python_tpu_torch.apps.train --data <root> \\
        [--labeled] [--stage 1_solver] [--size HxW] [--device cuda|cpu] \\
        checkpoint_dir=<dir> [key=value ...]
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.data.deform_dataset import DeformDataset, LabeledDeformDataset
from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict
from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig
from dynamicfuion_python_tpu_torch.models.losses import (
    LossWeights,
    compute_baseline_mask_gt,
    epe_2d,
    epe_3d,
    total_loss,
    valid_ratio,
)
from dynamicfuion_python_tpu_torch.models.pwcnet import upsample_flow_to_full
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


class StageConfig:
    """One curriculum stage: which losses fire, which nets freeze, whether
    the GN solver runs and whether the model has its mask net."""

    def __init__(self, weights, freeze_flow=False, freeze_mask=False, skip_solver=False, use_mask_net=True):
        self.weights = weights
        self.freeze_flow = freeze_flow
        self.freeze_mask = freeze_mask
        self.skip_solver = skip_solver
        self.use_mask_net = use_mask_net


STAGES = {
    "0_flow": StageConfig(
        LossWeights(use_flow_loss=True, use_graph_loss=False, use_warp_loss=False, use_mask_loss=False),
        skip_solver=True, use_mask_net=False,
    ),
    "1_solver": StageConfig(
        LossWeights(use_flow_loss=True, use_graph_loss=True, use_warp_loss=True, use_mask_loss=False),
        use_mask_net=False,
    ),
    "2_mask": StageConfig(
        LossWeights(use_flow_loss=True, use_graph_loss=True, use_warp_loss=True, use_mask_loss=True),
        freeze_flow=True,
    ),
    "3_refine": StageConfig(
        LossWeights(use_flow_loss=True, use_graph_loss=True, use_warp_loss=True, use_mask_loss=True),
    ),
}

# a solve whose mean node-translation error exceeds this (metres) is left
# out of the solver-dependent loss terms
GN_MAX_MEAN_TRANSLATION_ERROR = 0.5


@contextlib.contextmanager
def fp32_step():
    """TF32 off for cuBLAS matrix products and cuDNN convolutions while the
    block runs (a whole step: the backward runs after the forward's own
    ``fp32_convolutions`` block has closed), the previous flags restored."""
    previous = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = previous


def node_translations_gt_from_scene_flow(batch) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth node translations: the scene flow at each node's
    projected pixel (rounded down, clamped to the image), and their
    validity (node in front of the camera, scene flow valid and finite)."""
    nodes = batch["graph_nodes"]  # [B, N, 3]
    intr = batch["intrinsics"]
    sf = batch["scene_flow_gt"]  # [B, H, W, 3]
    b, n, _ = nodes.shape
    h, w = sf.shape[1:3]
    gt = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), np.float32)
    for i in range(b):
        fx, fy = intr[i][0, 0], intr[i][1, 1]
        cx, cy = intr[i][0, 2], intr[i][1, 2]
        z = nodes[i][:, 2]
        u = np.clip((nodes[i][:, 0] / np.maximum(z, 1e-6) * fx + cx), 0, w - 1)
        v = np.clip((nodes[i][:, 1] / np.maximum(z, 1e-6) * fy + cy), 0, h - 1)
        gt[i] = sf[i][v.astype(int), u.astype(int)]
        sf_ok = batch["scene_flow_mask"][i][v.astype(int), u.astype(int)]
        valid[i] = (z > 0) & sf_ok & np.isfinite(gt[i]).all(-1)
    return gt, valid


def _forward_and_loss(model: DeformNet, batch: dict, stage: StageConfig):
    """Model forward, ground-truth preparation and the total loss: (loss,
    (parts, output))."""
    weights = stage.weights
    out = model(
        batch["source"], batch["target"], batch["graph_nodes"], batch["graph_edges"],
        batch["graph_edges_weights"], batch["graph_clusters"], batch["pixel_anchors"], batch["pixel_weights"],
        batch["intrinsics"], match_subsample_uniforms=batch.get("match_subsample_uniforms"),
    )
    # a solve whose mean node-translation error is too large gives noisy
    # gradients: drop it from the solver-dependent terms
    validity = out.deformations_validity
    err = torch.linalg.norm(out.node_translations - batch["node_translations_gt"], dim=-1)
    mean_err = torch.sum(err * validity, dim=1) / torch.clamp(torch.sum(validity, dim=1), min=1.0)
    keep = (mean_err <= GN_MAX_MEAN_TRANSLATION_ERROR).to(torch.float32)
    out = out._replace(
        deformations_validity=validity * keep[:, None],
        valid_solve=(out.valid_solve.to(torch.float32) * keep).to(torch.uint8),
    )
    shape = out.deformed_points.shape
    deformed_gt = batch["source"][..., 3:].reshape(shape) + batch["scene_flow_gt"].reshape(shape)
    deformed_mask = batch["scene_flow_mask"].reshape(shape[:2]).to(torch.float32) * keep[:, None]

    mask_gt = mask_valid = None
    if weights.use_mask_loss:
        h, w = batch["source"].shape[1:3]
        flow_full = upsample_flow_to_full(out.flows[0], (h, w)).detach()  # the oracle takes no gradient
        mask_gt, mask_valid = compute_baseline_mask_gt(
            flow_full, batch["source"][..., 3:], batch["target"][..., 3:], batch["scene_flow_gt"],
            batch["scene_flow_mask"].bool(), batch["target_boundary_mask"].bool(),
        )
    loss, parts = total_loss(
        out, batch["flow_gt"], batch["flow_mask"], batch["node_translations_gt"], deformed_gt, deformed_mask,
        mask_gt=mask_gt, mask_valid=mask_valid, weights=weights,
    )
    return loss, (parts, out)


def make_train_step(model: DeformNet, optimizer, stage: StageConfig, scheduler=None):
    """``train_step(batch, events=None) -> (loss, parts)``: forward,
    backward, optimizer step (and scheduler step), all with TF32 off. The
    returned tensors are detached and stay on the device. ``events``, four
    CUDA events, are recorded before the forward, the backward and the
    optimizer step and after it."""

    def train_step(batch, events=None):
        mark = (lambda i: events[i].record()) if events is not None else (lambda i: None)
        with fp32_step():
            mark(0)
            optimizer.zero_grad(set_to_none=True)
            loss, (parts, _) = _forward_and_loss(model, batch, stage)
            mark(1)
            loss.backward()
            mark(2)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            mark(3)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return train_step


def make_eval_step(model: DeformNet, stage: StageConfig):
    """``eval_step(batch) -> metrics``: the losses and the paper metrics
    (EPE 2D, Graph Error 3D, EPE 3D, valid-solve ratio) of one batch,
    without gradients."""

    def eval_step(batch):
        with fp32_step(), torch.no_grad():
            _, (parts, out) = _forward_and_loss(model, batch, stage)
            h, w = batch["source"].shape[1:3]
            flow_full = upsample_flow_to_full(out.flows[0], (h, w))
            metrics = dict(parts)
            metrics["epe_2d"] = epe_2d(flow_full, batch["flow_gt"], batch["flow_mask"].bool())
            metrics["graph_error_3d"] = epe_3d(
                out.node_translations, batch["node_translations_gt"], out.deformations_validity > 0
            )
            shape = out.deformed_points.shape
            deformed_gt = batch["source"][..., 3:].reshape(shape) + batch["scene_flow_gt"].reshape(shape)
            metrics["epe_3d"] = epe_3d(out.deformed_points, deformed_gt, batch["scene_flow_mask"].reshape(shape[:2]) > 0)
            metrics["valid_ratio"] = valid_ratio(out.valid_solve)
        return metrics

    return eval_step


def _stage_optimizer(stage: StageConfig, model: DeformNet, learning_rate, use_adam, momentum=0.9,
                     use_lr_scheduler=True, step_lr=1000, weight_decay=0.0):
    """(optimizer, scheduler or None). SGD with momentum (no dampening) and,
    with ``use_lr_scheduler``, the learning rate times 0.1 every ``step_lr``
    steps; or Adam at a constant rate. Weight decay adds ``weight_decay *
    p`` to each gradient. A frozen net is left out of the optimizer and its
    parameters stop requiring gradients."""
    frozen = {"flow_net": stage.freeze_flow, "mask_net": stage.freeze_mask}
    params = []
    for name, child in model.named_children():
        child.requires_grad_(not frozen.get(name, False))
        if not frozen.get(name, False):
            params.extend(child.parameters())
    if use_adam:
        return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay), None
    optimizer = torch.optim.SGD(params, lr=learning_rate, momentum=momentum, dampening=0.0, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.StepLR(optimizer, step_size=step_lr, gamma=0.1) if use_lr_scheduler else None
    return optimizer, scheduler


def build_model(stage: StageConfig, max_nodes: int, gn_max_matches: int) -> DeformNet:
    """The stage's DeformNet: the mask net when the stage uses it, 3 GN
    iterations at LM factor 0.1 (none when the solver is skipped)."""
    return DeformNet(
        use_mask=stage.use_mask_net,
        num_nodes=max_nodes,
        gn_config=GnConfig(num_iterations=0 if stage.skip_solver else 3, lm_factor=0.1),
        gn_max_matches=gn_max_matches,
    )


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch -> tensors on ``device`` (floats f32; ints, bools as they
    are)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.to(torch.float32) if t.is_floating_point() else t).to(device)
    return out


def _with_max_matches(model: DeformNet, max_matches: int) -> DeformNet:
    """The same networks (shared parameters) with another match budget."""
    view = copy.copy(model)
    view.gn_max_matches = max_matches
    return view


def train(
    data_root: str,
    stage: str = "1_solver",
    batch_size: int | None = None,
    learning_rate: float | None = None,
    iterations: int | None = None,
    max_nodes: int = 128,
    checkpoint_dir: str | None = None,
    eval_every: int = 50,
    seed: int = 0,
    image_size=None,
    node_coverage: float = 0.05,
    use_adam: bool | None = None,
    momentum: float | None = None,
    use_lr_scheduler: bool = True,
    step_lr: int = 1000,
    training_config=None,
    labeled: bool = False,
    labels_filename: str = "train",
    val_labels_filename: str = "val",
    device: str | torch.device | None = None,
    stats: dict | None = None,
):
    """Train a stage; returns (model, loss history).

    ``training_config`` (``settings.TrainingConfig``) supplies the defaults
    (batch size, learning rate, momentum, weight decay, Adam, shuffling,
    match budgets); explicit arguments override. ``labeled`` reads the pairs
    of ``<data_root>/<labels_filename>.json`` (center crop, 448x640 by
    default) instead of building graphs under ``<data_root>/train``. The
    model starts from weights seeded by ``seed``. ``checkpoint_dir`` is
    required: checkpoints and ``eval_history.json`` go there. ``device``
    defaults to the CUDA card. ``stats``, when given,
    receives per step ``data_s`` (host seconds to load and prepare the
    batch) and, on the card, ``forward_ms`` / ``backward_ms`` /
    ``optimizer_ms`` / ``step_ms`` from CUDA events."""
    from dynamicfuion_python_tpu_torch.ops.image_proc_extras import compute_boundary_mask
    from dynamicfuion_python_tpu_torch.settings import TrainingConfig

    if checkpoint_dir is None:
        raise ValueError("train() needs checkpoint_dir: the directory its checkpoints go to")
    device = resolve_device(device)
    cfg = training_config or TrainingConfig()
    batch_size = cfg.batch_size if batch_size is None else batch_size
    learning_rate = cfg.learning_rate if learning_rate is None else learning_rate
    use_adam = cfg.use_adam if use_adam is None else use_adam
    momentum = cfg.momentum if momentum is None else momentum
    if labeled:
        size = tuple(image_size) if image_size is not None else (448, 640)
        dataset = LabeledDeformDataset(data_root, labels_filename, input_size=size, max_nodes=max_nodes)
        if len(dataset) == 0:
            raise ValueError(f"no pairs listed in {data_root}/{labels_filename}.json")
        try:
            val_dataset = LabeledDeformDataset(data_root, val_labels_filename, input_size=size, max_nodes=max_nodes)
            if len(val_dataset) == 0:
                val_dataset = dataset
        except FileNotFoundError:
            val_dataset = dataset
    else:
        dataset = DeformDataset(Path(data_root) / "train", max_nodes=max_nodes, image_size=image_size,
                                node_coverage=node_coverage)
        if len(dataset) == 0:
            raise ValueError(f"no labeled pairs under {data_root}/train")
        try:
            val_dataset = DeformDataset(Path(data_root) / "val", max_nodes=max_nodes, image_size=image_size,
                                        node_coverage=node_coverage)
            if len(val_dataset) == 0:
                val_dataset = dataset
        except (FileNotFoundError, ValueError):
            val_dataset = dataset
    stage_cfg = STAGES[stage]
    if iterations is None:
        iterations = max(1, cfg.epochs * ((len(dataset) + batch_size - 1) // batch_size))

    model = build_model(stage_cfg, max_nodes, cfg.gn_max_matches_train)
    model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(seed)))
    model.to(device)
    model_eval = _with_max_matches(model, cfg.gn_max_matches_eval)
    optimizer, scheduler = _stage_optimizer(
        stage_cfg, model, learning_rate, use_adam=use_adam, momentum=momentum,
        use_lr_scheduler=use_lr_scheduler, step_lr=step_lr, weight_decay=cfg.weight_decay,
    )
    train_step = make_train_step(model, optimizer, stage_cfg, scheduler)
    eval_step = make_eval_step(model_eval, stage_cfg)

    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    np_rng = np.random.default_rng(seed)
    history, eval_history = [], []
    last_save = time.time()
    timed = stats is not None and device.type == "cuda"
    if stats is not None:
        for key in ("data_s", "forward_ms", "backward_ms", "optimizer_ms", "step_ms") if timed else ("data_s",):
            stats.setdefault(key, [])

    def prepare(batch):
        gt_t, _ = node_translations_gt_from_scene_flow(batch)
        batch["node_translations_gt"] = gt_t
        if "target_boundary_mask" not in batch:
            # the on-the-fly dataset: a depth-step boundary of the target
            batch["target_boundary_mask"] = np.stack(
                [compute_boundary_mask(torch.from_numpy(z), 0.1).numpy() for z in batch["target"][..., 5]]
            )
        batch["match_subsample_uniforms"] = np_rng.uniform(size=batch["target"].shape[:3]).astype(np.float32)
        return batch_to_device(batch, device)

    events = []
    it = 0
    model.train()
    try:
        for it in range(iterations):
            t0 = time.perf_counter()
            if cfg.shuffle:
                idx = np_rng.choice(len(dataset), size=min(batch_size, len(dataset)), replace=len(dataset) < batch_size)
            else:
                idx = [(it * batch_size + j) % len(dataset) for j in range(min(batch_size, len(dataset)))]
            batch = prepare(dataset.batch(idx))
            if stats is not None:
                stats["data_s"].append(time.perf_counter() - t0)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else None
            loss, parts = train_step(batch, marks)
            if timed:
                events.append(marks)
            history.append(float(loss))
            if it % 10 == 0:
                print(f"iter {it}: loss {float(loss):.4f} " + " ".join(f"{k}={float(v):.4f}" for k, v in parts.items()),
                      flush=True)
            if eval_every > 0 and (it + 1) % eval_every == 0:
                vidx = np_rng.choice(len(val_dataset), size=min(batch_size, len(val_dataset)),
                                     replace=len(val_dataset) < batch_size)
                metrics = {k: float(v) for k, v in eval_step(prepare(val_dataset.batch(vidx))).items()}
                metrics["iteration"] = it
                eval_history.append(metrics)
                print(f"eval @{it}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)
            if time.time() - last_save > 300 or it == iterations - 1:
                save_checkpoint(ckpt_dir, model, it)
                last_save = time.time()
    except (KeyboardInterrupt, ConnectionResetError):
        # a killed run still leaves its last state on disk
        save_checkpoint(ckpt_dir, model, it)
        print(f"interrupted at iteration {it}: snapshot saved", flush=True)
        raise
    if timed:
        torch.cuda.synchronize()
        for start, forward_end, backward_end, end in events:
            stats["forward_ms"].append(start.elapsed_time(forward_end))
            stats["backward_ms"].append(forward_end.elapsed_time(backward_end))
            stats["optimizer_ms"].append(backward_end.elapsed_time(end))
            stats["step_ms"].append(start.elapsed_time(end))
    if eval_history:
        (ckpt_dir / "eval_history.json").write_text(json.dumps(eval_history, indent=1))
    if stats is not None:
        stats["eval_history"] = eval_history
    return model, history


def save_checkpoint(ckpt_dir: str | Path, model: torch.nn.Module, step: int) -> Path:
    """``<ckpt_dir>/step_<step>.pt`` (the model's ``state_dict`` on the CPU,
    loadable as a prior checkpoint) and ``latest.json`` naming it."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step}.pt"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    (ckpt_dir / "latest.json").write_text(json.dumps({"step": step}))
    return path


def load_checkpoint(ckpt_dir: str | Path, model: torch.nn.Module) -> torch.nn.Module:
    """Load the checkpoint ``latest.json`` names into ``model``; returns it.
    Layers the model lacks are skipped (a mask net trained in a later
    stage); a mask net the checkpoint lacks keeps its weights."""
    ckpt_dir = Path(ckpt_dir)
    meta = json.loads((ckpt_dir / "latest.json").read_text())
    state = torch.load(ckpt_dir / f"step_{meta['step']}.pt", map_location="cpu", weights_only=True)
    own = model.state_dict()
    missing, _ = model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)
    if not any(k.startswith("mask_net.") for k in state):
        missing = [k for k in missing if not k.startswith("mask_net.")]
    if missing:
        raise ValueError(f"checkpoint {ckpt_dir} lacks {missing[:5]}")
    return model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {}
    it = iter(argv)
    int_keys = {"batch_size", "iterations", "max_nodes", "eval_every", "seed", "step_lr"}
    str_keys = {"checkpoint_dir", "stage", "data_root", "labels_filename", "val_labels_filename", "device"}
    for arg in it:
        if arg == "--data":
            kwargs["data_root"] = next(it)
        elif arg == "--labeled":
            kwargs["labeled"] = True
        elif arg == "--stage":
            kwargs["stage"] = next(it)
        elif arg == "--device":
            kwargs["device"] = next(it)
        elif arg == "--size":
            h, w = next(it).split("x")
            kwargs["image_size"] = (int(h), int(w))
        elif "=" in arg:
            key, val = arg.split("=", 1)
            key = key.lstrip("-").replace("-", "_")
            if key in int_keys:
                kwargs[key] = int(val)
            elif key in str_keys:
                kwargs[key] = val
            elif key in ("use_adam", "use_lr_scheduler"):
                kwargs[key] = val.lower() in ("1", "true", "yes")
            else:
                kwargs[key] = float(val)
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    _, history = train(**kwargs)
    print(f"training done; final loss {history[-1]:.4f}")


if __name__ == "__main__":
    main()
