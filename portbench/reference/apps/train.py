"""DeformNet's training step, the 4-stage curriculum (a copy of the plain
paths of the port's ``apps/train.py``).

``0_flow`` (flow loss only, solver skipped) -> ``1_solver`` (+ graph and warp
losses through the differentiable GN solve) -> ``2_mask`` (+ MaskNet and the
weighted BCE against ``compute_baseline_mask_gt``'s oracle masks, flow net
frozen) -> ``3_refine`` (everything trains).

One training step (forward with the GN solve, the loss, backward, the
optimizer) runs with the precision the caller sets, and with cuDNN's
deterministic algorithms; the node gathers' and the flow upsampling's
backwards sum in a fixed order (``ops/warp.py::gather_rows``,
``models/pwcnet.py::bilinear_resize``). The benchmark's copy leaves out the
port's training loop, evaluation, checkpoints and command line.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.models.deform_net import DeformNet
from portbench.reference.models.gn_point_cloud_optimizer import GnConfig
from portbench.reference.models.losses import (
    LossWeights,
    compute_baseline_mask_gt,
    total_loss,
)
from portbench.reference.models.pwcnet import upsample_flow_to_full


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
    ``fp32_convolutions`` block has closed), and cuDNN restricted to
    deterministic algorithms: left free, cuDNN may pick backward-data and
    backward-filter algorithms that add with float atomics, so a step's
    gradients would differ from run to run on the card. The previous flags
    are restored."""
    cudnn = torch.backends.cudnn
    # TF32 is the caller's: off for the reference, on for its control
    previous = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = previous


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
