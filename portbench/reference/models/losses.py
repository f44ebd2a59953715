"""DeformNet training losses and evaluation metrics (port of
``dynamicfuion_python_tpu/models/losses.py``):

  total = lambda_flow  * RobustL1 (or L2) of flow2 and flow4 against the
                         downscaled ground truth
        + lambda_graph * masked mean squared node-translation error
        + lambda_warp  * masked mean squared error of the warped points
        + lambda_mask  * weighted BCE of the MaskNet weights against the
                         oracle masks of ``compute_baseline_mask_gt``

and the metrics EPE 2D (flow), EPE 3D ("Graph Error 3D" over node
translations, "EPE 3D" over the dense warped points) and the valid-solve
ratio. Everything runs on the device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from portbench.reference.ops.image_warp import grid_sample_normalized


class LossWeights(NamedTuple):
    lambda_flow: float = 5.0
    lambda_graph: float = 2.0
    lambda_warp: float = 2.0
    lambda_mask: float = 1000.0
    use_flow_loss: bool = True
    use_graph_loss: bool = True
    use_warp_loss: bool = True
    use_mask_loss: bool = False
    flow_loss_type: str = "RobustL1"  # or "L2"


def robust_l1(diff: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    return torch.sqrt(torch.sum(diff**2, dim=-1) + eps**2)


def downscale_gt_flow(flow_gt: torch.Tensor, flow_mask: torch.Tensor, height: int, width: int):
    """Ground-truth flow [B, H, W, 2] and mask -> the pyramid level's size:
    the flow resized bilinearly (a triangle filter widened by the reduction
    factor, half-pixel centers) and scaled by the size ratio, the mask by
    nearest neighbour (source index floor((i + 1/2) * in / out))."""
    _, h, w, _ = flow_gt.shape
    flow = F.interpolate(flow_gt.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True).permute(0, 2, 3, 1)
    flow = flow * torch.tensor([width / w, height / h], dtype=torch.float32, device=flow.device)
    mask = F.interpolate(flow_mask.to(torch.float32)[:, None], size=(height, width), mode="nearest-exact")[:, 0] > 0.5
    return flow, mask


def flow_loss(flows: tuple, flow_gt: torch.Tensor, flow_mask: torch.Tensor, weights: LossWeights) -> torch.Tensor:
    """Masked mean of the per-pixel flow error at flow2 and flow4 (1/4 and
    1/16 resolution), each level in its own pixels divided by 20."""
    total = torch.zeros((), dtype=torch.float32, device=flow_gt.device)
    for level_flow in (flows[0], flows[2]):
        _, h, w, _ = level_flow.shape
        gt, mask = downscale_gt_flow(flow_gt, flow_mask, h, w)
        diff = level_flow * 20.0 - gt
        per_px = robust_l1(diff) if weights.flow_loss_type == "RobustL1" else torch.sum(diff**2, dim=-1)
        total = total + torch.sum(torch.where(mask, per_px, 0.0)) / torch.clamp(torch.sum(mask), min=1.0)
    return total


def graph_loss(node_translations, node_translations_gt, deformations_validity) -> torch.Tensor:
    """Masked mean squared error over the node translations."""
    mask = deformations_validity > 0
    diff2 = torch.sum((node_translations - node_translations_gt) ** 2, dim=-1)
    return torch.sum(torch.where(mask, diff2, 0.0)) / torch.clamp(torch.sum(mask), min=1.0)


def warp_loss(deformed_points, deformed_points_gt, deformed_points_mask) -> torch.Tensor:
    diff2 = torch.sum((deformed_points - deformed_points_gt) ** 2, dim=-1)
    mask = deformed_points_mask > 0
    return torch.sum(torch.where(mask, diff2, 0.0)) / torch.clamp(torch.sum(deformed_points_mask), min=1.0)


def mask_bce_loss(mask_prediction, mask_gt, valid, neg_wrt_pos_weight: float | None = 0.05) -> torch.Tensor:
    """BCE per valid pixel; positives weighted by ``neg_wrt_pos_weight`` (or,
    when None, by the negatives-to-positives count ratio), negatives by 1."""
    p = torch.clamp(mask_prediction[..., 0], 1e-6, 1 - 1e-6)
    valid_f = valid.to(torch.float32)
    bce = -(mask_gt * torch.log(p) + (1 - mask_gt) * torch.log(1 - p)) * valid_f
    positives = valid_f * mask_gt
    negatives = valid_f * (1.0 - mask_gt)
    if neg_wrt_pos_weight is None:
        ratio = torch.sum(negatives) / torch.clamp(torch.sum(positives), min=1.0)
        pixel_weights = ratio * positives + negatives
    else:
        pixel_weights = neg_wrt_pos_weight * positives + negatives
    return torch.sum(pixel_weights * bce) / torch.clamp(torch.sum(valid_f), min=1.0)


def compute_baseline_mask_gt(
    flow: torch.Tensor,  # [B, H, W, 2] predicted dense pixel flow
    source_points: torch.Tensor,  # [B, H, W, 3]
    target_points: torch.Tensor,  # [B, H, W, 3]
    scene_flow_gt: torch.Tensor,  # [B, H, W, 3]
    scene_flow_mask: torch.Tensor,  # bool[B, H, W]
    target_boundary_mask: torch.Tensor,  # bool[B, H, W]
    depth_max: float = 6.0,
    max_pos_flowed_source_to_target_dist: float = 0.1,
    min_neg_flowed_source_to_target_dist: float = 0.3,
):
    """Oracle correspondence masks: a match is positive when the
    flow-sampled target point lies within ``max_pos`` of the source point
    moved by the ground-truth scene flow (valid source and target, target
    off the boundary), negative beyond ``min_neg`` or on the boundary, and
    left out otherwise. Returns (mask_gt f32[B, H, W], valid bool[B, H, W])."""
    _, h, w = scene_flow_mask.shape
    dev = flow.device
    vg = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    ug = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    nx = 2.0 * (ug[None] + flow[..., 0]) / (w - 1) - 1.0
    ny = 2.0 * (vg[None] + flow[..., 1]) / (h - 1) - 1.0
    coords = torch.stack([nx, ny], dim=-1)

    def sample(images):
        return torch.stack([grid_sample_normalized(img, c) for img, c in zip(images, coords)])

    target_matches = sample(target_points)
    valid_source = (source_points[..., 2] > 0) & (source_points[..., 2] <= depth_max)
    valid_target = (target_matches[..., 2] > 0) & (target_matches[..., 2] <= depth_max)
    # a bilinear tap of the non-boundary image must be >= 0.999: no tap on a
    # boundary pixel
    matches_nonboundary = sample((~target_boundary_mask).to(torch.float32)[..., None])[..., 0] >= 0.999
    dist = torch.linalg.norm(source_points + scene_flow_gt - target_matches, dim=-1)
    base = scene_flow_mask & valid_source & valid_target
    mask_pos = (dist <= max_pos_flowed_source_to_target_dist) & base & matches_nonboundary
    mask_neg = ((dist > min_neg_flowed_source_to_target_dist) & base) | (~matches_nonboundary & base)
    return mask_pos.to(torch.float32), mask_pos | mask_neg


def total_loss(
    output,
    flow_gt,
    flow_mask,
    node_translations_gt,
    deformed_points_gt,
    deformed_points_mask,
    mask_gt=None,
    mask_valid=None,
    weights: LossWeights = LossWeights(),
):
    """(total, {term: value, ..., "total": total}) over the enabled terms."""
    losses = {}
    total = torch.zeros((), dtype=torch.float32, device=flow_gt.device)
    if weights.use_flow_loss:
        losses["flow"] = flow_loss(output.flows, flow_gt, flow_mask, weights)
        total = total + weights.lambda_flow * losses["flow"]
    if weights.use_graph_loss:
        losses["graph"] = graph_loss(output.node_translations, node_translations_gt, output.deformations_validity)
        total = total + weights.lambda_graph * losses["graph"]
    if weights.use_warp_loss:
        losses["warp"] = warp_loss(output.deformed_points, deformed_points_gt, deformed_points_mask)
        total = total + weights.lambda_warp * losses["warp"]
    if weights.use_mask_loss and mask_gt is not None and output.mask_prediction is not None:
        losses["mask"] = mask_bce_loss(output.mask_prediction, mask_gt, flow_mask if mask_valid is None else mask_valid)
        total = total + weights.lambda_mask * losses["mask"]
    losses["total"] = total
    return total, losses
