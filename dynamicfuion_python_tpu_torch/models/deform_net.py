"""DeformNet, the neural non-rigid tracker (port of
``dynamicfuion_python_tpu/models/deform_net.py``): PWC-Net dense flow ->
flow-warped correspondence targets (sampled target points and validity) ->
optional MaskNet correspondence weights -> per-batch Gauss-Newton over the
graph's node transforms -> dense warp of the source points.

As in the JAX package, every per-batch filter is a mask with static shapes:
invalid and subsampled-away matches carry zero weight, nodes of clusters with
too few matches are masked after the solve (``deformations_validity``). The
networks' convolutions run with TF32 off (cuDNN's default is on), so the card
computes them in FP32 as the CPU does.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig, optimize_point_cloud_alignment
from dynamicfuion_python_tpu_torch.models.mask_net import MaskNet
from dynamicfuion_python_tpu_torch.models.pwcnet import PWCNet, upsample_flow_to_full
from dynamicfuion_python_tpu_torch.ops.image_warp import grid_sample_normalized
from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum
from dynamicfuion_python_tpu_torch.ops.warp import blend_warp


class DeformNetOutput(NamedTuple):
    flows: tuple  # (flow2..flow6) NHWC
    node_rotations: torch.Tensor  # [B, N, 3, 3]
    node_translations: torch.Tensor  # [B, N, 3]
    deformations_validity: torch.Tensor  # [B, N]
    deformed_points: torch.Tensor  # [B, M, 3]
    valid_solve: torch.Tensor  # uint8[B]
    mask_prediction: torch.Tensor | None  # [B, H, W, 1]
    correspondence_weights: torch.Tensor  # [B, H, W]
    target_matches: torch.Tensor  # [B, H, W, 3]
    valid_correspondence_mask: torch.Tensor  # [B, H, W]
    gn_losses: torch.Tensor  # [B, iterations]
    features2: torch.Tensor  # [B, H/4, W/4, 565] NHWC


class TrackingGuards(NamedTuple):
    """Failure guards and filters shared by DeformNet and the pipeline's
    tracking prior (the reference's deform-net settings)."""

    depth_max: float = 6.0
    gn_min_nodes: int = 4
    gn_max_nodes: int = 300
    remove_clusters_with_few_matches: bool = True
    min_num_correspondences_per_cluster: float = 2000.0


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions without TF32 (``cudnn.flags(allow_tf32=False)``,
    the other cuDNN flags left as they are)."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


def _normalized_coords(flow: torch.Tensor):
    """Flow-warped pixel coordinates (u, v) [B, H, W] and their normalized
    form [B, H, W, 2], with the reference's convention: divide by (dim - 1),
    times 2, minus 1 (sampled with align_corners=False semantics)."""
    h, w = flow.shape[1:3]
    vg = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None].expand(h, w)
    ug = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :].expand(h, w)
    warped_u = ug[None] + flow[..., 0]
    warped_v = vg[None] + flow[..., 1]
    coords = torch.stack([2.0 * warped_u / (w - 1) - 1.0, 2.0 * warped_v / (h - 1) - 1.0], dim=-1)
    return warped_u, warped_v, coords


def _sample_batch(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    return torch.stack([grid_sample_normalized(img, c) for img, c in zip(images, coords)])


def track_from_flow(
    flow: torch.Tensor,  # [B, H, W, 2] dense pixel flow source -> target
    source: torch.Tensor,  # [B, H, W, 6] rgbxyz
    target: torch.Tensor,  # [B, H, W, 6]
    graph_nodes: torch.Tensor,  # [B, N, 3]
    graph_edges: torch.Tensor,  # int[B, N, Ke]
    graph_edges_weights: torch.Tensor,  # [B, N, Ke]
    graph_clusters: torch.Tensor,  # int[B, N]
    pixel_anchors: torch.Tensor,  # int[B, H, W, 4]
    pixel_weights: torch.Tensor,  # [B, H, W, 4]
    intrinsics: torch.Tensor,  # [B, 3, 3]
    gn_config: GnConfig,
    guards: TrackingGuards = TrackingGuards(),
    mask_weights: torch.Tensor | None = None,  # [B, H, W] correspondence weights
    flow_back: torch.Tensor | None = None,  # [B, H, W, 2] target -> source
    bidirectional_consistency_threshold: float = 0.20,
    initial_rotations: torch.Tensor | None = None,  # [B, N, 3, 3]
    initial_translations: torch.Tensor | None = None,  # [B, N, 3]
    num_nodes: int = 0,
    max_matches: int = 0,
    match_subsample_uniforms: torch.Tensor | None = None,  # [B, H, W] U(0, 1)
) -> dict:
    """Everything of the tracker downstream of the networks: flow ->
    sampled correspondences and validity -> optional bidirectional
    consistency and match subsampling -> per-batch GN solve -> cluster
    validity and the solve guards -> dense warp of the source points."""
    b, h, w, _ = source.shape
    dev = source.device
    source_points = source[..., 3:]
    target_points = target[..., 3:]
    depth_max = guards.depth_max
    warped_u, warped_v, coords = _normalized_coords(flow)
    target_matches = _sample_batch(target_points, coords)

    # validity: source depth in (0, max] with all 4 anchors; target match
    # depth in (0, max], and the target's validity image, sampled at the same
    # coordinates, >= 0.999 (no tap on an invalid or outside pixel)
    anchors_valid = torch.all(pixel_anchors >= 0, dim=-1)
    valid_source = (source_points[..., 2] > 0) & (source_points[..., 2] <= depth_max) & anchors_valid
    validity_image = ((target_points[..., 2] > 0) & (target_points[..., 2] <= depth_max)).to(torch.float32)[..., None]
    sampled_validity = _sample_batch(validity_image, coords)[..., 0]
    valid_target = (
        (target_matches[..., 2] > 0) & (target_matches[..., 2] <= depth_max) & (sampled_validity >= 0.999)
    )
    correspondence_mask = valid_source & valid_target
    correspondence_weights = correspondence_mask.to(torch.float32)
    if mask_weights is not None:
        correspondence_weights = correspondence_weights * mask_weights

    # bidirectional consistency: the round-trip flow in camera units (via
    # the source depth) must stay below the threshold
    if flow_back is not None:
        f_xy = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1]], dim=-1)  # [B, 2]
        flow_camera = (flow + flow_back) * source_points[..., 2:3] / f_xy[:, None, None, :]
        bidir_ok = torch.linalg.norm(flow_camera, dim=-1) < bidirectional_consistency_threshold
        correspondence_mask = correspondence_mask & bidir_ok
        correspondence_weights = torch.where(bidir_ok, correspondence_weights, 0.0)

    # subsampling to the match budget: each valid match is kept with
    # probability max_matches / count, from the caller's uniforms
    if max_matches > 0 and match_subsample_uniforms is not None:
        count = torch.sum(correspondence_mask, dim=(1, 2), keepdim=True).to(torch.float32)
        keep = match_subsample_uniforms < torch.clamp(max_matches / torch.clamp(count, min=1.0), max=1.0)
        correspondence_mask = correspondence_mask & keep
        correspondence_weights = torch.where(keep, correspondence_weights, 0.0)

    # ---- per-batch GN solve over all H * W matches
    n_static = num_nodes or graph_nodes.shape[1]
    if initial_rotations is None:
        initial_rotations = torch.eye(3, dtype=torch.float32, device=dev).expand(b, n_static, 3, 3)
    if initial_translations is None:
        initial_translations = torch.zeros((b, n_static, 3), dtype=torch.float32, device=dev)
    cw_solver = correspondence_weights * correspondence_mask
    uv_targets = torch.stack([warped_u, warped_v], dim=-1)
    solves = [
        optimize_point_cloud_alignment(
            graph_nodes[i], graph_edges[i], graph_edges_weights[i], source_points[i].reshape(-1, 3),
            pixel_anchors[i].reshape(-1, 4), pixel_weights[i].reshape(-1, 4), cw_solver[i].reshape(-1),
            uv_targets[i].reshape(-1, 2), target_matches[i, ..., 2].reshape(-1), intrinsics[i],
            num_nodes=n_static, config=gn_config,
            initial_rotations=initial_rotations[i], initial_translations=initial_translations[i],
        )
        for i in range(b)
    ]
    rot = torch.stack([s.rotations for s in solves])
    trans = torch.stack([s.translations for s in solves])
    gn_losses = torch.stack([s.losses for s in solves])
    gn_valid = torch.stack([s.valid_solve for s in solves])

    # ---- cluster validity: a node's match weight is the sum of its pixel
    # anchor weights over valid correspondences
    n = graph_nodes.shape[1]
    per_node_weight = []
    for i in range(b):
        anchors = pixel_anchors[i].reshape(-1)
        flat_w = (
            pixel_weights[i].reshape(-1) * (anchors >= 0)
            * correspondence_mask[i].reshape(-1).to(torch.float32).repeat_interleave(4)
        )
        per_node_weight.append(segment_sum(flat_w, anchors.clamp(min=0).long(), n))
    per_node_weight = torch.stack(per_node_weight)  # [B, N]
    if guards.remove_clusters_with_few_matches:
        cluster_weight = []
        for i in range(b):
            clusters = graph_clusters[i]
            safe = clusters.clamp(min=0).long()
            csum = segment_sum(per_node_weight[i], safe, n)
            cluster_weight.append(torch.where(clusters >= 0, csum[safe], 0.0))
        deformations_validity = (per_node_weight > 0.0) & (
            torch.stack(cluster_weight) >= guards.min_num_correspondences_per_cluster
        )
    else:
        deformations_validity = per_node_weight > 0.0

    # node-count guard, the GN guards and at least one valid correspondence
    real_node_count = torch.sum(graph_clusters >= 0, dim=-1)
    node_count_ok = (real_node_count >= guards.gn_min_nodes) & (real_node_count <= guards.gn_max_nodes)
    valid_solve = (
        gn_valid & node_count_ok & torch.any(correspondence_mask.reshape(b, -1), dim=1)
        & torch.any(deformations_validity, dim=-1)
    ).to(torch.uint8)
    deformations_validity = deformations_validity & (valid_solve[:, None] > 0)
    # invalid solves keep the given estimates
    rot = torch.where(valid_solve[:, None, None, None] > 0, rot, initial_rotations)
    trans = torch.where(valid_solve[:, None, None] > 0, trans, initial_translations)

    deformed_points = torch.stack([
        blend_warp(source_points[i].reshape(-1, 3), graph_nodes[i], rot[i], trans[i],
                   pixel_anchors[i].reshape(-1, 4), pixel_weights[i].reshape(-1, 4))
        for i in range(b)
    ])
    return {
        "node_rotations": rot,
        "node_translations": trans,
        "deformations_validity": deformations_validity.to(torch.float32),
        "deformed_points": deformed_points,
        "valid_solve": valid_solve,
        "correspondence_weights": correspondence_weights,
        "target_matches": target_matches,
        "valid_correspondence_mask": correspondence_mask,
        "gn_losses": gn_losses,
    }


def patchwise_threshold(mask_weights: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Keep only each ``patch_size`` square's maximum weight, zeroing the
    rest (max-pool, nearest upsample, ``|x - pooled| <= 1e-8``).
    ``mask_weights`` f32[B, H, W]; remainder rows / columns are zeroed."""
    ps = patch_size
    _, mh, mw = mask_weights.shape
    hp, wp = mh // ps * ps, mw // ps * ps
    pooled = F.max_pool2d(mask_weights[:, None, :hp, :wp], ps)[:, 0]
    up = pooled.repeat_interleave(ps, dim=1).repeat_interleave(ps, dim=2)
    up = F.pad(up, (0, mw - wp, 0, mh - hp), value=torch.inf)
    return torch.where(torch.abs(mask_weights - up) <= 1e-8, mask_weights, 0.0)


class DeformNet(nn.Module):
    """PWC-Net (``flow_net``) + MaskNet (``mask_net``) + the GN solver, with
    the JAX module's settings."""

    def __init__(
        self,
        use_mask: bool = True,
        gn_config: GnConfig = GnConfig(),
        num_nodes: int = 0,
        depth_max: float = 6.0,
        mask_threshold: float = 0.35,
        threshold_mask_predictions: bool = False,
        patchwise_threshold_mask_predictions: bool = False,
        patch_size: int = 16,
        enforce_bidirectional_consistency: bool = False,
        bidirectional_consistency_threshold: float = 0.20,
        gn_min_nodes: int = 4,
        gn_max_nodes: int = 300,
        remove_clusters_with_few_matches: bool = True,
        min_num_correspondences_per_cluster: float = 2000.0,
        gn_max_matches: int = 0,
    ):
        super().__init__()
        self.use_mask = use_mask
        self.gn_config = gn_config
        self.num_nodes = num_nodes
        self.mask_threshold = mask_threshold
        self.threshold_mask_predictions = threshold_mask_predictions
        self.patchwise_threshold_mask_predictions = patchwise_threshold_mask_predictions
        self.patch_size = patch_size
        self.enforce_bidirectional_consistency = enforce_bidirectional_consistency
        self.bidirectional_consistency_threshold = bidirectional_consistency_threshold
        self.gn_max_matches = gn_max_matches
        self.guards = TrackingGuards(
            depth_max, gn_min_nodes, gn_max_nodes, remove_clusters_with_few_matches,
            min_num_correspondences_per_cluster,
        )
        self.flow_net = PWCNet()
        if use_mask:
            self.mask_net = MaskNet()

    def forward(
        self,
        source: torch.Tensor,  # [B, H, W, 6] rgbxyz
        target: torch.Tensor,  # [B, H, W, 6]
        graph_nodes: torch.Tensor,  # [B, N, 3]
        graph_edges: torch.Tensor,  # int[B, N, Ke]
        graph_edges_weights: torch.Tensor,  # [B, N, Ke]
        graph_clusters: torch.Tensor,  # int[B, N]
        pixel_anchors: torch.Tensor,  # int[B, H, W, 4]
        pixel_weights: torch.Tensor,  # [B, H, W, 4]
        intrinsics: torch.Tensor,  # [B, 3, 3] or [3, 3]
        evaluate: bool = False,
        node_rotations_estimate: torch.Tensor | None = None,
        node_translations_estimate: torch.Tensor | None = None,
        match_subsample_uniforms: torch.Tensor | None = None,
    ) -> DeformNetOutput:
        b, h, w, _ = source.shape
        if h % 64 or w % 64:
            raise ValueError(
                f"DeformNet needs image sides divisible by 64 (6-level pyramid with exact x2 "
                f"upsampling); got {h}x{w} (the reference resizes to 448x640)"
            )
        if intrinsics.dim() == 2:
            intrinsics = intrinsics.expand(b, 3, 3)
        source_color, target_color = source[..., :3], target[..., :3]
        with fp32_convolutions():
            flow2, flow3, flow4, flow5, flow6, features2 = self.flow_net(source_color, target_color)
            flow = upsample_flow_to_full(flow2, (h, w))
            mask_prediction = mask_weights = None
            if self.use_mask:
                _, _, coords = _normalized_coords(flow)
                mask_input = torch.cat(
                    [source, _sample_batch(target_color, coords), _sample_batch(target[..., 3:], coords)], dim=-1
                )
                mask_prediction = self.mask_net(features2, mask_input)
                mask_weights = mask_prediction[..., 0]
                if evaluate and self.threshold_mask_predictions:
                    mask_weights = torch.where(mask_weights >= self.mask_threshold, mask_weights, 0.0)
                elif evaluate and self.patchwise_threshold_mask_predictions:
                    mask_weights = patchwise_threshold(mask_weights, self.patch_size)
            flow_back = None
            if self.enforce_bidirectional_consistency:
                flow_back = upsample_flow_to_full(self.flow_net(target_color, source_color)[0], (h, w))

        tracked = track_from_flow(
            flow, source, target, graph_nodes, graph_edges, graph_edges_weights, graph_clusters,
            pixel_anchors, pixel_weights, intrinsics,
            gn_config=self.gn_config, guards=self.guards, mask_weights=mask_weights, flow_back=flow_back,
            bidirectional_consistency_threshold=self.bidirectional_consistency_threshold,
            initial_rotations=node_rotations_estimate, initial_translations=node_translations_estimate,
            num_nodes=self.num_nodes or graph_nodes.shape[1], max_matches=self.gn_max_matches,
            match_subsample_uniforms=match_subsample_uniforms,
        )
        return DeformNetOutput(
            flows=(flow2, flow3, flow4, flow5, flow6),
            node_rotations=tracked["node_rotations"],
            node_translations=tracked["node_translations"],
            deformations_validity=tracked["deformations_validity"],
            deformed_points=tracked["deformed_points"],
            valid_solve=tracked["valid_solve"],
            mask_prediction=mask_prediction,
            correspondence_weights=tracked["correspondence_weights"],
            target_matches=tracked["target_matches"],
            valid_correspondence_mask=tracked["valid_correspondence_mask"],
            gn_losses=tracked["gn_losses"],
            features2=features2,
        )


def seeded_state_dict(net: nn.Module, generator: torch.Generator) -> dict:
    """A ``state_dict`` for ``net`` drawn from ``generator`` with PyTorch's
    default initialization bounds: every weight and bias uniform in
    +-1 / sqrt(fan_in), fan_in = the weight's dim 1 times its kernel size
    (what ``nn.Conv2d`` / ``nn.ConvTranspose2d`` draw from the global RNG)."""
    state = {}
    for name, module in net.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        wt = module.weight
        fan_in = wt.shape[1] * wt[0, 0].numel()
        bound = 1.0 / fan_in**0.5
        for pname, p in (("weight", wt), ("bias", module.bias)):
            state[f"{name}.{pname}"] = (torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound
    return state
