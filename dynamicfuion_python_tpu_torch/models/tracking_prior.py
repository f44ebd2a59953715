"""The neural tracking prior of the fusion pipeline (port of
``dynamicfuion_python_tpu/models/tracking_prior.py``).

The dense-depth fitter stays the primary tracker; the prior predicts
per-node transforms from dense flow and initializes the warp field with them
before ``fit_to_image``, which lets the fit survive inter-frame motion its
local linearization would stall on (in-plane sliding, for one). Flow comes
from an injected dense field (``flow_override``: precomputed flow, or a
test's oracle) or from the PWC-Net inside a DeformNet with loaded weights.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.models.deform_net import TrackingGuards, track_from_flow
from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig
from dynamicfuion_python_tpu_torch.ops.camera import unproject_depth_image
from dynamicfuion_python_tpu_torch.utils import trace


class PriorResult(NamedTuple):
    rotations: torch.Tensor  # [N, 3, 3]
    translations: torch.Tensor  # [N, 3]
    valid_solve: bool
    correspondence_mask: torch.Tensor  # bool[H, W]


class NeuralTrackingPrior:
    """Per-frame node-transform prediction from dense flow: given a source
    RGBD estimate, the target frame and pixel anchors versus the graph
    nodes, solve the tracker's Gauss-Newton system for node rotations and
    translations."""

    def __init__(self, gn_config: GnConfig = GnConfig(), guards: TrackingGuards = TrackingGuards(), deform_net=None):
        self.gn_config = gn_config
        self.guards = guards
        self.deform_net = deform_net

    def predict(
        self,
        source_rgbxyz: torch.Tensor,  # [H, W, 6]
        target_rgbxyz: torch.Tensor,  # [H, W, 6]
        graph_nodes: torch.Tensor,  # [N, 3]
        graph_edges: torch.Tensor,  # int[N, Ke]
        graph_edges_weights: torch.Tensor,  # [N, Ke]
        graph_clusters: torch.Tensor,  # int[N]
        pixel_anchors: torch.Tensor,  # int[H, W, 4]
        pixel_weights: torch.Tensor,  # [H, W, 4]
        intrinsics: torch.Tensor,  # [3, 3]
        flow_override=None,  # [H, W, 2]
        initial_rotations: torch.Tensor | None = None,  # [N, 3, 3]
        initial_translations: torch.Tensor | None = None,  # [N, 3]
    ) -> PriorResult:
        batch = lambda x: None if x is None else x[None]  # noqa: E731
        args = (
            source_rgbxyz[None], target_rgbxyz[None], graph_nodes[None], graph_edges[None],
            graph_edges_weights[None], graph_clusters[None], pixel_anchors[None], pixel_weights[None],
        )
        if flow_override is not None:
            flow = torch.as_tensor(flow_override, dtype=torch.float32, device=source_rgbxyz.device)
            with torch.no_grad():
                tracked = track_from_flow(
                    flow[None], *args, intrinsics.expand(1, 3, 3), gn_config=self.gn_config, guards=self.guards,
                    initial_rotations=batch(initial_rotations), initial_translations=batch(initial_translations),
                )
            rotations, translations = tracked["node_rotations"][0], tracked["node_translations"][0]
            valid, mask = tracked["valid_solve"][0], tracked["valid_correspondence_mask"][0]
        elif self.deform_net is not None:
            with torch.no_grad():
                out = self.deform_net(
                    *args, intrinsics, evaluate=True,
                    node_rotations_estimate=batch(initial_rotations),
                    node_translations_estimate=batch(initial_translations),
                )
            rotations, translations = out.node_rotations[0], out.node_translations[0]
            valid, mask = out.valid_solve[0], out.valid_correspondence_mask[0]
        else:
            raise ValueError("NeuralTrackingPrior needs either a flow_override or a DeformNet")
        return PriorResult(rotations, translations, bool(trace.host_read(valid, "prior.valid")), mask)


def _image_tensor(image, device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image if device is None else image.to(device)
    image = np.asarray(image)
    if image.dtype == np.uint16:  # few torch ops take uint16
        image = image.astype(np.int32)
    return trace.upload(image, device, "prior.image")


def rgbxyz_from_depth(depth, color, intrinsics, depth_scale: float, depth_max: float, device=None) -> torch.Tensor:
    """The [H, W, 6] rgbxyz stack of a depth image and optional uint8 color,
    on ``device`` (default: the depth's): rgb in [0, 1] (zeros without
    color), camera-space points (zeros where the depth is invalid)."""
    depth = _image_tensor(depth, device)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=depth.device)
    points, _ = unproject_depth_image(depth, intrinsics, depth_scale, depth_max)
    if color is None:
        rgb = torch.zeros_like(points)
    else:
        rgb = _image_tensor(color, depth.device).to(torch.float32) / 255.0
    return torch.cat([rgb, points], dim=-1)
