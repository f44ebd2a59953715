"""DynamicFusion pipeline: dense non-rigid RGB-D fusion over a sequence
(port of ``dynamicfuion_python_tpu/apps/fusion_pipeline.py``).

  frame 0:  discover + activate blocks -> rigid TSDF integrate -> build the
            deformation graph (on the extracted canonical mesh, on the depth
            image's mesh, or from precomputed blobs, whose coverage region
            crops the frame first)
  frame t:  rigid odometry against the previous frame (camera pose) ->
            unproject depth into the canonical camera -> fit the warp field
            by Gauss-Newton/LM mesh-to-image alignment -> find blocks
            intersecting the warped truncation region -> sleeve activation ->
            non-rigid integrate through the field and the pose -> re-extract
            the canonical mesh

With the neural tracking prior (``fusion.use_neural_prior`` with a DeformNet
checkpoint, or a ``prior_flow`` given to ``process_frame``), each frame first
predicts the node transforms from the tracking source (the keyframe) to the
current frame and starts the fit from them; the keyframe rolls per
``fusion.tracking_span_mode``.

As in the JAX package, the first frame after ``initialize`` runs no
odometry: ``initialize`` leaves ``previous_depth`` unset.

The prior's source image is the keyframe's (``fusion.source_image_mode``
``IMAGE_ONLY``); its checkpoint is a ``.pt`` / ``.pth`` state dict.

The benchmark's copy keeps the single-device frame loop only: the port's
process-group (SPMD) branches, rendered prior sources, telemetry, whole-run
driver and command line are left out.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.models.deform_net import DeformNet, TrackingGuards
from portbench.reference.models.fitter import FitterConfig, IterationMode, fit_to_image
from portbench.reference.models.gn_point_cloud_optimizer import GnConfig
from portbench.reference.models.tracking_prior import NeuralTrackingPrior, rgbxyz_from_depth
from portbench.reference.models.voxel_block_grid import (
    VoxelBlockGrid,
    extract_mesh_fitter_arrays,
)
from portbench.reference.models.warp_field import (
    HierarchicalGraphWarpField,
    NodeCoverageMethod,
)
from portbench.reference.ops import rigid_odometry
from portbench.reference.ops.anchors import compute_anchors_euclidean
from portbench.reference.ops.camera import transform_points, unproject_depth_image
from portbench.reference.ops.compaction import compact_mask_indices
from portbench.reference.ops.graph_construction import (
    compute_edges_euclidean,
    compute_pixel_anchors_shortest_path,
    mesh_from_depth_image,
    sample_nodes,
    vertex_erosion_mask,
)
from portbench.reference.ops.normals import point_image_normals
from portbench.reference.settings import (
    AnchorComputationMode,
    GraphGenerationMode,
    MeshExtractionWeightThresholdingMode,
    Parameters,
    SourceImageMode,
    TrackingSpanMode,
)
from portbench.reference.utils.device import resolve_device


class FusionPipeline:
    """Orchestrates the per-frame fusion loop on one device (the CUDA card
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, params: Parameters, intrinsics: np.ndarray, device=None):
        a = params.alignment
        f = params.fusion
        self.device = resolve_device(device)
        self.params = params
        self.intrinsics = torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32, device=self.device)
        t = params.tsdf
        self.volume = VoxelBlockGrid.create(
            capacity=t.initial_block_count,
            voxel_size=t.voxel_size,
            block_resolution=t.block_resolution,
            sdf_truncation_distance=t.sdf_truncation_distance,
            depth_scale=f.depth_scale,
            depth_max=f.far_clip_distance,
            device=self.device,
        )
        self.warp_field: HierarchicalGraphWarpField | None = None
        self.canonical_vertices: torch.Tensor | None = None
        self.canonical_triangles: torch.Tensor | None = None
        self.canonical_triangle_count = 0
        # sticky grow-only power-of-two capacities of the fitter's mesh
        # arrays; growth follows the previous frame's counts, as in the JAX
        # package (which fetched them asynchronously)
        self._mesh_t_cap = _capacity_bucket(max(f.mesh_capacity_hint, 4096))
        self._mesh_v_cap = 4096
        self._pending_counts: tuple | None = None
        self._count_host: tuple[int, int] = (0, 0)
        # cumulative camera pose: canonical (frame-0) camera space -> current
        # camera space, updated by rigid odometry each frame
        self.extrinsics = torch.eye(4, dtype=torch.float32, device=self.device)
        self.previous_depth: torch.Tensor | None = None
        self.frames_processed = 0
        # the neural prior's tracking source: the keyframe's depth and color
        # and the cumulative node transforms at that keyframe, plus its pixel
        # anchors (cached until the keyframe rolls) and the node graph's
        # Euclidean edges (built once)
        self.prior: NeuralTrackingPrior | None = None
        self.keyframe_source: tuple | None = None
        self.keyframe_rotations: torch.Tensor | None = None
        self.keyframe_translations: torch.Tensor | None = None
        self.keyframe_anchors: tuple | None = None
        self.node_graph_edges: np.ndarray | None = None
        self.fitter_config = FitterConfig(
            max_iterations=a.max_iteration_count,
            min_update_threshold=a.min_update_threshold,
            iteration_modes=_parse_iteration_modes(a.iteration_modes),
            arap_term_weight=a.arap_term_weight,
            use_tukey_penalty=a.use_tukey_penalty,
            tukey_cutoff=a.tukey_penalty_cutoff,
            use_huber_penalty=a.use_huber_penalty,
            huber_constant=a.huber_penalty_constant,
            levenberg_marquardt_factor=a.levenberg_marquardt_factor,
            max_depth=a.max_depth,
            use_regularization=a.use_regularization,
            lump_data_hessian=a.lump_data_hessian,
            valid_solve_rotation_limit=a.valid_solve_rotation_limit,
            valid_solve_translation_limit=a.valid_solve_translation_limit,
            valid_solve_residual_tolerance=a.valid_solve_residual_tolerance,
            valid_solve_escalated_residual_tolerance=a.valid_solve_escalated_residual_tolerance,
            data_term_impl=a.data_term_impl,
            pixel_compaction_fraction=a.pixel_compaction_fraction,
            coarse_iterations=a.coarse_iteration_count,
            coarse_factor=a.coarse_factor,
        )

    def _frame(self, image: np.ndarray) -> torch.Tensor:
        image = np.asarray(image)
        if image.dtype == np.uint16:  # few torch ops take uint16
            image = image.astype(np.int32)
        return torch.as_tensor(image, device=self.device)

    # -- first frame ---------------------------------------------------------

    def initialize(self, depth: np.ndarray, color: np.ndarray | None, frame_graph: dict | None = None):
        """Rigid-integrate the first frame and build the deformation graph
        per ``fusion.graph_generation_mode``. ``frame_graph`` holds the
        precomputed blobs of ``FIRST_FRAME_LOADED_GRAPH`` (normally from
        ``FrameSequenceDataset.get_frame_graph``)."""
        p = self.params
        g = p.graph
        mode = p.fusion.graph_generation_mode
        frame_depth = depth_t = self._frame(depth)
        if (
            mode == GraphGenerationMode.FIRST_FRAME_LOADED_GRAPH
            and frame_graph is not None
            and p.fusion.crop_to_graph_coverage
        ):
            depth_t = crop_depth_to_coverage(
                depth_t,
                torch.as_tensor(np.asarray(frame_graph["nodes"]), dtype=torch.float32, device=self.device),
                self.intrinsics,
                p.fusion.depth_scale,
                p.fusion.far_clip_distance,
                2.0 * g.node_coverage,
            )
        keys = self.volume.compute_unique_block_coordinates(depth_t, self.intrinsics, stride=2)
        self.volume = self.volume.activate(keys)
        color_t = self._frame(color).to(torch.float32) / 255.0 if color is not None else None
        self.volume = self.volume.integrate(depth_t, self.intrinsics, color=color_t)
        self._refresh_canonical_mesh(sync=True)

        if mode == GraphGenerationMode.FIRST_FRAME_EXTRACTED_MESH:
            faces = self.canonical_triangles[: self.canonical_triangle_count].cpu().numpy()
            verts = self.canonical_vertices.cpu().numpy()
            erosion = vertex_erosion_mask(verts, faces, g.erosion_num_iterations, g.erosion_min_neighbors)
            nodes, _ = sample_nodes(verts, erosion, g.node_coverage, use_only_non_eroded=True)
            if len(nodes) < g.anchor_count:
                used = np.zeros(len(verts), bool)
                used[faces.reshape(-1)] = True
                nodes, _ = sample_nodes(verts, used, g.node_coverage, use_only_non_eroded=True)
        elif mode == GraphGenerationMode.FIRST_FRAME_LOADED_GRAPH:
            if frame_graph is None:
                raise ValueError(
                    "graph_generation_mode=FIRST_FRAME_LOADED_GRAPH but no precomputed graph was "
                    "found for the first frame"
                )
            nodes = np.asarray(frame_graph["nodes"], np.float32)
        elif mode == GraphGenerationMode.FIRST_FRAME_DEPTH_IMAGE:
            points, _ = unproject_depth_image(
                depth_t, self.intrinsics, p.fusion.depth_scale, p.fusion.far_clip_distance
            )
            verts, _, faces = mesh_from_depth_image(
                points.cpu().numpy(), max_triangle_edge_distance=2 * g.node_coverage
            )
            erosion = vertex_erosion_mask(verts, faces, g.erosion_num_iterations, g.erosion_min_neighbors)
            nodes, _ = sample_nodes(verts, erosion, g.node_coverage, use_only_non_eroded=True)
            if len(nodes) < g.anchor_count:
                # tiny scene: sample without erosion
                nodes, _ = sample_nodes(verts, None, g.node_coverage, use_only_non_eroded=False)
        else:
            raise NotImplementedError(f"graph generation mode {mode}")
        self.warp_field = HierarchicalGraphWarpField.build(
            nodes,
            node_coverage=g.node_coverage,
            layer_count=min(g.layer_count, _max_feasible_layers(len(nodes))),
            max_vertex_degree=g.max_vertex_degree,
            anchor_count=g.anchor_count,
            minimum_valid_anchor_count=g.minimum_valid_anchor_count,
            threshold_nodes_by_distance=g.minimum_valid_anchor_count > 0,
            coverage_method=NodeCoverageMethod.FIXED,
            device=self.device,
        )
        self._reset_keyframe(frame_depth, color)

    def _extraction_weight_threshold(self) -> float:
        """Constant, or ramping up with the frame count so early
        low-confidence voxels still produce a surface."""
        f = self.params.fusion
        if f.mesh_extraction_weight_thresholding_mode == MeshExtractionWeightThresholdingMode.CONSTANT:
            return f.mesh_extraction_weight_threshold
        return min(float(self.frames_processed), f.mesh_extraction_weight_threshold)

    def _refresh_canonical_mesh(self, sync: bool = False):
        """Extract the welded canonical mesh at the configured maximum
        capacity, then slice it to the fitter's sticky buckets. Bucket growth
        follows the previous frame's counts unless ``sync``."""
        t_max = _capacity_bucket(self.params.fusion.extraction_max_triangles)
        v_max = _capacity_bucket(t_max * 3 // 2 + 2)
        verts, faces, v_count, t_count = extract_mesh_fitter_arrays(
            self.volume, v_max, t_max, self._extraction_weight_threshold()
        )
        counts = (int(v_count), int(t_count))
        if sync:
            self._count_host = counts
            self._pending_counts = None
        else:
            if self._pending_counts is not None:
                self._count_host = self._pending_counts
            self._pending_counts = counts
        vc, tc = self._count_host
        while tc >= self._mesh_t_cap and self._mesh_t_cap < t_max:
            self._mesh_t_cap *= 2
        while vc + 1 >= self._mesh_v_cap and self._mesh_v_cap < v_max:
            self._mesh_v_cap *= 2
        self._mesh_t_cap = min(self._mesh_t_cap, t_max)
        self._mesh_v_cap = min(self._mesh_v_cap, v_max)
        self.canonical_vertices, self.canonical_triangles = _slice_mesh_arrays(
            verts, faces, self._mesh_v_cap, self._mesh_t_cap
        )
        self.canonical_triangle_count = min(tc, self._mesh_t_cap)

    def restore_camera_state(self, state: dict) -> None:
        self.extrinsics = torch.as_tensor(state["extrinsics"], dtype=torch.float32, device=self.device)
        previous = state.get("previous_depth")
        self.previous_depth = None if previous is None else torch.as_tensor(previous, device=self.device)
        self.frames_processed = int(state["frames_processed"])

    # -- neural tracking prior and tracking spans ----------------------------

    def _reset_keyframe(self, depth: torch.Tensor, color) -> None:
        """The current frame and cumulative node transforms become the
        prior's tracking source."""
        self.keyframe_source = (depth, color)
        self.keyframe_rotations = self.warp_field.node_rotations
        self.keyframe_translations = self.warp_field.node_translations
        self.keyframe_anchors = None

    def _keyframe_should_roll(self) -> bool:
        span = self.params.fusion.tracking_span_mode
        if span == TrackingSpanMode.PREVIOUS_TO_CURRENT:
            return True
        if span == TrackingSpanMode.KEYFRAME_TO_CURRENT:
            return self.frames_processed % self.params.fusion.keyframe_interval == 0
        return False  # FIRST_TO_CURRENT

    def _prior_source_rgbxyz(self) -> torch.Tensor:
        """The prior's source RGBD: the keyframe's images. Stays on the
        device."""
        kf_depth, kf_color = self.keyframe_source
        f = self.params.fusion
        if f.source_image_mode != SourceImageMode.IMAGE_ONLY:
            raise NotImplementedError("the benchmark's reference renders no prior source")
        return rgbxyz_from_depth(kf_depth, kf_color, self.intrinsics, f.depth_scale, f.far_clip_distance)

    def _prior_pixel_anchors(self, source_points: torch.Tensor):
        """Pixel anchors of the prior's source image against the node
        positions as warped at the keyframe, per
        ``fusion.pixel_anchor_computation_mode``; cached until the keyframe
        rolls."""
        if self.keyframe_anchors is not None:
            return self.keyframe_anchors
        g = self.params.graph
        nodes_kf = self.warp_field.node_positions + self.keyframe_translations
        if self.params.fusion.pixel_anchor_computation_mode == AnchorComputationMode.SHORTEST_PATH:
            anchors, weights = compute_pixel_anchors_shortest_path(
                source_points.cpu().numpy(), nodes_kf.cpu().numpy(), self._node_graph_edges(),
                g.anchor_count, g.node_coverage,
            )
            anchors = torch.as_tensor(anchors, device=self.device)
            weights = torch.as_tensor(weights, device=self.device)
        else:  # EUCLIDEAN
            h, w = source_points.shape[:2]
            anchors, weights, _ = compute_anchors_euclidean(
                source_points.reshape(-1, 3), nodes_kf, g.anchor_count, node_coverage=g.node_coverage,
                minimum_valid_anchor_count=g.minimum_valid_anchor_count, use_threshold=True,
            )
            anchors, weights = anchors.reshape(h, w, -1), weights.reshape(h, w, -1)
        self.keyframe_anchors = (anchors, weights)
        return self.keyframe_anchors

    def _node_graph_edges(self) -> np.ndarray:
        """The nodes' Euclidean 8-NN adjacency (built once per graph)."""
        if self.node_graph_edges is None:
            self.node_graph_edges = compute_edges_euclidean(
                self.warp_field.node_positions.cpu().numpy(), self.params.graph.neighbor_count,
                self.params.graph.node_coverage,
            )[0]
        return self.node_graph_edges

    def _apply_prior(self, depth: torch.Tensor, color, prior_flow) -> dict:
        """Run the prior (keyframe -> current frame) and compose its span
        transforms onto the keyframe's as the fit's starting point. Returns
        the ``prior_valid`` / ``prior_matches`` metrics."""
        p = self.params
        if self.prior is None:
            deform_net = None
            if p.fusion.prior_checkpoint:
                deform_net = _load_prior_network(p.fusion.prior_checkpoint, self.warp_field.num_nodes, self.device)
            # the cluster weight threshold scales with the image area; the
            # default 2000 is calibrated for 448x640
            h, w = depth.shape
            guards = TrackingGuards(
                min_num_correspondences_per_cluster=max(2000.0 * (h * w) / float(448 * 640), 16.0),
                depth_max=p.fusion.far_clip_distance,
            )
            self.prior = NeuralTrackingPrior(gn_config=GnConfig(), guards=guards, deform_net=deform_net)
        source = self._prior_source_rgbxyz()
        target = rgbxyz_from_depth(depth, color, self.intrinsics, p.fusion.depth_scale, p.fusion.far_clip_distance)
        anchors, weights = self._prior_pixel_anchors(source[..., 3:])
        nodes_kf = self.warp_field.node_positions + self.keyframe_translations
        # span estimates: keyframe -> current increments of the cumulative
        # transforms (identity right after a keyframe roll)
        r_k, t_k = self.keyframe_rotations, self.keyframe_translations
        r_est = torch.einsum("nab,ncb->nac", self.warp_field.node_rotations, r_k)
        t_est = self.warp_field.node_translations - t_k
        edges = torch.as_tensor(self._node_graph_edges(), device=self.device)
        result = self.prior.predict(
            source, target, nodes_kf, edges, torch.where(edges >= 0, 1.0, 0.0),
            torch.zeros((self.warp_field.num_nodes,), dtype=torch.int32, device=self.device),
            anchors, weights, self.intrinsics,
            flow_override=prior_flow, initial_rotations=r_est, initial_translations=t_est,
        )
        if result.valid_solve:
            # R_cum' = R_span R_k, t_cum' = t_k + t_span
            self.warp_field = self.warp_field.replace(
                node_rotations=torch.einsum("nab,nbc->nac", result.rotations, r_k),
                node_translations=t_k + result.translations,
            )
        return {"prior_valid": result.valid_solve, "prior_matches": int(torch.sum(result.correspondence_mask))}

    # -- subsequent frames ---------------------------------------------------

    def process_frame(self, depth: np.ndarray, color: np.ndarray | None, prior_flow=None) -> dict:
        """Fuse one frame; ``prior_flow`` (f32[H, W, 2], keyframe -> this
        frame, in pixels) runs the neural prior with that flow."""
        p = self.params
        use_rigid = p.alignment.use_rigid_alignment
        self.frames_processed += 1
        depth_t = self._frame(depth)

        # rigid stage: frame-to-frame point-to-plane ICP accumulates the
        # camera pose; observations move into the canonical camera before
        # the non-rigid fit
        rigid_rmse = torch.zeros((), dtype=torch.float32, device=self.device)
        if use_rigid and self.previous_depth is not None:
            delta, rigid_rmse = rigid_odometry.rigid_odometry_multi_scale(
                self.previous_depth,
                depth_t,
                self.intrinsics,
                depth_scale=p.fusion.depth_scale,
                depth_max=p.fusion.far_clip_distance,
            )
            self.extrinsics = delta @ self.extrinsics
        self.previous_depth = depth_t
        pose = self.extrinsics if use_rigid else None

        points, mask = observed_points(
            depth_t, self.intrinsics, pose, p.fusion.depth_scale, p.fusion.far_clip_distance
        )
        # neural prior: predict the keyframe -> current node transforms and
        # start the fit from them
        prior_metrics = {}
        if p.fusion.use_neural_prior or prior_flow is not None:
            if self.keyframe_source is None:
                # no tracking source yet (a fresh resume): this frame becomes
                # it and the fit runs alone once
                self._reset_keyframe(depth_t, color)
                prior_metrics = {"prior_valid": False, "prior_matches": 0}
            else:
                prior_metrics = self._apply_prior(depth_t, color, prior_flow)
        self.warp_field, diagnostics = fit_to_image(
            self.warp_field,
            self.canonical_vertices,
            self.canonical_triangles,
            points,
            mask,
            self.intrinsics,
            self.fitter_config,
            device=self.device,
        )
        max_active = min(p.tsdf.max_active_blocks, self.volume.capacity)
        # a frame whose final GN iteration failed its valid-solve guard is
        # not fused
        if bool(diagnostics["valid_solve"][-1]):
            self.volume, n_intersecting = volume_update(
                self.volume,
                self.warp_field,
                depth_t,
                self._frame(color) if color is not None else None,
                self.intrinsics,
                max_active,
                p.fusion.depth_scale,
                p.fusion.far_clip_distance,
                post_warp_extrinsics=pose,
            )
        else:
            n_intersecting = torch.zeros((), dtype=torch.int64, device=self.device)
        self._refresh_canonical_mesh()
        if self.keyframe_source is not None and self._keyframe_should_roll():
            self._reset_keyframe(depth_t, color)
        metrics = {
            "data_loss": diagnostics["data_loss"],
            "arap_loss": diagnostics["arap_loss"],
            "active_blocks": n_intersecting,
            "rigid_rmse": rigid_rmse,
            "valid_solve": diagnostics["valid_solve"],
            "pixel_cap_kept_fraction": diagnostics["pixel_cap_kept_fraction"][-1],
            # the binned rasterizer's overflow per GN iteration (the port's
            # own counters: the JAX fitter does not report it)
            "dropped_large_faces": diagnostics["dropped_large_faces"],
            "dropped_bin_entries": diagnostics["dropped_bin_entries"],
        }
        if not p.fusion.sync_frame_metrics:
            return {**metrics, **prior_metrics}
        return {**resolve_frame_metrics(metrics), **prior_metrics}


def _parse_iteration_modes(spec: str) -> tuple:
    """``alignment.iteration_modes`` ("all", "translation_only,all", ...) ->
    ``IterationMode`` tuple (cycled over the iteration count)."""
    out = []
    for token in spec.split(","):
        token = token.strip().upper()
        if not token:
            continue
        try:
            out.append(IterationMode[token])
        except KeyError:
            raise ValueError(
                f"unknown alignment.iteration_modes entry {token!r}; "
                f"expected one of {[m.name.lower() for m in IterationMode]}"
            ) from None
    return tuple(out) or (IterationMode.ALL,)


def resolve_frame_metrics(metrics: dict) -> dict:
    """``process_frame`` metrics as plain Python scalars / lists."""
    out = dict(metrics)
    out["data_loss"] = [float(x) for x in metrics["data_loss"]]
    out["arap_loss"] = [float(x) for x in metrics["arap_loss"]]
    out["active_blocks"] = int(metrics["active_blocks"])
    out["rigid_rmse"] = float(metrics["rigid_rmse"])
    out["valid_solve"] = [bool(x) for x in metrics["valid_solve"]]
    out["pixel_cap_kept_fraction"] = float(metrics["pixel_cap_kept_fraction"])
    out["dropped_large_faces"] = [int(x) for x in metrics["dropped_large_faces"]]
    out["dropped_bin_entries"] = [int(x) for x in metrics["dropped_bin_entries"]]
    return out


def _load_prior_network(checkpoint_path: str, num_nodes: int, device) -> DeformNet:
    """A DeformNet on ``device`` with the weights of a ``.pt`` / ``.pth``
    state dict."""
    net = DeformNet(use_mask=True, num_nodes=num_nodes, gn_config=GnConfig())
    net.load_state_dict(torch.load(checkpoint_path, map_location="cpu", weights_only=True))
    return net.to(device).eval()


_CROP_NODE_CHUNK = 32  # nodes per distance pass: 118 MB of differences at 480x640


def crop_depth_to_coverage(depth, nodes, intrinsics, depth_scale: float, far_clip: float, radius: float):
    """Zero the depth pixels farther than ``radius`` from every graph node.

    Loaded graphs come from a masked subject; their nodes' coverage region
    stands in for that mask, so the first frame integrates the subject only.
    The nearest-node squared distance is a minimum over chunks of nodes."""
    points, mask = unproject_depth_image(depth, intrinsics, depth_scale, far_clip)
    flat = points.reshape(-1, 3)
    best = torch.full((flat.shape[0],), torch.inf, dtype=torch.float32, device=flat.device)
    for s in range(0, nodes.shape[0], _CROP_NODE_CHUNK):
        d2 = torch.sum((flat[:, None, :] - nodes[None, s : s + _CROP_NODE_CHUNK, :]) ** 2, dim=-1)
        best = torch.minimum(best, torch.amin(d2, dim=1))
    r = torch.full((), radius, dtype=torch.float32, device=flat.device)
    keep = mask & (best.reshape(depth.shape) <= r * r)
    return torch.where(keep, depth, 0).to(depth.dtype)


def observed_points(depth, intrinsics, extrinsics, depth_scale: float, far_clip: float):
    """Depth -> observed point image + mask, in the canonical camera: the
    inverse of ``extrinsics`` (canonical -> current camera) moves the valid
    points; None keeps the current camera."""
    points, mask = unproject_depth_image(depth, intrinsics, depth_scale, far_clip)
    if extrinsics is not None:
        inv = torch.linalg.inv_ex(extrinsics)[0]
        moved = transform_points(points.reshape(-1, 3), inv).reshape(points.shape)
        points = torch.where(mask[..., None], moved, 0.0)
    return points, mask


def volume_update(
    volume: VoxelBlockGrid,
    field: HierarchicalGraphWarpField,
    depth,
    color,
    intrinsics,
    max_active: int,
    depth_scale: float,
    far_clip: float,
    post_warp_extrinsics=None,
):
    """The per-frame TSDF update: block discovery, sleeve activation,
    re-discovery, active-list compaction, non-rigid integration (through the
    field, then the camera pose). Returns the new volume and the number of
    intersecting blocks."""
    intersecting = volume.find_blocks_intersecting_truncation_region(
        depth, field, intrinsics, post_warp_extrinsics=post_warp_extrinsics
    )
    volume = volume.activate_sleeve_blocks(intersecting)
    intersecting = volume.find_blocks_intersecting_truncation_region(
        depth, field, intrinsics, post_warp_extrinsics=post_warp_extrinsics
    )
    active_slots, n_active = compact_mask_indices(intersecting, max_active, fill_value=0)
    active_valid = intersecting[active_slots] & (
        torch.arange(max_active, device=volume.device) < n_active
    )
    raw_points, _ = unproject_depth_image(depth, intrinsics, depth_scale, far_clip)
    if active_slots.shape[0]:
        volume = volume.integrate_non_rigid(
            active_slots,
            active_valid,
            field,
            depth,
            intrinsics,
            color=(color.to(torch.float32) / 255.0) if color is not None else None,
            normals=point_image_normals(raw_points),
            post_warp_extrinsics=post_warp_extrinsics,
        )
    return volume, torch.sum(intersecting)


def _slice_mesh_arrays(verts, faces, v_cap: int, t_cap: int):
    """Slice max-capacity extraction output to the fitter's buckets: vertex
    slot ``v_cap - 1`` becomes the padding vertex and any face index at or
    past it redirects there."""
    v = verts[:v_cap].clone()
    v[v_cap - 1] = 0.0
    f = faces[:t_cap]
    f = torch.where(f >= v_cap - 1, v_cap - 1, f).to(torch.int32).contiguous()
    return v, f


def _capacity_bucket(n: int, minimum: int = 1024) -> int:
    """Smallest power of two >= max(n, minimum)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _max_feasible_layers(node_count: int) -> int:
    if node_count < 8:
        return 1
    if node_count < 24:
        return 2
    return 4
