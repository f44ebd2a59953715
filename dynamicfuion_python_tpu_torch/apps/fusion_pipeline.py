"""DynamicFusion pipeline: dense non-rigid RGB-D fusion over a sequence
(port of ``dynamicfuion_python_tpu/apps/fusion_pipeline.py``, the default
path).

  frame 0:  discover + activate blocks -> rigid TSDF integrate -> extract the
            canonical mesh -> sample graph nodes on it (erode -> sample ->
            hierarchy layers)
  frame t:  unproject depth -> fit the warp field by Gauss-Newton/LM
            mesh-to-image alignment -> find blocks intersecting the warped
            truncation region -> sleeve activation -> non-rigid integrate ->
            re-extract the canonical mesh

Not ported yet, and refused with ``NotImplementedError``: rigid odometry
(ROADMAP A7), the neural tracking prior and tracking spans (A12), the
depth-image and loaded graph modes, SPMD (A17), telemetry and checkpoints
(A15).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.models.fitter import FitterConfig, IterationMode, fit_to_image
from dynamicfuion_python_tpu_torch.models.voxel_block_grid import (
    VoxelBlockGrid,
    extract_mesh_fitter_arrays,
)
from dynamicfuion_python_tpu_torch.models.warp_field import (
    HierarchicalGraphWarpField,
    NodeCoverageMethod,
)
from dynamicfuion_python_tpu_torch.ops.camera import unproject_depth_image
from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.ops.graph_construction import sample_nodes, vertex_erosion_mask
from dynamicfuion_python_tpu_torch.ops.normals import point_image_normals
from dynamicfuion_python_tpu_torch.settings import (
    GraphGenerationMode,
    MeshExtractionWeightThresholdingMode,
    Parameters,
)
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


class FusionPipeline:
    """Orchestrates the per-frame fusion loop on one device (the CUDA card
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, params: Parameters, intrinsics: np.ndarray, device=None):
        a = params.alignment
        f = params.fusion
        if a.use_rigid_alignment:
            raise NotImplementedError(
                "rigid odometry is not ported yet (ROADMAP A7); set "
                "alignment.use_rigid_alignment=false"
            )
        if f.use_neural_prior:
            raise NotImplementedError("the neural tracking prior is not ported yet (ROADMAP A12)")
        if f.graph_generation_mode != GraphGenerationMode.FIRST_FRAME_EXTRACTED_MESH:
            raise NotImplementedError(
                f"graph_generation_mode={f.graph_generation_mode.name} is not ported yet; "
                "only FIRST_FRAME_EXTRACTED_MESH runs in the PyTorch port"
            )
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
        self.frames_processed = 0
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

    def initialize(self, depth: np.ndarray, color: np.ndarray | None):
        """Rigid-integrate the first frame and build the deformation graph on
        its extracted mesh (``FIRST_FRAME_EXTRACTED_MESH``)."""
        p = self.params
        depth_t = self._frame(depth)
        keys = self.volume.compute_unique_block_coordinates(depth_t, self.intrinsics, stride=2)
        self.volume = self.volume.activate(keys)
        color_t = self._frame(color).to(torch.float32) / 255.0 if color is not None else None
        self.volume = self.volume.integrate(depth_t, self.intrinsics, color=color_t)
        self._refresh_canonical_mesh(sync=True)

        faces = self.canonical_triangles[: self.canonical_triangle_count].cpu().numpy()
        verts = self.canonical_vertices.cpu().numpy()
        erosion = vertex_erosion_mask(
            verts, faces, p.graph.erosion_num_iterations, p.graph.erosion_min_neighbors
        )
        nodes, _ = sample_nodes(verts, erosion, p.graph.node_coverage, use_only_non_eroded=True)
        if len(nodes) < p.graph.anchor_count:
            used = np.zeros(len(verts), bool)
            used[faces.reshape(-1)] = True
            nodes, _ = sample_nodes(verts, used, p.graph.node_coverage, use_only_non_eroded=True)
        self.warp_field = HierarchicalGraphWarpField.build(
            nodes,
            node_coverage=p.graph.node_coverage,
            layer_count=min(p.graph.layer_count, _max_feasible_layers(len(nodes))),
            max_vertex_degree=p.graph.max_vertex_degree,
            anchor_count=p.graph.anchor_count,
            minimum_valid_anchor_count=p.graph.minimum_valid_anchor_count,
            threshold_nodes_by_distance=p.graph.minimum_valid_anchor_count > 0,
            coverage_method=NodeCoverageMethod.FIXED,
            device=self.device,
        )

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

    def enable_spmd(self, mesh) -> None:
        raise NotImplementedError("the SPMD frame loop is not ported yet (ROADMAP A17)")

    # -- subsequent frames ---------------------------------------------------

    def process_frame(self, depth: np.ndarray, color: np.ndarray | None) -> dict:
        p = self.params
        self.frames_processed += 1
        depth_t = self._frame(depth)
        points, mask = observed_points(depth_t, self.intrinsics, p.fusion.depth_scale, p.fusion.far_clip_distance)
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
            )
        else:
            n_intersecting = torch.zeros((), dtype=torch.int64, device=self.device)
        self._refresh_canonical_mesh()
        metrics = {
            "data_loss": diagnostics["data_loss"],
            "arap_loss": diagnostics["arap_loss"],
            "active_blocks": n_intersecting,
            "valid_solve": diagnostics["valid_solve"],
            "pixel_cap_kept_fraction": diagnostics["pixel_cap_kept_fraction"][-1],
            "dropped_large_faces": diagnostics["dropped_large_faces"],
            "dropped_bin_entries": diagnostics["dropped_bin_entries"],
        }
        if not p.fusion.sync_frame_metrics:
            return metrics
        return resolve_frame_metrics(metrics)


def run_fusion(*args, **kwargs):
    """The sequence driver with telemetry and checkpoints: not ported yet."""
    raise NotImplementedError(
        "run_fusion (telemetry, checkpoints, CLI) is not ported yet (ROADMAP A15); "
        "drive FusionPipeline.initialize / process_frame directly"
    )


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
    out["valid_solve"] = [bool(x) for x in metrics["valid_solve"]]
    out["pixel_cap_kept_fraction"] = float(metrics["pixel_cap_kept_fraction"])
    out["dropped_large_faces"] = [int(x) for x in metrics["dropped_large_faces"]]
    out["dropped_bin_entries"] = [int(x) for x in metrics["dropped_bin_entries"]]
    return out


def observed_points(depth, intrinsics, depth_scale: float, far_clip: float):
    """Depth -> observed point image + mask (canonical camera = current
    camera: rigid odometry is not ported)."""
    return unproject_depth_image(depth, intrinsics, depth_scale, far_clip)


def volume_update(
    volume: VoxelBlockGrid,
    field: HierarchicalGraphWarpField,
    depth,
    color,
    intrinsics,
    max_active: int,
    depth_scale: float,
    far_clip: float,
):
    """The per-frame TSDF update: block discovery, sleeve activation,
    re-discovery, active-list compaction, non-rigid integration. Returns the
    new volume and the number of intersecting blocks."""
    intersecting = volume.find_blocks_intersecting_truncation_region(depth, field, intrinsics)
    volume = volume.activate_sleeve_blocks(intersecting)
    intersecting = volume.find_blocks_intersecting_truncation_region(depth, field, intrinsics)
    active_slots, n_active = compact_mask_indices(intersecting, max_active, fill_value=0)
    active_valid = intersecting[active_slots] & (
        torch.arange(max_active, device=volume.device) < n_active
    )
    raw_points, _ = unproject_depth_image(depth, intrinsics, depth_scale, far_clip)
    volume = volume.integrate_non_rigid(
        active_slots,
        active_valid,
        field,
        depth,
        intrinsics,
        color=(color.to(torch.float32) / 255.0) if color is not None else None,
        normals=point_image_normals(raw_points),
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
