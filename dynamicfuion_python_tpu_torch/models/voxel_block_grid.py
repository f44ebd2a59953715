"""Sparse voxel-block TSDF volume with rigid and non-rigid integration (port
of ``dynamicfuion_python_tpu/models/voxel_block_grid.py``).

A static-capacity block table (packed int32 keys per slot + a sorted key
index, see ``ops/voxel_block_hash.py``) holds per-block tsdf / weight / color
voxels. Activation is sort + compaction into free slots; integration runs
over all occupied blocks (rigid) or a padded active-block list (non-rigid,
through the warp field); extraction is marching cubes over blocks with +1
halos stitched from neighbor blocks (or marching tetrahedra, the denser
alternative), then welding on a 1e-6 m grid. The volume reads out by
trilinear sampling (tsdf, color) and by ray casting: a march at half the
truncation distance with a fixed step count, a Python loop over tensors
with no host sync, then one secant step at the first zero crossing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.ops import voxel_block_hash as vbh
from dynamicfuion_python_tpu_torch.ops.camera import (
    project_points,
    transform_points,
    unproject_depth_image,
)
from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.ops.marching_cubes import marching_cubes
from dynamicfuion_python_tpu_torch.ops.marching_tetrahedra import marching_tetrahedra
from dynamicfuion_python_tpu_torch.ops.warp import blend_warp
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


def _cube_offsets(values, dtype, device) -> torch.Tensor:
    return trace.upload(
        [[a, b, c] for a in values for b in values for c in values], device, "volume.offsets", dtype
    )


def _unit_cube_corners(device) -> torch.Tensor:
    """int32[8, 3]: the corners of the unit cube in ``_cube_offsets`` order,
    made on the device from an arange (no host copy, so callers stay
    sync-free)."""
    a = torch.arange(8, dtype=torch.int32, device=device)
    return torch.stack([(a >> 2) & 1, (a >> 1) & 1, a & 1], dim=-1)


@dataclasses.dataclass(frozen=True)
class VoxelBlockGrid:
    """Static-capacity sparse TSDF volume (canonical frame)."""

    slot_keys: torch.Tensor  # int32[Cap] packed block coords; EMPTY_KEY = free
    sorted_keys: torch.Tensor  # int32[Cap]
    slot_of_sorted: torch.Tensor  # int32[Cap]
    tsdf: torch.Tensor  # f32[Cap, R, R, R]
    weight: torch.Tensor  # f32[Cap, R, R, R]
    color: torch.Tensor  # f32[Cap, R, R, R, 3]
    voxel_size: float = 0.004
    block_resolution: int = 8
    sdf_truncation_distance: float = 0.02
    depth_scale: float = 1000.0
    depth_max: float = 3.0

    @classmethod
    def create(
        cls,
        capacity: int = 2048,
        voxel_size: float = 0.004,
        block_resolution: int = 8,
        sdf_truncation_distance: float = 0.02,
        depth_scale: float = 1000.0,
        depth_max: float = 3.0,
        device: str | torch.device | None = None,
    ) -> "VoxelBlockGrid":
        """An empty volume on ``device`` (the CUDA card unless the caller
        passes ``device="cpu"``)."""
        dev = resolve_device(device)
        r = block_resolution
        keys = torch.full((capacity,), vbh.EMPTY_KEY, dtype=torch.int32, device=dev)
        return cls(
            slot_keys=keys,
            sorted_keys=keys.clone(),
            slot_of_sorted=torch.arange(capacity, dtype=torch.int32, device=dev),
            tsdf=torch.zeros((capacity, r, r, r), dtype=torch.float32, device=dev),
            weight=torch.zeros((capacity, r, r, r), dtype=torch.float32, device=dev),
            color=torch.zeros((capacity, r, r, r, 3), dtype=torch.float32, device=dev),
            voxel_size=float(voxel_size),
            block_resolution=int(block_resolution),
            sdf_truncation_distance=float(sdf_truncation_distance),
            depth_scale=float(depth_scale),
            depth_max=float(depth_max),
        )

    @property
    def capacity(self) -> int:
        return self.slot_keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.slot_keys.device

    def replace(self, **changes) -> "VoxelBlockGrid":
        return dataclasses.replace(self, **changes)

    def occupied_mask(self) -> torch.Tensor:
        return self.slot_keys != vbh.EMPTY_KEY

    def occupied_count(self) -> torch.Tensor:
        return torch.sum(self.occupied_mask())

    def block_side(self) -> float:
        return self.block_resolution * self.voxel_size

    # -- block discovery & activation ----------------------------------------

    def compute_unique_block_coordinates(
        self, depth, intrinsics, extrinsics=None, stride: int = 4
    ) -> torch.Tensor:
        """Packed keys of the 27 blocks around each strided valid pixel's
        surface point (cube of half-size = truncation), deduplicated and
        padded with EMPTY_KEY. ``extrinsics`` (world -> camera) moves the
        points into the world by its inverse."""
        points, mask = unproject_depth_image(depth, intrinsics, self.depth_scale, self.depth_max)
        points = points[::stride, ::stride].reshape(-1, 3)
        mask = mask[::stride, ::stride].reshape(-1)
        if extrinsics is not None:
            points = transform_points(points, torch.linalg.inv_ex(extrinsics)[0])
        trunc = self.sdf_truncation_distance
        offsets = _cube_offsets((-trunc, 0.0, trunc), torch.float32, self.device)
        cand = points[:, None, :] + offsets[None, :, :]
        blocks = torch.floor(cand / self.block_side()).to(torch.int32)
        keys = vbh.pack_block_keys(blocks).reshape(-1)
        keys = torch.where(mask.repeat_interleave(27), keys, vbh.EMPTY_KEY)
        unique, _ = vbh.unique_keys_padded(keys)
        return unique

    def activate(self, candidate_keys: torch.Tensor) -> "VoxelBlockGrid":
        """Insert novel blocks into free slots (ascending slot order, keys
        ascending); candidates beyond capacity are dropped."""
        unique, _ = vbh.unique_keys_padded(candidate_keys)
        _, found = vbh.lookup(self.sorted_keys, self.slot_of_sorted, unique)
        novel = torch.where((unique != vbh.EMPTY_KEY) & ~found, unique, vbh.EMPTY_KEY)
        novel_sorted = torch.sort(novel).values
        n_novel = torch.sum(novel_sorted != vbh.EMPTY_KEY)
        free = self.slot_keys == vbh.EMPTY_KEY
        free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
        take = free & (free_rank < n_novel)
        # only ranks below n_novel are taken; the clamp keeps the others in
        # range of a candidate list shorter than the table
        assigned = novel_sorted[torch.clamp(free_rank, 0, novel_sorted.shape[0] - 1)]
        new_slot_keys = torch.where(take, assigned, self.slot_keys)
        sorted_keys, slot_of_sorted = vbh.build_sorted_index(new_slot_keys)
        return self.replace(
            slot_keys=new_slot_keys, sorted_keys=sorted_keys, slot_of_sorted=slot_of_sorted
        )

    def find_block_slots(self, keys: torch.Tensor):
        return vbh.lookup(self.sorted_keys, self.slot_of_sorted, keys)

    def block_coordinates(self) -> torch.Tensor:
        """int32[Cap, 3] block coords (garbage where unoccupied)."""
        return vbh.unpack_block_keys(self.slot_keys)

    def _voxel_world_positions(self, slots: torch.Tensor) -> torch.Tensor:
        """f32[S, R, R, R, 3] world positions of voxel centers."""
        r = self.block_resolution
        coords = vbh.unpack_block_keys(self.slot_keys[slots])
        ar = torch.arange(r, dtype=torch.int32, device=self.device)
        local = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
        global_voxels = (coords[:, None, None, None, :] * r + local[None]).to(torch.float32)
        return global_voxels * self.voxel_size

    # -- integration ------------------------------------------------------------

    def integrate(self, depth, intrinsics, extrinsics=None, color=None) -> "VoxelBlockGrid":
        """Rigid TSDF fusion over all occupied blocks (psdf = depth - z,
        normalized by truncation, running weighted average); ``extrinsics``
        maps world to camera."""
        slots = torch.arange(self.capacity, device=self.device)
        return self._integrate_impl(
            slots, self.occupied_mask(), depth, intrinsics, extrinsics, color, warp=None
        )

    def integrate_non_rigid(
        self, block_slots, block_slots_valid, warp_field, depth, intrinsics,
        extrinsics=None, color=None, normals=None, post_warp_extrinsics=None,
    ) -> "VoxelBlockGrid":
        """Non-rigid fusion through the warp field over the given block list;
        ``normals`` f32[H, W, 3] rejects oblique readings (cosine <= 0.5).
        ``extrinsics`` applies before warping (the field lives in the current
        camera frame), ``post_warp_extrinsics`` after it (the field lives in
        the canonical frame and the camera moves separately, as in the
        pipeline)."""
        return self._integrate_impl(
            block_slots, block_slots_valid, depth, intrinsics, extrinsics, color,
            warp=warp_field, normals=normals, post_warp_extrinsics=post_warp_extrinsics,
        )

    def _integrate_impl(
        self, slots, slots_valid, depth, intrinsics, extrinsics, color, warp, normals=None,
        post_warp_extrinsics=None,
    ) -> "VoxelBlockGrid":
        r = self.block_resolution
        h, w = depth.shape
        trunc = self.sdf_truncation_distance
        slots = slots.long()
        cam = self._voxel_world_positions(slots).reshape(-1, 3)
        if extrinsics is not None:
            cam = transform_points(cam, extrinsics)
        if warp is not None:
            anchors, weights, anchor_valid = warp.compute_anchors(cam)
            warped = blend_warp(
                cam, warp.node_positions, warp.node_rotations, warp.node_translations,
                anchors, weights,
            )
        else:
            anchor_valid = torch.ones(cam.shape[:1], dtype=torch.bool, device=self.device)
            warped = cam
        if post_warp_extrinsics is not None:
            warped = transform_points(warped, post_warp_extrinsics)

        uv, in_front = project_points(warped, intrinsics)
        u = torch.round(uv[..., 0]).to(torch.int64)
        v = torch.round(uv[..., 1]).to(torch.int64)
        in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
        d = depth.to(torch.float32).reshape(-1)[pix] / self.depth_scale
        depth_ok = (d > 0.0) & (d <= self.depth_max)
        psdf = d - warped[..., 2]
        update = anchor_valid & in_front & in_bounds & depth_ok & (psdf > -trunc)
        if normals is not None and warp is not None:
            view_dir = -warped / torch.clamp(
                torch.linalg.norm(warped, dim=-1, keepdim=True), min=1e-12
            )
            cosine = torch.sum(view_dir * normals.reshape(-1, 3)[pix], dim=-1)
            # reject oblique readings (camera-facing normals: head-on = +1)
            update = update & (cosine > 0.5)
        tsdf_new = torch.clamp(psdf, max=trunc) / trunc

        shape_blocks = (slots.shape[0], r, r, r)
        update = update.reshape(shape_blocks) & slots_valid[:, None, None, None]
        tsdf_new = tsdf_new.reshape(shape_blocks)
        old_tsdf = self.tsdf[slots]
        old_weight = self.weight[slots]
        inv_w = 1.0 / (old_weight + 1.0)
        merged_tsdf = torch.where(update, (old_weight * old_tsdf + tsdf_new) * inv_w, old_tsdf)
        merged_weight = torch.where(update, old_weight + 1.0, old_weight)

        # padded list entries (slots_valid False) write nothing: they are
        # routed to a row past the table that is dropped
        dest = torch.where(slots_valid, slots, self.capacity)

        def scatter(table, values):
            out = torch.cat([table, table[:1]])
            out[dest] = values
            return out[: self.capacity]

        new_color = self.color
        if color is not None:
            sampled = color.reshape(-1, 3)[pix].reshape(*shape_blocks, 3)
            old_color = self.color[slots]
            merged_color = torch.where(
                update[..., None],
                (old_weight[..., None] * old_color + sampled) * inv_w[..., None],
                old_color,
            )
            new_color = scatter(self.color, merged_color)
        return self.replace(
            tsdf=scatter(self.tsdf, merged_tsdf),
            weight=scatter(self.weight, merged_weight),
            color=new_color,
        )

    # -- block / truncation-region tests ----------------------------------------

    def find_blocks_intersecting_truncation_region(
        self, depth, warp_field, intrinsics, extrinsics=None, downsample: int = 16,
        post_warp_extrinsics=None,
    ) -> torch.Tensor:
        """bool[Cap]: occupied blocks whose warped extent may intersect the
        depth frame's truncation band (warp the 8 block corners, compare the
        AABB against the depth range behind its pixel footprint +- trunc).
        ``extrinsics`` / ``post_warp_extrinsics`` move the corners before /
        after warping, as in :meth:`integrate_non_rigid`."""
        side = self.block_side()
        dev = self.device
        coords = self.block_coordinates().to(torch.float32)
        corner_offsets = _unit_cube_corners(dev).to(torch.float32)
        corners = (coords[:, None, :] + corner_offsets[None]) * side
        flat = corners.reshape(-1, 3)
        if extrinsics is not None:
            flat = transform_points(flat, extrinsics)
        anchors, weights, _ = warp_field.compute_anchors(flat)
        warped = blend_warp(
            flat, warp_field.node_positions, warp_field.node_rotations,
            warp_field.node_translations, anchors, weights,
        )
        if post_warp_extrinsics is not None:
            warped = transform_points(warped, post_warp_extrinsics)
        warped = warped.reshape(-1, 8, 3)
        uv, in_front = project_points(warped.reshape(-1, 3), intrinsics)
        uv = uv.reshape(-1, 8, 2)
        in_front = in_front.reshape(-1, 8)
        zmin = torch.amin(warped[..., 2], dim=1)
        zmax = torch.amax(warped[..., 2], dim=1)

        h, w = depth.shape
        d = depth.to(torch.float32) / self.depth_scale
        valid = (d > 0) & (d <= self.depth_max)
        hp = (h + downsample - 1) // downsample * downsample
        wp = (w + downsample - 1) // downsample * downsample
        dmin_full = torch.full((hp, wp), torch.inf, device=dev)
        dmin_full[:h, :w] = torch.where(valid, d, torch.inf)
        dmax_full = torch.zeros((hp, wp), device=dev)
        dmax_full[:h, :w] = torch.where(valid, d, 0.0)
        ch, cw = hp // downsample, wp // downsample
        dmin = dmin_full.reshape(ch, downsample, cw, downsample).amin(dim=(1, 3))
        dmax = dmax_full.reshape(ch, downsample, cw, downsample).amax(dim=(1, 3))

        u0 = torch.clamp(torch.amin(uv[..., 0], dim=1) / downsample, 0, cw - 1)
        u1 = torch.clamp(torch.amax(uv[..., 0], dim=1) / downsample, 0, cw - 1)
        v0 = torch.clamp(torch.amin(uv[..., 1], dim=1) / downsample, 0, ch - 1)
        v1 = torch.clamp(torch.amax(uv[..., 1], dim=1) / downsample, 0, ch - 1)
        ts = torch.linspace(0.0, 1.0, 4, device=dev)
        gu = (u0[:, None] + (u1 - u0)[:, None] * ts[None]).to(torch.int64)
        gv = (v0[:, None] + (v1 - v0)[:, None] * ts[None]).to(torch.int64)
        cell_min = dmin[gv[:, :, None], gu[:, None, :]].amin(dim=(1, 2))
        cell_max = dmax[gv[:, :, None], gu[:, None, :]].amax(dim=(1, 2))

        trunc = self.sdf_truncation_distance
        overlap = (zmin - trunc <= cell_max) & (zmax + trunc >= cell_min)
        on_screen = torch.any(in_front, dim=1) & (cell_max > 0)
        return self.occupied_mask() & overlap & on_screen

    def activate_sleeve_blocks(self, intersecting_mask: torch.Tensor) -> "VoxelBlockGrid":
        """Allocate the 26-neighborhood of flagged blocks."""
        neighbor_offsets = _cube_offsets((-1, 0, 1), torch.int32, self.device)
        cand = self.block_coordinates()[:, None, :] + neighbor_offsets[None]
        keys = vbh.pack_block_keys(cand).reshape(-1)
        keys = torch.where(intersecting_mask.repeat_interleave(27), keys, vbh.EMPTY_KEY)
        return self.activate(keys)

    # -- extraction -------------------------------------------------------------

    def _stitched_volumes(self, weight_threshold: float = 0.0):
        """Per-block [R+1]^3 tsdf + validity with +1 halos from the 7
        positive-direction neighbor blocks; voxels below ``weight_threshold``
        (or with zero weight when it is 0) are invalid."""
        r = self.block_resolution
        cap = self.capacity
        dev = self.device
        coords = self.block_coordinates()
        thr = max(float(weight_threshold), 0.0)

        def weight_ok(wgt):
            return wgt >= thr if thr > 0 else wgt > 0

        tsdf_p = torch.zeros((cap, r + 1, r + 1, r + 1), dtype=torch.float32, device=dev)
        valid_p = torch.zeros((cap, r + 1, r + 1, r + 1), dtype=torch.bool, device=dev)
        tsdf_p[:, :r, :r, :r] = self.tsdf
        valid_p[:, :r, :r, :r] = weight_ok(self.weight)

        def neighbor_data(offset):
            keys = vbh.pack_block_keys(coords + trace.upload(offset, dev, "mesh.offsets", torch.int32))
            slots, found = self.find_block_slots(keys)
            slots = slots.long()
            return self.tsdf[slots], weight_ok(self.weight[slots]) & found[:, None, None, None]

        nt, nv = neighbor_data([1, 0, 0])
        tsdf_p[:, r, :r, :r] = nt[:, 0]
        valid_p[:, r, :r, :r] = nv[:, 0]
        nt, nv = neighbor_data([0, 1, 0])
        tsdf_p[:, :r, r, :r] = nt[:, :, 0]
        valid_p[:, :r, r, :r] = nv[:, :, 0]
        nt, nv = neighbor_data([0, 0, 1])
        tsdf_p[:, :r, :r, r] = nt[:, :, :, 0]
        valid_p[:, :r, :r, r] = nv[:, :, :, 0]
        nt, nv = neighbor_data([1, 1, 0])
        tsdf_p[:, r, r, :r] = nt[:, 0, 0, :r]
        valid_p[:, r, r, :r] = nv[:, 0, 0, :r]
        nt, nv = neighbor_data([1, 0, 1])
        tsdf_p[:, r, :r, r] = nt[:, 0, :r, 0]
        valid_p[:, r, :r, r] = nv[:, 0, :r, 0]
        nt, nv = neighbor_data([0, 1, 1])
        tsdf_p[:, :r, r, r] = nt[:, :r, 0, 0]
        valid_p[:, :r, r, r] = nv[:, :r, 0, 0]
        nt, nv = neighbor_data([1, 1, 1])
        tsdf_p[:, r, r, r] = nt[:, 0, 0, 0]
        valid_p[:, r, r, r] = nv[:, 0, 0, 0]
        valid_p = valid_p & self.occupied_mask()[:, None, None, None]
        return tsdf_p, valid_p

    def extract_triangle_soup(
        self, max_triangles: int = 200_000, weight_threshold: float = 0.0, method: str = "cubes"
    ):
        """Zero-isosurface triangle soup f32[max_triangles, 3, 3] + count, by
        marching cubes (``method="cubes"``) or marching tetrahedra
        (``"tetrahedra"``: the same isosurface, a denser soup)."""
        tsdf_p, valid_p = self._stitched_volumes(weight_threshold)
        origins = self.block_coordinates().to(torch.float32) * self.block_side()
        kernel = marching_cubes if method == "cubes" else marching_tetrahedra
        return kernel(tsdf_p, valid_p, origins, self.voxel_size, max_triangles)

    def extract_triangle_mesh(
        self, max_triangles: int = 200_000, max_vertices: int | None = None,
        weight_threshold: float = 0.0,
    ):
        """Welded mesh: soup vertices quantized to a 1e-6 m grid and
        deduplicated (``torch.unique`` sorts lexicographically, as the JAX
        package's fixed-size ``jnp.unique`` does).

        Returns vertices f32[max_vertices, 3] (0-padded), faces
        int32[max_triangles, 3], vertex_count, triangle_count.
        """
        if max_vertices is None:
            max_vertices = max_triangles * 3 // 2 + 2
        soup, tri_count = self.extract_triangle_soup(max_triangles, weight_threshold)
        verts = soup.reshape(-1, 3)
        tri_valid = torch.arange(max_triangles, device=self.device) < tri_count
        sentinel = 2**31 - 1
        q = torch.round(verts / 1e-6).to(torch.int32)
        q = torch.where(tri_valid.repeat_interleave(3)[:, None], q, sentinel)
        with trace.blocking("volume.unique"):
            uq, inv = torch.unique(q, dim=0, return_inverse=True)
        # fixed size max_vertices + 1, padded with the sentinel row (which
        # sorts last); ids past the size clamp to the last row
        size = max_vertices + 1
        inv = torch.clamp(inv, max=size - 1)
        vertex_count = torch.sum(torch.any(uq[:size] != sentinel, dim=1))
        # duplicates keep the LAST soup vertex, as the JAX scatter does
        last = torch.full((size,), -1, dtype=torch.int64, device=self.device)
        last.scatter_reduce_(0, inv, torch.arange(inv.shape[0], device=self.device), "amax")
        vertices = torch.where((last >= 0)[:, None], verts[last.clamp(min=0)], 0.0)
        faces = inv.reshape(max_triangles, 3).to(torch.int32)
        return vertices[:max_vertices], faces, vertex_count, tri_count


    # -- TSDF sampling & ray casting --------------------------------------------

    def _trilinear_taps(self, points: torch.Tensor):
        """The 8 voxels around each world point f32[N, 3] (voxel centers at
        ``index * voxel_size``): (slots int64[N * 8], local voxel int64[N * 8, 3],
        found bool[N * 8], trilinear weights f32[N, 8])."""
        r = self.block_resolution
        vc = points / self.voxel_size
        base = torch.floor(vc).to(torch.int32)
        frac = vc - base
        offsets = _unit_cube_corners(self.device)
        idx = base[:, None, :] + offsets[None]  # [N, 8, 3]
        block = torch.div(idx, r, rounding_mode="floor")
        local = (idx - block * r).reshape(-1, 3).long()
        slots, found = self.find_block_slots(vbh.pack_block_keys(block.reshape(-1, 3)))
        f = frac[:, None, :]
        o = offsets[None].to(torch.float32)
        weights = torch.prod(o * f + (1.0 - o) * (1.0 - f), dim=-1)
        return slots.long(), local, found, weights

    def sample_tsdf(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Trilinear TSDF sample at world points f32[N, 3] -> (value f32[N],
        valid bool[N]); valid needs all 8 surrounding voxels observed
        (weight > 0)."""
        slots, local, found, weights = self._trilinear_taps(points)
        t = self.tsdf[slots, local[:, 0], local[:, 1], local[:, 2]].reshape(-1, 8)
        w = self.weight[slots, local[:, 0], local[:, 1], local[:, 2]]
        observed = (found & (w > 0)).reshape(-1, 8)
        return torch.sum(weights * t, dim=-1), torch.all(observed, dim=-1)

    def sample_color(self, points: torch.Tensor) -> torch.Tensor:
        """Trilinear color sample at world points f32[N, 3] -> f32[N, 3]
        (voxels of unallocated blocks count as black)."""
        slots, local, found, weights = self._trilinear_taps(points)
        c = self.color[slots, local[:, 0], local[:, 1], local[:, 2]].reshape(-1, 8, 3)
        c = torch.where(found.reshape(-1, 8, 1), c, 0.0)
        return torch.sum(weights[..., None] * c, dim=1)

    def ray_cast(
        self,
        intrinsics,
        extrinsics,
        width: int,
        height: int,
        depth_min: float = 0.1,
        with_normals: bool = False,
        with_color: bool = False,
    ) -> dict:
        """TSDF ray marching: a coarse march at half the truncation distance
        from ``depth_min`` to the volume's ``depth_max`` (a fixed step count)
        to the first positive -> non-positive crossing between two observed
        samples, then one secant step between them. ``extrinsics`` maps
        world to camera (None: the camera is the world frame).

        Returns ``depth`` f32[H, W] (camera-space z, 0 = miss), ``points``
        f32[H, W, 3] world hits, ``mask`` bool[H, W], and with the options
        ``normals`` (the normalized TSDF gradient) and ``colors``. Issues no
        host sync: the march is a Python loop over tensors.
        """
        dev = self.device
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
        fx, fy = intrinsics[0, 0], intrinsics[1, 1]
        cx, cy = intrinsics[0, 2], intrinsics[1, 2]
        v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
        u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
        # z-normalized directions: the march parameter is camera-space depth
        dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1).reshape(-1, 3)
        if extrinsics is not None:
            cam_to_world = torch.linalg.inv_ex(torch.as_tensor(extrinsics, dtype=torch.float32, device=dev))[0]
            origin = cam_to_world[:3, 3]
            dirs = dirs @ cam_to_world[:3, :3].T
        else:
            origin = torch.zeros(3, dtype=torch.float32, device=dev)

        # the step and each sample's depth in f32, as the JAX scan computes them
        step = np.float32(0.5 * self.sdf_truncation_distance)
        n_steps = int(math.ceil((self.depth_max - depth_min) / (0.5 * self.sdf_truncation_distance))) + 1
        n_rays = dirs.shape[0]
        prev_val = torch.zeros(n_rays, dtype=torch.float32, device=dev)
        prev_valid = torch.zeros(n_rays, dtype=torch.bool, device=dev)
        hit_t = torch.zeros(n_rays, dtype=torch.float32, device=dev)
        found = torch.zeros(n_rays, dtype=torch.bool, device=dev)
        for i in range(n_steps):
            t = np.float32(depth_min) + np.float32(i) * step
            val, valid = self.sample_tsdf(origin[None] + float(t) * dirs)
            crossing = prev_valid & valid & (prev_val > 0.0) & (val <= 0.0) & ~found
            denom = torch.where(torch.abs(prev_val - val) > 1e-12, prev_val - val, 1.0)
            t_hit = float(t - step) + float(step) * prev_val / denom
            hit_t = torch.where(crossing, t_hit, hit_t)
            found = found | crossing
            prev_val, prev_valid = val, valid
        points = origin[None] + hit_t[:, None] * dirs
        result = {
            "depth": torch.where(found, hit_t, 0.0).reshape(height, width),
            "points": points.reshape(height, width, 3),
            "mask": found.reshape(height, width),
        }
        if with_normals:
            offsets = torch.eye(3, dtype=torch.float32, device=dev) * self.voxel_size
            g = torch.stack(
                [self.sample_tsdf(points + offsets[a])[0] - self.sample_tsdf(points - offsets[a])[0] for a in range(3)],
                dim=-1,
            )
            n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
            result["normals"] = torch.where(found[:, None], n, 0.0).reshape(height, width, 3)
        if with_color:
            c = self.sample_color(points)
            result["colors"] = torch.where(found[:, None], c, 0.0).reshape(height, width, 3)
        return result

    def extract_voxel_values_at(self, voxel_coords: torch.Tensor):
        """tsdf, weight and found at global integer voxel coordinates
        int32[N, 3] (zeros where the block is not allocated)."""
        r = self.block_resolution
        block = torch.div(voxel_coords, r, rounding_mode="floor")
        local = (voxel_coords - block * r).long()
        slots, found = self.find_block_slots(vbh.pack_block_keys(block))
        slots = slots.long()
        t = self.tsdf[slots, local[:, 0], local[:, 1], local[:, 2]]
        w = self.weight[slots, local[:, 0], local[:, 1], local[:, 2]]
        return torch.where(found, t, 0.0), torch.where(found, w, 0.0), found


def extract_mesh_fitter_arrays(volume: VoxelBlockGrid, v_cap: int, t_cap: int, weight_threshold: float):
    """Welded canonical mesh padded into the fitter's static-capacity arrays.

    Returns (vertices f32[v_cap, 3], faces int32[t_cap, 3], vertex_count,
    triangle_count). Slot ``v_cap - 1`` is the reserved padding vertex at the
    origin (z = 0, culled by the near plane); padded, weld-overflow and
    degenerate (repeated-index) faces are dropped and the rest compacted to
    the front.
    """
    dev = volume.device
    verts, faces, v_count, t_count = volume.extract_triangle_mesh(
        max_triangles=t_cap, max_vertices=v_cap - 1, weight_threshold=weight_threshold
    )
    vr = torch.arange(v_cap - 1, device=dev)
    verts = torch.where((vr < v_count)[:, None], verts, 0.0)
    vertices = torch.cat([verts, torch.zeros((1, 3), dtype=verts.dtype, device=dev)])
    tri_valid = torch.arange(t_cap, device=dev) < t_count
    faces = torch.clamp(faces, 0, v_cap - 1)
    overflow = faces >= torch.clamp(v_count, max=v_cap - 1)
    faces = torch.where(tri_valid[:, None] & ~overflow, faces, v_cap - 1)
    degenerate = (
        (faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2]) | (faces[:, 0] == faces[:, 2])
    )
    keep = tri_valid & ~degenerate
    keep_ids, kept_count = compact_mask_indices(keep, t_cap, fill_value=t_cap)
    faces = torch.where(
        (torch.arange(t_cap, device=dev) < kept_count)[:, None],
        faces[torch.clamp(keep_ids, max=t_cap - 1)],
        v_cap - 1,
    ).to(torch.int32)
    return vertices, faces, v_count, kept_count
