"""Training pairs for DeformNet (port of
``dynamicfuion_python_tpu/data/deform_dataset.py``).

A DeepDeform frame pair becomes a sample of numpy arrays: source and target
rgbxyz images, ground-truth optical flow and scene flow with their masks, the
deformation graph (nodes, edges, edge weights, clusters, padded to a static
node count), per-pixel anchors and weights, and the intrinsics. Batches are
stacked numpy arrays; the training step moves them to its device.

``DeformDataset`` builds each source frame's graph from its depth
(``build_graph_for_frame``, the generator of ``apps/create_graph_data.py``);
``LabeledDeformDataset`` reads the graphs that generator wrote, listed in a
labels JSON, and center-crops to a static size. Images are read without
Pillow (``data/images.py``) unless a colour frame is a JPEG.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench.reference.data import io as blob_io
from portbench.reference.data.camera import load_intrinsics_txt
from portbench.reference.data.images import load_color, load_depth, resize_bilinear, resize_nearest
from portbench.reference.ops.graph_construction import (
    compute_edges_shortest_path,
    mesh_from_depth_image,
    sample_nodes,
    vertex_erosion_mask,
)


@dataclass
class DeformPair:
    source: np.ndarray  # f32[H, W, 6]
    target: np.ndarray  # f32[H, W, 6]
    flow_gt: np.ndarray | None  # f32[H, W, 2]
    flow_mask: np.ndarray | None  # bool[H, W]
    scene_flow_gt: np.ndarray | None  # f32[H, W, 3]
    scene_flow_mask: np.ndarray | None  # bool[H, W]
    graph_nodes: np.ndarray  # f32[N, 3] (padded)
    graph_edges: np.ndarray  # int32[N, Ke]
    graph_edges_weights: np.ndarray  # f32[N, Ke]
    graph_clusters: np.ndarray  # int32[N]
    pixel_anchors: np.ndarray  # int32[H, W, 4]
    pixel_weights: np.ndarray  # f32[H, W, 4]
    num_nodes: int
    intrinsics: np.ndarray  # f32[3, 3]


def _rgbxyz(color: np.ndarray, depth: np.ndarray, intrinsics: np.ndarray, depth_scale=1000.0, depth_max=6.0) -> np.ndarray:
    """Colour in [0, 1] and camera-space points, f32[H, W, 6]; depths
    outside (0, depth_max] metres are 0."""
    h, w = depth.shape
    z = depth.astype(np.float32) / depth_scale
    z[(z <= 0) | (z > depth_max)] = 0.0
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    out = np.zeros((h, w, 6), np.float32)
    out[..., :3] = color.astype(np.float32) / 255.0
    out[..., 3] = (u - cx) / fx * z
    out[..., 4] = (v - cy) / fy * z
    out[..., 5] = z
    return out


def build_graph_for_frame(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    node_coverage: float = 0.05,
    max_neighbor_count: int = 8,
    erosion_iterations: int = 4,
    erosion_min_neighbors: int = 4,
    anchor_count: int = 4,
    depth_scale: float = 1000.0,
    depth_max: float = 6.0,
    return_node_pixels: bool = False,
):
    """Depth frame -> (nodes, edges, edge weights, clusters, pixel anchors,
    pixel weights): the depth image's mesh, eroded; nodes sampled at
    ``node_coverage``; geodesic edges; connected-component clusters; each
    valid pixel anchored to its K Euclidean-nearest nodes within
    2 * node_coverage, Gaussian weights normalized.

    With ``return_node_pixels`` a 7th element i32[N, 2] holds each node's
    source pixel (row, column)."""
    from scipy.spatial import cKDTree

    from portbench.reference.models.warp_field import compute_clusters

    h, w = depth.shape
    z = depth.astype(np.float32) / depth_scale
    z[(z <= 0) | (z > depth_max)] = 0.0
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    points = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    verts, vert_pixels, faces = mesh_from_depth_image(points, max_triangle_edge_distance=2 * node_coverage)
    if len(verts) == 0:
        raise ValueError("no valid geometry in depth frame")
    erosion = vertex_erosion_mask(verts, faces, erosion_iterations, erosion_min_neighbors)
    nodes, node_vertex_idx = sample_nodes(verts, erosion, node_coverage, use_only_non_eroded=bool(erosion.any()))
    edges, edge_weights, _, _ = compute_edges_shortest_path(
        verts, faces, node_vertex_idx, max_neighbor_count, node_coverage, enforce_total_num_neighbors=False
    )
    clusters = compute_clusters(edges)

    anchors = np.full((h, w, anchor_count), -1, np.int32)
    weights = np.zeros((h, w, anchor_count), np.float32)
    valid = z > 0
    k = min(anchor_count, len(nodes))
    dist, idx = cKDTree(nodes).query(points[valid], k=k)
    dist = dist.reshape(-1, k)
    idx = idx.reshape(-1, k)
    wts = np.exp(-(dist**2) / (2 * node_coverage**2))
    keep = dist <= 2 * node_coverage
    wts = np.where(keep, wts, 0.0)
    sums = wts.sum(1, keepdims=True)
    wts = np.where(sums > 0, wts / np.maximum(sums, 1e-30), 0.0)
    anchors[valid, :k] = np.where(keep, idx, -1).astype(np.int32)
    weights[valid, :k] = wts.astype(np.float32)
    if return_node_pixels:
        return nodes, edges, edge_weights, clusters, anchors, weights, vert_pixels[node_vertex_idx]
    return nodes, edges, edge_weights, clusters, anchors, weights


def _pad_graph(nodes, edges, edge_w, clusters, max_nodes: int, max_neighbors: int):
    """Graph arrays padded to ``max_nodes`` rows (edges -1, clusters -1) and
    ``max_neighbors`` columns; longer neighbor lists are cut."""
    n = len(nodes)
    if n > max_nodes:
        raise ValueError(f"graph has {n} nodes > max_nodes={max_nodes}; increase max_nodes or node_coverage")
    pad = max_nodes - n
    edges, edge_w = edges[:, :max_neighbors], edge_w[:, :max_neighbors]
    ke = edges.shape[1]
    return (
        np.pad(nodes, ((0, pad), (0, 0))).astype(np.float32),
        np.pad(edges, ((0, pad), (0, max_neighbors - ke)), constant_values=-1).astype(np.int32),
        np.pad(edge_w, ((0, pad), (0, max_neighbors - ke))).astype(np.float32),
        np.pad(np.asarray(clusters).reshape(-1), (0, pad), constant_values=-1).astype(np.int32),
    )


class DeformDataset:
    """DeepDeform-layout frame pairs under a split root:
    ``<root>/<seq>/{color,depth,optical_flow,scene_flow}/`` with
    ``<seq>/intrinsics.txt``; one pair per ``optical_flow/*_<src>_<tgt>.oflow``.
    Images are resized to ``image_size`` when given (depth and flows
    nearest, colour bilinear, flow magnitudes scaled)."""

    def __init__(
        self,
        split_root: str | Path,
        max_nodes: int = 128,
        max_neighbors: int = 8,
        node_coverage: float = 0.05,
        image_size: tuple[int, int] | None = None,
    ):
        self.split_root = Path(split_root)
        self.max_nodes = max_nodes
        self.max_neighbors = max_neighbors
        self.node_coverage = node_coverage
        self.image_size = image_size
        self.pairs: list[tuple[Path, str, str, Path | None, Path | None]] = []
        for seq_dir in sorted(self.split_root.iterdir()):
            flow_dir = seq_dir / "optical_flow"
            if not flow_dir.is_dir():
                continue
            for flow_file in sorted(flow_dir.glob("*.oflow")):
                parts = flow_file.stem.split("_")
                src_id, tgt_id = parts[-2], parts[-1]
                sflow = seq_dir / "scene_flow" / flow_file.with_suffix(".sflow").name
                self.pairs.append((seq_dir, src_id, tgt_id, flow_file, sflow if sflow.exists() else None))

    def __len__(self):
        return len(self.pairs)

    def pair_name(self, index: int) -> str:
        seq_dir, src_id, tgt_id, _, _ = self.pairs[index]
        return f"{seq_dir.name}_{src_id}_{tgt_id}"

    def _load_images(self, seq_dir: Path, frame_id: str):
        depth = load_depth(seq_dir / "depth" / f"{frame_id}.png")
        color_path = seq_dir / "color" / f"{frame_id}.jpg"
        if not color_path.exists():
            color_path = seq_dir / "color" / f"{frame_id}.png"
        color = load_color(color_path)
        if self.image_size is not None:
            depth = resize_nearest(depth, self.image_size)
            color = resize_bilinear(color, self.image_size)
        return color, depth

    def _scaled_intrinsics(self, intrinsics: np.ndarray, native_hw) -> np.ndarray:
        if self.image_size is None:
            return intrinsics
        out = intrinsics.copy()
        out[0] *= self.image_size[1] / native_hw[1]
        out[1] *= self.image_size[0] / native_hw[0]
        return out

    def __getitem__(self, index: int) -> DeformPair:
        seq_dir, src_id, tgt_id, oflow, sflow = self.pairs[index]
        intrinsics = load_intrinsics_txt(seq_dir / "intrinsics.txt")
        src_color, src_depth = self._load_images(seq_dir, src_id)
        tgt_color, tgt_depth = self._load_images(seq_dir, tgt_id)

        flow_gt = flow_mask = scene_flow = None
        native_hw = None
        if oflow is not None:
            flow_gt = np.moveaxis(blob_io.load_flow_binary(oflow), 0, -1)
            native_hw = flow_gt.shape[:2]
        if sflow is not None:
            scene_flow = np.moveaxis(blob_io.load_flow_binary(sflow), 0, -1)
            native_hw = native_hw or scene_flow.shape[:2]
        if native_hw is not None:
            intrinsics = self._scaled_intrinsics(intrinsics, native_hw)

        source = _rgbxyz(src_color, src_depth, intrinsics)
        target = _rgbxyz(tgt_color, tgt_depth, intrinsics)
        resize = self.image_size is not None

        if flow_gt is not None:
            if resize and flow_gt.shape[:2] != tuple(self.image_size):
                (h, w), (oh, ow) = self.image_size, flow_gt.shape[:2]
                channels = [resize_nearest(np.ascontiguousarray(flow_gt[..., c]), (h, w)) for c in range(2)]
                flow_gt = np.stack(channels, -1) * np.asarray([w / ow, h / oh], np.float32)
            flow_mask = np.isfinite(flow_gt).all(-1) & (source[..., 5] > 0)
            flow_gt = np.nan_to_num(flow_gt, nan=0.0, posinf=0.0, neginf=0.0)
        scene_flow_mask = None
        if scene_flow is not None:
            if resize and scene_flow.shape[:2] != tuple(self.image_size):
                scene_flow = np.stack(
                    [resize_nearest(np.ascontiguousarray(scene_flow[..., c]), self.image_size) for c in range(3)], -1
                )
            scene_flow_mask = np.isfinite(scene_flow).all(-1) & (source[..., 5] > 0)
            scene_flow = np.nan_to_num(scene_flow, nan=0.0, posinf=0.0, neginf=0.0)

        nodes, edges, edge_w, clusters, anchors, weights = build_graph_for_frame(
            src_depth, intrinsics, self.node_coverage, self.max_neighbors
        )
        nodes_p, edges_p, edge_w_p, clusters_p = _pad_graph(
            nodes, edges, edge_w, clusters, self.max_nodes, self.max_neighbors
        )
        return DeformPair(
            source=source, target=target, flow_gt=flow_gt, flow_mask=flow_mask,
            scene_flow_gt=scene_flow, scene_flow_mask=scene_flow_mask,
            graph_nodes=nodes_p, graph_edges=edges_p, graph_edges_weights=edge_w_p, graph_clusters=clusters_p,
            pixel_anchors=anchors, pixel_weights=weights, num_nodes=len(nodes), intrinsics=intrinsics,
        )

    def batch(self, indices) -> dict:
        """The samples stacked along a new first axis."""
        return _collate([self[i] for i in indices])


class StaticCenterCrop:
    """Center crop to a fixed size (DeformNet's inputs must have sides
    divisible by 64)."""

    def __init__(self, image_hw: tuple[int, int], crop_hw: tuple[int, int]):
        self.h, self.w = image_hw
        self.th, self.tw = crop_hw
        if self.th > self.h or self.tw > self.w:
            raise ValueError(f"crop {crop_hw} larger than image {image_hw}")

    def __call__(self, img: np.ndarray) -> np.ndarray:
        y0 = (self.h - self.th) // 2
        x0 = (self.w - self.tw) // 2
        return img[y0 : y0 + self.th, x0 : x0 + self.tw]

    def adjust_intrinsics(self, intrinsics: np.ndarray) -> np.ndarray:
        """The principal point shifted by half the cropped size."""
        out = np.asarray(intrinsics, np.float32).copy()
        out[0, 2] -= (self.w - self.tw) / 2
        out[1, 2] -= (self.h - self.th) / 2
        return out


class LabeledDeformDataset:
    """Pairs listed in ``<base>/<labels_filename>.json``: per pair the paths
    (relative to ``base``) of its colour and depth frames, ground-truth
    optical and scene flow, and the graph blobs ``apps/create_graph_data.py``
    wrote (nodes, edges, edge weights, clusters, optional node deformations,
    pixel anchors and weights), plus its intrinsics ``{fx, fy, cx, cy}``.
    Images and per-pixel arrays are center-cropped to ``input_size``; the
    target's point-jump boundary mask comes with each sample."""

    def __init__(
        self,
        dataset_base_dir: str | Path,
        labels_filename: str,
        input_size: tuple[int, int] = (448, 640),
        max_boundary_distance: float = 0.1,
        max_nodes: int = 128,
        max_neighbors: int = 8,
        depth_scale: float = 1000.0,
        depth_max: float = 6.0,
    ):
        self.base = Path(dataset_base_dir)
        self.input_size = tuple(input_size)
        self.max_boundary_distance = float(max_boundary_distance)
        self.max_nodes = max_nodes
        self.max_neighbors = max_neighbors
        self.depth_scale = depth_scale
        self.depth_max = depth_max
        self.labels = json.loads((self.base / f"{labels_filename}.json").read_text())

    def __len__(self):
        return len(self.labels)

    def get_metadata(self, index: int) -> dict:
        return self.labels[index]

    def pair_name(self, index: int) -> str:
        """<sequence>_<source>_<target>, from the optical-flow file's path
        (``<sequence>/optical_flow/<...>_<source>_<target>.oflow``)."""
        flow = Path(self.labels[index]["optical_flow"])
        parts = flow.stem.split("_")
        return f"{flow.parent.parent.name}_{parts[-2]}_{parts[-1]}"

    def _load_rgbxyz(self, color_path, depth_path, intrinsics, cropper):
        color = load_color(self.base / color_path)
        depth = load_depth(self.base / depth_path)
        if cropper is None:
            cropper = StaticCenterCrop(depth.shape[:2], self.input_size)
        return cropper(_rgbxyz(color, depth, intrinsics, self.depth_scale, self.depth_max)), cropper

    def __getitem__(self, index: int) -> DeformPair:
        import torch

        from portbench.reference.ops.image_proc_extras import compute_boundary_mask_points

        data = self.labels[index]
        intr = data["intrinsics"]
        intrinsics = np.asarray([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]], np.float32)
        source, cropper = self._load_rgbxyz(data["source_color"], data["source_depth"], intrinsics, None)
        target, _ = self._load_rgbxyz(data["target_color"], data["target_depth"], intrinsics, cropper)
        boundary = compute_boundary_mask_points(
            torch.from_numpy(np.ascontiguousarray(target[..., 3:])), self.max_boundary_distance
        ).numpy()

        def flow_and_mask(key):
            flow = cropper(np.moveaxis(blob_io.load_flow_binary(self.base / data[key]), 0, -1))
            mask = np.isfinite(flow).all(-1)
            return np.nan_to_num(flow, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32), mask

        flow_gt, flow_mask = flow_and_mask("optical_flow")
        scene_flow_gt, scene_flow_mask = flow_and_mask("scene_flow")
        nodes = blob_io.load_graph_nodes(self.base / data["graph_nodes"])
        edges = blob_io.load_graph_edges(self.base / data["graph_edges"])
        edge_w = blob_io.load_graph_edges_weights(self.base / data["graph_edges_weights"])
        clusters = blob_io.load_graph_clusters(self.base / data["graph_clusters"]).reshape(-1)
        anchors = cropper(blob_io.load_int_image(self.base / data["pixel_anchors"])).astype(np.int32)
        weights = cropper(blob_io.load_float_image(self.base / data["pixel_weights"])).astype(np.float32)
        nodes_p, edges_p, edge_w_p, clusters_p = _pad_graph(
            nodes, edges, edge_w, clusters, self.max_nodes, self.max_neighbors
        )
        pair = DeformPair(
            source=source, target=target, flow_gt=flow_gt, flow_mask=flow_mask,
            scene_flow_gt=scene_flow_gt, scene_flow_mask=scene_flow_mask,
            graph_nodes=nodes_p, graph_edges=edges_p, graph_edges_weights=edge_w_p, graph_clusters=clusters_p,
            pixel_anchors=anchors, pixel_weights=weights, num_nodes=len(nodes),
            intrinsics=cropper.adjust_intrinsics(intrinsics),
        )
        pair.target_boundary_mask = boundary
        if data.get("graph_node_deformations"):
            deformations = blob_io.load_graph_node_deformations(self.base / data["graph_node_deformations"])
            pair.node_deformations = np.pad(deformations, ((0, self.max_nodes - len(nodes)), (0, 0))).astype(np.float32)
        return pair

    def batch(self, indices) -> dict:
        samples = [self[i] for i in indices]
        out = _collate(samples)
        out["target_boundary_mask"] = np.stack([s.target_boundary_mask for s in samples])
        if all(hasattr(s, "node_deformations") for s in samples):
            out["node_deformations"] = np.stack([s.node_deformations for s in samples])
        return out


def _collate(samples) -> dict:
    """Stack the samples' arrays; ``num_nodes`` int32[B]; the flows only
    when every sample has them."""
    keys = ("source", "target", "graph_nodes", "graph_edges", "graph_edges_weights", "graph_clusters",
            "pixel_anchors", "pixel_weights", "intrinsics")
    out = {key: np.stack([getattr(s, key) for s in samples]) for key in keys}
    out["num_nodes"] = np.asarray([s.num_nodes for s in samples], np.int32)
    if all(s.flow_gt is not None for s in samples):
        out["flow_gt"] = np.stack([s.flow_gt for s in samples])
        out["flow_mask"] = np.stack([s.flow_mask for s in samples])
    if all(s.scene_flow_gt is not None for s in samples):
        out["scene_flow_gt"] = np.stack([s.scene_flow_gt for s in samples])
        out["scene_flow_mask"] = np.stack([s.scene_flow_mask for s in samples])
    return out
