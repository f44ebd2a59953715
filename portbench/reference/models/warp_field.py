"""Embedded-deformation graph warp fields (port of
``dynamicfuion_python_tpu/models/warp_field.py``: ``WarpField``,
``GraphWarpField`` with ``compute_clusters``, and
``HierarchicalGraphWarpField``).

Warp fields are small dataclasses holding tensors on one device; state
updates return new instances (``dataclasses.replace``). Hierarchy
construction runs host-side in numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import numpy as np
import torch

from portbench.reference.ops.anchors import compute_anchors_euclidean
from portbench.reference.ops.knn import knn
from portbench.reference.ops.linalg import axis_angle_to_matrix
from portbench.reference.ops.warp import blend_warp
from portbench.reference.utils.device import resolve_device


class NodeCoverageMethod(enum.Enum):
    FIXED = 0
    MINIMAL_K_NEIGHBOR_NODE_DISTANCE = 1


@dataclasses.dataclass(frozen=True)
class WarpField:
    """N nodes with blended rigid transforms."""

    node_positions: torch.Tensor  # f32[N, 3]
    node_rotations: torch.Tensor  # f32[N, 3, 3]
    node_translations: torch.Tensor  # f32[N, 3]
    # squared per-node coverage; coverage^2 broadcast for FIXED
    node_coverage_weights_squared: torch.Tensor  # f32[N]
    node_coverage: float = 0.05
    anchor_count: int = 4
    minimum_valid_anchor_count: int = 0
    threshold_nodes_by_distance: bool = False
    coverage_method: NodeCoverageMethod = NodeCoverageMethod.MINIMAL_K_NEIGHBOR_NODE_DISTANCE

    @classmethod
    def create(
        cls,
        node_positions,
        node_coverage: float = 0.05,
        anchor_count: int = 4,
        minimum_valid_anchor_count: int = 0,
        threshold_nodes_by_distance: bool = False,
        coverage_method: NodeCoverageMethod = NodeCoverageMethod.MINIMAL_K_NEIGHBOR_NODE_DISTANCE,
        device: str | torch.device | None = None,
        **extra,
    ):
        """A field of identity transforms on ``device`` (the CUDA card unless
        the caller passes ``device="cpu"``)."""
        device = resolve_device(device)
        node_positions = torch.as_tensor(node_positions, dtype=torch.float32, device=device)
        n = node_positions.shape[0]
        eye = torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3).contiguous()
        zeros = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return cls(
            node_positions=node_positions,
            node_rotations=eye,
            node_translations=zeros,
            node_coverage_weights_squared=_coverage_weights_squared(
                node_positions, node_coverage, coverage_method
            ),
            node_coverage=float(node_coverage),
            anchor_count=int(anchor_count),
            minimum_valid_anchor_count=int(minimum_valid_anchor_count),
            threshold_nodes_by_distance=bool(threshold_nodes_by_distance),
            coverage_method=coverage_method,
            **extra,
        )

    @property
    def num_nodes(self) -> int:
        return self.node_positions.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_positions.device

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device: str | torch.device):
        """The same field with every tensor on ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    def compute_anchors(self, points: torch.Tensor):
        """K-NN anchors + weights for arbitrary points (see ops.anchors)."""
        return compute_anchors_euclidean(
            points,
            self.node_positions,
            self.anchor_count,
            node_coverage_squared=self.node_coverage_weights_squared,
            minimum_valid_anchor_count=self.minimum_valid_anchor_count,
            use_threshold=self.threshold_nodes_by_distance,
        )

    def warp_points(self, points: torch.Tensor) -> torch.Tensor:
        """Points f32[P, 3] warped by the blended node transforms."""
        anchors, weights, _ = self.compute_anchors(points)
        return blend_warp(
            points, self.node_positions, self.node_rotations, self.node_translations, anchors, weights
        )

    def rotate_nodes(self, rotation_deltas: torch.Tensor) -> "WarpField":
        """R <- dR R; ``rotation_deltas`` f32[N, 3, 3] or axis-angle f32[N, 3]."""
        if rotation_deltas.ndim == 2:
            rotation_deltas = axis_angle_to_matrix(rotation_deltas)
        new_rot = torch.einsum("nab,nbc->nac", rotation_deltas, self.node_rotations)
        return self.replace(node_rotations=new_rot)

    def translate_nodes(self, translation_deltas: torch.Tensor) -> "WarpField":
        return self.replace(node_translations=self.node_translations + translation_deltas)

    def get_warped_nodes(self) -> torch.Tensor:
        return self.node_positions + self.node_translations

    def apply_transformations(self, rotations: torch.Tensor, translations: torch.Tensor) -> "WarpField":
        """The same field with its node transforms replaced."""
        return self.replace(node_rotations=rotations, node_translations=translations)

    def reset_rotations(self) -> "WarpField":
        eye = torch.eye(3, dtype=torch.float32, device=self.device).expand(self.node_rotations.shape)
        return self.replace(node_rotations=eye.contiguous())

    def clone(self) -> "WarpField":
        """A copy whose tensors share no storage with this field's."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).clone()
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def _coverage_weights_squared(node_positions, node_coverage, method):
    """FIXED: coverage^2 broadcast. VARIABLE: squared distance to the nearest
    other node (single-node fields fall back to coverage)."""
    n = node_positions.shape[0]
    if method == NodeCoverageMethod.FIXED or n == 1:
        base = node_coverage**2 if method == NodeCoverageMethod.FIXED else node_coverage
        return torch.full((n,), float(np.float32(base)), dtype=torch.float32, device=node_positions.device)
    d2, _ = knn(node_positions, node_positions, 2)
    return d2[:, 1].contiguous()


@dataclasses.dataclass(frozen=True)
class GraphWarpField(WarpField):
    """Flat graph warp field: the nodes plus their -1-padded neighbor lists
    ``edges`` int32[N, Ke], ``edge_weights`` f32[N, Ke] and the
    connected-component label of each node, ``clusters`` int32[N]."""

    edges: torch.Tensor = None
    edge_weights: torch.Tensor = None
    clusters: torch.Tensor = None

    @classmethod
    def from_graph(cls, nodes, edges, edge_weights=None, clusters=None, device=None, **kwargs) -> "GraphWarpField":
        """A field of identity transforms on ``device`` (the CUDA card unless
        the caller passes ``device="cpu"``); edge weights default to 1 per
        edge, clusters to the connected components of ``edges``."""
        device = resolve_device(device)
        edges_np = np.asarray(edges.cpu() if isinstance(edges, torch.Tensor) else edges, np.int32)
        if edge_weights is None:
            edge_weights = np.where(edges_np >= 0, 1.0, 0.0).astype(np.float32)
        if clusters is None:
            clusters = compute_clusters(edges_np)
        return cls.create(
            nodes,
            edges=torch.as_tensor(edges_np, device=device),
            edge_weights=torch.as_tensor(edge_weights, dtype=torch.float32, device=device),
            clusters=torch.as_tensor(clusters, dtype=torch.int32, device=device),
            device=device,
            **kwargs,
        )


def compute_clusters(edges: np.ndarray) -> np.ndarray:
    """Connected-component label int32[N] of each node over -1-padded
    neighbor lists: host-side union-find, the smaller root wins, labels
    numbered in root order."""
    n = edges.shape[0]
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for i in range(n):
        for j in edges[i]:
            if j >= 0:
                ri, rj = find(i), find(int(j))
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([find(i) for i in range(n)], np.int64)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class HierarchicalGraphWarpField(WarpField):
    """Multi-resolution regularization hierarchy over the nodes.

    Layer 0 starts as all nodes; each coarser layer median-grid-subsamples
    the finer one at cell 2 * decimation_radius and the picked nodes move up
    (layers are disjoint). ``virtual_node_indices`` lists original node
    indices in fine-to-coarse order ("virtual ordering"); each finer-layer
    node gets up to ``max_vertex_degree`` KNN edges into the next-coarser
    layer, in virtual indices; the arrow base is the layer-0 node count.
    """

    virtual_node_indices: torch.Tensor = None  # int32[N]
    edges: torch.Tensor = None  # int32[E, 2] (fine virtual, coarse virtual)
    edge_layer_indices: torch.Tensor = None  # int8[E]
    layer_node_counts: tuple = ()
    layer_decimation_radii: tuple = ()

    @classmethod
    def build(
        cls,
        node_positions: np.ndarray,
        node_coverage: float = 0.05,
        layer_count: int = 4,
        max_vertex_degree: int = 4,
        compute_layer_decimation_radius: Callable[[int, float], float] | None = None,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "HierarchicalGraphWarpField":
        device = resolve_device(device)
        if compute_layer_decimation_radius is None:
            def compute_layer_decimation_radius(i, cov):
                return float(i + 1) * cov

        positions = np.asarray(node_positions, np.float32)
        n = positions.shape[0]
        layer_members: list[np.ndarray] = [np.arange(n)]
        radii = [float(node_coverage)]
        for i_layer in range(1, layer_count):
            finer = layer_members[i_layer - 1]
            radius = compute_layer_decimation_radius(i_layer, node_coverage)
            radii.append(float(radius))
            picked_local = _median_grid_subsample_np(positions[finer], 2.0 * radius)
            if len(picked_local) >= len(finer):
                # the finer layer is already at this density: stop with a
                # shallower hierarchy
                radii.pop()
                break
            picked = finer[picked_local]
            keep_mask = np.ones(len(finer), bool)
            keep_mask[picked_local] = False
            layer_members[i_layer - 1] = finer[keep_mask]
            layer_members.append(picked)

        virtual_node_indices = np.concatenate(layer_members).astype(np.int32)
        layer_offsets = np.cumsum([0] + [len(m) for m in layer_members])

        # fine->coarse KNN edges between consecutive layers, coarse-to-fine
        # edge sets in order
        edge_list, edge_layers = [], []
        for i_layer in range(len(layer_members) - 1, 0, -1):
            coarser = layer_members[i_layer]
            finer = layer_members[i_layer - 1]
            if len(coarser) == 0 or len(finer) == 0:
                continue
            deg = min(max_vertex_degree, len(coarser))
            _, nbr = knn(torch.from_numpy(positions[finer]), torch.from_numpy(positions[coarser]), deg)
            nbr = nbr.numpy()
            src = np.repeat(np.arange(len(finer)) + layer_offsets[i_layer - 1], deg)
            dst = (nbr + layer_offsets[i_layer]).reshape(-1)
            edge_list.append(np.stack([src, dst], axis=1))
            edge_layers.append(np.full(len(src), i_layer, np.int8))
        edges = np.concatenate(edge_list) if edge_list else np.zeros((0, 2), np.int32)
        edge_layer_indices = np.concatenate(edge_layers) if edge_layers else np.zeros(0, np.int8)

        return cls.create(
            positions,
            node_coverage=node_coverage,
            device=device,
            virtual_node_indices=torch.as_tensor(virtual_node_indices, device=device),
            edges=torch.as_tensor(edges.astype(np.int32), device=device),
            edge_layer_indices=torch.as_tensor(edge_layer_indices, device=device),
            layer_node_counts=tuple(int(len(m)) for m in layer_members),
            layer_decimation_radii=tuple(radii),
            **kwargs,
        )

    @property
    def arrow_base(self) -> int:
        """#finest-layer nodes == stem size of the arrowhead Hessian."""
        return self.layer_node_counts[0]

    def _vidx(self) -> torch.Tensor:
        return self.virtual_node_indices.long()

    def virtual_positions(self) -> torch.Tensor:
        return self.node_positions[self._vidx()]

    def virtual_rotations(self) -> torch.Tensor:
        return self.node_rotations[self._vidx()]

    def virtual_translations(self) -> torch.Tensor:
        return self.node_translations[self._vidx()]

    def virtual_coverage_weights_squared(self) -> torch.Tensor:
        return self.node_coverage_weights_squared[self._vidx()]

    def rotate_nodes_virtual(self, deltas: torch.Tensor) -> "HierarchicalGraphWarpField":
        """Apply per-node rotation deltas given in virtual order."""
        if deltas.ndim == 2:
            deltas = axis_angle_to_matrix(deltas)
        scattered = torch.zeros_like(deltas)
        scattered[self._vidx()] = deltas
        return self.rotate_nodes(scattered)

    def translate_nodes_virtual(self, deltas: torch.Tensor) -> "HierarchicalGraphWarpField":
        scattered = torch.zeros_like(deltas)
        scattered[self._vidx()] = deltas
        return self.translate_nodes(scattered)


def _median_grid_subsample_np(points: np.ndarray, cell_size: float) -> np.ndarray:
    """Closest-to-cell-mean subsample returning local indices (host-side)."""
    mins = points.min(axis=0)
    cells = np.floor((points - mins) / cell_size).astype(np.int64)
    _, inverse = np.unique(cells, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    picked = []
    for seg in range(inverse.max() + 1):
        members = np.nonzero(inverse == seg)[0]
        mean = points[members].mean(axis=0)
        picked.append(members[np.argmin(((points[members] - mean) ** 2).sum(-1))])
    return np.sort(np.asarray(picked))
