"""Deformation-graph data blobs of DeepDeform-layout sequences (port of the
reader and writer of ``dynamicfuion_python_tpu/apps/create_graph_data.py``).

One frame's graph lives in ``graph_nodes/ graph_edges/ graph_edges_weights/
graph_clusters/`` (and optionally ``graph_node_deformations/ pixel_anchors/
pixel_weights/``) under the sequence directory, each as
``<pair>_geodesic_<coverage>.bin`` in the formats of ``data/io.py``. The graph
generator itself (depth -> mesh -> geodesic graph) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dynamicfuion_python_tpu_torch.data import io as dio


def _stem(pair_name: str, node_coverage: float) -> str:
    return f"{pair_name}_geodesic_{node_coverage:.2f}.bin"


def save_graph_data(
    seq_dir: str | Path,
    pair_name: str,
    node_coverage: float,
    nodes: np.ndarray,
    edges: np.ndarray,
    edge_weights: np.ndarray,
    clusters: np.ndarray,
    pixel_anchors: np.ndarray | None = None,
    pixel_weights: np.ndarray | None = None,
    node_deformations: np.ndarray | None = None,
) -> dict[str, Path]:
    """Write one frame's graph blobs; returns the path of each."""
    seq_dir = Path(seq_dir)
    stem = _stem(pair_name, node_coverage)
    written: dict[str, Path] = {}
    blobs = [
        ("graph_nodes", dio.save_graph_nodes, nodes),
        ("graph_edges", dio.save_graph_edges, edges),
        ("graph_edges_weights", dio.save_graph_edges_weights, edge_weights),
        ("graph_clusters", dio.save_graph_clusters, clusters.reshape(-1, 1)),
        ("graph_node_deformations", dio.save_graph_node_deformations, node_deformations),
        ("pixel_anchors", dio.save_int_image, pixel_anchors),
        ("pixel_weights", dio.save_float_image, pixel_weights),
    ]
    for subdir, saver, array in blobs:
        if array is None:
            continue
        out_dir = seq_dir / subdir
        out_dir.mkdir(parents=True, exist_ok=True)
        saver(out_dir / stem, array)
        written[subdir] = out_dir / stem
    return written


def load_graph_data(seq_dir: str | Path, pair_name: str, node_coverage: float) -> dict:
    """Inverse of :func:`save_graph_data`: a dict of arrays, None for a
    missing optional blob."""
    seq_dir = Path(seq_dir)
    stem = _stem(pair_name, node_coverage)

    def _opt(subdir: str, loader):
        path = seq_dir / subdir / stem
        return loader(path) if path.is_file() else None

    return {
        "nodes": dio.load_graph_nodes(seq_dir / "graph_nodes" / stem),
        "edges": dio.load_graph_edges(seq_dir / "graph_edges" / stem),
        "edge_weights": dio.load_graph_edges_weights(seq_dir / "graph_edges_weights" / stem),
        "clusters": dio.load_graph_clusters(seq_dir / "graph_clusters" / stem),
        "node_deformations": _opt("graph_node_deformations", dio.load_graph_node_deformations),
        "pixel_anchors": _opt("pixel_anchors", dio.load_int_image),
        "pixel_weights": _opt("pixel_weights", dio.load_float_image),
    }
