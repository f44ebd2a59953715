"""Offline deformation-graph generator for DeepDeform-layout sequences
(port of ``dynamicfuion_python_tpu/apps/create_graph_data.py``).

For each (masked) depth frame of a sequence: depth -> mesh -> erosion ->
coverage-radius node sampling -> geodesic edges -> connected-component
clusters -> per-pixel anchors and weights (``data/deform_dataset.py::
build_graph_for_frame``, host numpy), optionally with node deformations
sampled from a scene-flow frame. One frame's graph lives in ``graph_nodes/
graph_edges/ graph_edges_weights/ graph_clusters/`` (and optionally
``graph_node_deformations/ pixel_anchors/ pixel_weights/``) under the
sequence directory, each as ``<frame>_geodesic_<coverage>.bin`` in the
formats of ``data/io.py``. With ``--labels FILE`` the sequence's frame pairs
(``optical_flow/*_<source>_<target>.oflow``) whose source frame has a graph
are added to a labels JSON that ``LabeledDeformDataset`` reads.

Run:  python -m portbench.reference.apps.create_graph_data <sequence_dir> \\
          [--node-coverage 0.05] [--frames i j ...] [--labels <split_root>/train.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from portbench.reference.data import io as dio
from portbench.reference.data.camera import load_intrinsics_txt
from portbench.reference.data.deform_dataset import build_graph_for_frame
from portbench.reference.data.images import load_depth


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


def _load_depth_png(path: Path) -> np.ndarray:
    return load_depth(path)


def process_frame(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    node_coverage: float,
    mask: np.ndarray | None = None,
    scene_flow: np.ndarray | None = None,
    max_neighbor_count: int = 8,
    erosion_iterations: int = 10,
    erosion_min_neighbors: int = 4,
    depth_scale: float = 1000.0,
    depth_max: float = 6.0,
):
    """One frame -> (nodes, edges, edge weights, clusters, pixel anchors,
    pixel weights, node deformations or None). ``mask`` > 0 keeps a pixel;
    ``scene_flow`` f32[H, W, 3] is sampled at each node's source pixel."""
    if mask is not None:
        depth = np.where(mask > 0, depth, 0)
    nodes, edges, edge_weights, clusters, anchors, weights, node_pixels = build_graph_for_frame(
        depth, intrinsics, node_coverage=node_coverage, max_neighbor_count=max_neighbor_count,
        erosion_iterations=erosion_iterations, erosion_min_neighbors=erosion_min_neighbors,
        depth_scale=depth_scale, depth_max=depth_max, return_node_pixels=True,
    )
    node_deformations = None
    if scene_flow is not None:
        node_deformations = scene_flow[node_pixels[:, 0], node_pixels[:, 1]].astype(np.float32)
    return nodes, edges, edge_weights, clusters, anchors, weights, node_deformations


def _frame_file(directory: Path, frame_id: str) -> str | None:
    for suffix in (".png", ".jpg"):
        if (directory / f"{frame_id}{suffix}").is_file():
            return f"{frame_id}{suffix}"
    return None


def add_labels(seq_dir: str | Path, labels_path: str | Path, node_coverage: float) -> int:
    """Add the sequence's pairs whose source frame has graph blobs to the
    labels JSON (created when missing; paths relative to its directory);
    returns the number added."""
    seq_dir, labels_path = Path(seq_dir), Path(labels_path)
    base = labels_path.parent
    labels = json.loads(labels_path.read_text()) if labels_path.is_file() else []
    k = load_intrinsics_txt(seq_dir / "intrinsics.txt")
    rel = lambda path: str(Path(path).resolve().relative_to(base.resolve()))
    added = 0
    for flow in sorted((seq_dir / "optical_flow").glob("*.oflow")):
        src, tgt = flow.stem.split("_")[-2:]
        stem = _stem(src, node_coverage)
        scene_flow = seq_dir / "scene_flow" / f"{flow.stem}.sflow"
        colors = [_frame_file(seq_dir / "color", f) for f in (src, tgt)]
        if not (seq_dir / "graph_nodes" / stem).is_file() or not scene_flow.is_file() or None in colors:
            continue
        entry = {
            "source_color": rel(seq_dir / "color" / colors[0]),
            "source_depth": rel(seq_dir / "depth" / f"{src}.png"),
            "target_color": rel(seq_dir / "color" / colors[1]),
            "target_depth": rel(seq_dir / "depth" / f"{tgt}.png"),
            "optical_flow": rel(flow),
            "scene_flow": rel(scene_flow),
            "intrinsics": {"fx": float(k[0, 0]), "fy": float(k[1, 1]), "cx": float(k[0, 2]), "cy": float(k[1, 2])},
        }
        for subdir in ("graph_nodes", "graph_edges", "graph_edges_weights", "graph_clusters",
                       "graph_node_deformations", "pixel_anchors", "pixel_weights"):
            if (seq_dir / subdir / stem).is_file():
                entry[subdir] = rel(seq_dir / subdir / stem)
        labels.append(entry)
        added += 1
    labels_path.write_text(json.dumps(labels, indent=1))
    return added


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sequence_dir", help="DeepDeform-layout sequence directory")
    parser.add_argument("--node-coverage", type=float, default=0.05)
    parser.add_argument("--max-neighbor-count", type=int, default=8)
    parser.add_argument("--erosion-iterations", type=int, default=10)
    parser.add_argument("--erosion-min-neighbors", type=int, default=4)
    parser.add_argument("--depth-scale", type=float, default=1000.0)
    parser.add_argument("--depth-max", type=float, default=6.0)
    parser.add_argument("--frames", type=int, nargs="*", default=None, help="frame indices to process (default: all)")
    parser.add_argument("--labels", default=None, help="labels JSON to add the sequence's pairs to")
    args = parser.parse_args(argv)

    seq_dir = Path(args.sequence_dir)
    mask_dir = seq_dir / "mask"
    intrinsics = load_intrinsics_txt(seq_dir / "intrinsics.txt")
    depth_paths = sorted((seq_dir / "depth").glob("*.png"))
    if args.frames is not None:
        depth_paths = [depth_paths[i] for i in args.frames]
    for depth_path in depth_paths:
        depth = _load_depth_png(depth_path)
        mask_path = mask_dir / depth_path.name
        mask = _load_depth_png(mask_path) if mask_path.is_file() else None
        try:
            nodes, edges, ew, clusters, anchors, weights, _ = process_frame(
                depth, intrinsics, args.node_coverage, mask=mask, max_neighbor_count=args.max_neighbor_count,
                erosion_iterations=args.erosion_iterations, erosion_min_neighbors=args.erosion_min_neighbors,
                depth_scale=args.depth_scale, depth_max=args.depth_max,
            )
        except ValueError as exc:
            print(f"{depth_path.name}: skipped ({exc})", file=sys.stderr)
            continue
        save_graph_data(seq_dir, depth_path.stem, args.node_coverage, nodes, edges, ew, clusters, anchors, weights)
        print(
            f"{depth_path.name}: {len(nodes)} nodes, {int((edges >= 0).sum())} edges, "
            f"{int(np.all(anchors >= 0, axis=-1).sum())} fully-anchored pixels"
        )
    if args.labels is not None:
        added = add_labels(seq_dir, args.labels, args.node_coverage)
        print(f"{args.labels}: {added} pairs added")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
