"""Metric evaluation of generated predictions (port of
``dynamicfuion_python_tpu/apps/evaluate.py``): reload what
``apps/generate.py`` wrote, compare it with the ground truth and report
"Graph Error 3D" (mean node-translation EPE over the valid nodes), "EPE 3D"
(mean EPE of the densely warped source points) and the valid-solve ratio,
each averaged over the pairs; ``None`` where no pair contributes.

Run: python -m dynamicfuion_python_tpu_torch.apps.evaluate --data <root> \\
        --split train --predictions <dir> [--labels train] [--size HxW]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from dynamicfuion_python_tpu_torch.apps.generate import open_split


def evaluate(
    data_root: str,
    predictions_dir: str,
    split: str = "train",
    max_nodes: int = 128,
    image_size=None,
    node_coverage: float = 0.05,
    labels_filename: str | None = None,
) -> dict:
    """The metrics dict (host numpy only)."""
    from dynamicfuion_python_tpu_torch.apps.train import node_translations_gt_from_scene_flow

    dataset = open_split(data_root, split, labels_filename, max_nodes, image_size, node_coverage)
    pred_dir = Path(predictions_dir)
    graph_errors, epe3d_errors, valid_solves = [], [], []
    for i in range(len(dataset)):
        path = pred_dir / f"{dataset.pair_name(i)}.npz"
        if not path.exists():
            continue
        pred = np.load(path)
        batch = dataset.batch([i])
        if "scene_flow_gt" not in batch:
            continue
        n = int(pred["num_nodes"])
        gt_t, gt_valid = node_translations_gt_from_scene_flow(batch)
        validity = pred["deformations_validity"][:n] * gt_valid[0][:n]
        if validity.sum() > 0:
            err = np.linalg.norm(pred["node_translations"][:n] - gt_t[0][:n], axis=-1)
            graph_errors.append(float((err * validity).sum() / validity.sum()))
        source = batch["source"][0]
        gt_deformed = source[..., 3:].reshape(-1, 3) + batch["scene_flow_gt"][0].reshape(-1, 3)
        mask = (source[..., 5].reshape(-1) > 0) & np.isfinite(gt_deformed).all(-1)
        if mask.sum() > 0:
            err = np.linalg.norm(pred["deformed_points"] - gt_deformed, axis=-1)
            epe3d_errors.append(float(err[mask].mean()))
        valid_solves.append(float(pred["valid_solve"]))

    metrics = {
        "graph_error_3d": float(np.mean(graph_errors)) if graph_errors else None,
        "epe_3d": float(np.mean(epe3d_errors)) if epe3d_errors else None,
        "valid_solve_ratio": float(np.mean(valid_solves)) if valid_solves else None,
        "pair_count": len(valid_solves),
    }
    print(json.dumps(metrics, indent=1))
    return metrics


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {}
    it = iter(argv)
    flags = {"--data": "data_root", "--split": "split", "--predictions": "predictions_dir",
             "--labels": "labels_filename"}
    for arg in it:
        if arg in flags:
            kwargs[flags[arg]] = next(it)
        elif arg == "--size":
            h, w = next(it).split("x")
            kwargs["image_size"] = (int(h), int(w))
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    evaluate(**kwargs)


if __name__ == "__main__":
    main()
