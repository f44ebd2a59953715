"""Offline prediction generation (port of
``dynamicfuion_python_tpu/apps/generate.py``): run DeformNet on every frame
pair of a split and save each pair's node transforms, their validity and the
densely warped source points as ``<out>/<sequence>_<source>_<target>.npz``,
with ``index.json`` listing the pairs; ``apps/evaluate.py`` reads them.

Run: python -m dynamicfuion_python_tpu_torch.apps.generate --data <root> \\
        --split train --out <dir> [--checkpoint <train dir>] [--labels train] \\
        [--size HxW] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.data.deform_dataset import DeformDataset, LabeledDeformDataset
from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict
from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig
from dynamicfuion_python_tpu_torch.utils.device import resolve_device

_INPUTS = ("source", "target", "graph_nodes", "graph_edges", "graph_edges_weights", "graph_clusters",
           "pixel_anchors", "pixel_weights", "intrinsics")


def open_split(data_root, split: str, labels_filename: str | None, max_nodes: int, image_size, node_coverage: float):
    """The pairs of ``<data_root>/<split>`` (graphs built from the source
    depth), or, with ``labels_filename``, those ``<data_root>/<labels>.json``
    lists (precomputed graphs, center crop to ``image_size``, 448x640 by
    default)."""
    if labels_filename is not None:
        size = tuple(image_size) if image_size is not None else (448, 640)
        return LabeledDeformDataset(data_root, labels_filename, input_size=size, max_nodes=max_nodes)
    return DeformDataset(Path(data_root) / split, max_nodes=max_nodes, image_size=image_size,
                         node_coverage=node_coverage)


def generate(
    data_root: str,
    out_dir: str,
    split: str = "train",
    checkpoint_dir: str | None = None,
    max_nodes: int = 128,
    seed: int = 0,
    image_size=None,
    node_coverage: float = 0.05,
    labels_filename: str | None = None,
    device: str | torch.device | None = None,
) -> list[str]:
    """Predictions of a DeformNet (mask net on, 3 GN iterations) seeded by
    ``seed`` or loaded from a training checkpoint directory; returns the
    pair names. ``device`` defaults to the CUDA card."""
    from dynamicfuion_python_tpu_torch.apps.train import batch_to_device, fp32_step, load_checkpoint

    device = resolve_device(device)
    dataset = open_split(data_root, split, labels_filename, max_nodes, image_size, node_coverage)
    if len(dataset) == 0:
        raise ValueError(f"no labeled pairs in {data_root} ({labels_filename or split})")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model = DeformNet(use_mask=True, num_nodes=max_nodes, gn_config=GnConfig(num_iterations=3))
    model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(seed)))
    if checkpoint_dir is not None:
        load_checkpoint(checkpoint_dir, model)
    model.to(device).eval()

    index = []
    for i in range(len(dataset)):
        batch = dataset.batch([i])
        inputs = batch_to_device({k: batch[k] for k in _INPUTS}, device)
        with fp32_step(), torch.no_grad():
            pred = model(*(inputs[k] for k in _INPUTS), evaluate=True)
        name = dataset.pair_name(i)
        np.savez_compressed(
            out / f"{name}.npz",
            node_translations=pred.node_translations[0].cpu().numpy(),
            node_rotations=pred.node_rotations[0].cpu().numpy(),
            deformations_validity=pred.deformations_validity[0].cpu().numpy(),
            deformed_points=pred.deformed_points[0].cpu().numpy(),
            valid_solve=pred.valid_solve[0].cpu().numpy(),
            num_nodes=batch["num_nodes"][0],
        )
        index.append(name)
        print(f"[{i + 1}/{len(dataset)}] {name}", flush=True)
    (out / "index.json").write_text(json.dumps(index))
    return index


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {}
    it = iter(argv)
    flags = {"--data": "data_root", "--split": "split", "--out": "out_dir", "--checkpoint": "checkpoint_dir",
             "--labels": "labels_filename", "--device": "device"}
    for arg in it:
        if arg in flags:
            kwargs[flags[arg]] = next(it)
        elif arg == "--size":
            h, w = next(it).split("x")
            kwargs["image_size"] = (int(h), int(w))
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    generate(**kwargs)


if __name__ == "__main__":
    main()
