"""Single-pair alignment demo with visualization artifacts (port of
``dynamicfuion_python_tpu/apps/example_viz.py``). DeformNet aligns one
source/target pair and the run writes, headless, into an output directory:

  source_points.ply / target_points.ply / deformed_points.ply  point clouds
  correspondences.npz   (source xyz, target-match xyz, weights, validity)
  node_transforms.npz   (rotations, translations, validity, valid_solve)
  mask_pred.png         the correspondence weights (8-bit grey)

which ``apps/visualizer.py`` or any PLY viewer displays.

Run on a DeepDeform pair:
  python -m dynamicfuion_python_tpu_torch.apps.example_viz --data <root> --split train \\
      --pair 0 [--checkpoint <train dir>] [--device cuda|cpu] -o <dir>
or on a synthetic pair: ``--synthetic``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.utils.telemetry import write_ply_mesh, write_png


def _write_point_cloud(path: Path, points: np.ndarray) -> None:
    write_ply_mesh(path, points.reshape(-1, 3), np.zeros((0, 3), np.int32))


def synthetic_pair(h=64, w=64, n_grid=3, shift=(0.02, 0.0, 0.03)):
    """A plane at z = 1 m and its copy moved by ``shift``, with a
    ``n_grid`` x ``n_grid`` node grid, chain edges and 4 nearest anchors per
    pixel: a batch of one pair."""
    rng = np.random.default_rng(0)
    source = np.zeros((1, h, w, 6), np.float32)
    source[..., :3] = rng.uniform(0.2, 0.8, (1, h, w, 3))
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 1.0
    focal = 100.0
    source[..., 3] = (u - w / 2) / focal * z
    source[..., 4] = (v - h / 2) / focal * z
    source[..., 5] = z
    target = source.copy()
    target[..., 3] += shift[0]
    target[..., 4] += shift[1]
    target[..., 5] += shift[2]
    n = n_grid * n_grid
    nodes = np.zeros((1, n, 3), np.float32)
    nodes[0, :, :2] = np.stack(
        np.meshgrid(np.linspace(-0.2, 0.2, n_grid), np.linspace(-0.2, 0.2, n_grid)), -1
    ).reshape(-1, 2)
    nodes[0, :, 2] = z
    edges = np.full((1, n, 2), -1, np.int32)
    edges[0, :-1, 0] = np.arange(1, n)
    edge_w = np.where(edges >= 0, 1.0, 0.0).astype(np.float32)
    clusters = np.zeros((1, n), np.int32)
    pts = source[0, ..., 3:].reshape(-1, 3)
    d2 = ((pts[:, None] - nodes[0][None]) ** 2).sum(-1)
    anchors = np.argsort(d2, 1)[:, :4].astype(np.int32).reshape(1, h, w, 4)
    aw = np.exp(-np.sort(d2, 1)[:, :4] / (2 * 0.2**2))
    aw = (aw / aw.sum(1, keepdims=True)).astype(np.float32).reshape(1, h, w, 4)
    intr = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    return {
        "source": source, "target": target, "graph_nodes": nodes, "graph_edges": edges,
        "graph_edges_weights": edge_w, "graph_clusters": clusters, "pixel_anchors": anchors,
        "pixel_weights": aw, "intrinsics": intr,
    }


def run_alignment_demo(
    batch: dict,
    out_dir: str | Path,
    checkpoint_dir: str | None = None,
    gn_iterations: int = 3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Run DeformNet (seeded by ``seed``, or a training checkpoint) on the
    batch's first pair and write the artifacts; returns a summary."""
    from dynamicfuion_python_tpu_torch.apps.generate import _INPUTS
    from dynamicfuion_python_tpu_torch.apps.train import batch_to_device, fp32_step, load_checkpoint
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict
    from dynamicfuion_python_tpu_torch.models.gn_point_cloud_optimizer import GnConfig
    from dynamicfuion_python_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = batch["graph_nodes"].shape[1]
    model = DeformNet(use_mask=True, num_nodes=n, gn_config=GnConfig(num_iterations=gn_iterations))
    model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(seed)))
    if checkpoint_dir is not None:
        load_checkpoint(checkpoint_dir, model)
    model.to(device).eval()
    inputs = batch_to_device({k: np.asarray(batch[k]) for k in _INPUTS}, device)
    with fp32_step(), torch.no_grad():
        out = model(*(inputs[k] for k in _INPUTS), evaluate=True)

    source_pts = np.asarray(batch["source"][0, ..., 3:])
    target_pts = np.asarray(batch["target"][0, ..., 3:])
    _write_point_cloud(out_dir / "source_points.ply", source_pts[source_pts[..., 2] > 0])
    _write_point_cloud(out_dir / "target_points.ply", target_pts[target_pts[..., 2] > 0])
    _write_point_cloud(out_dir / "deformed_points.ply", out.deformed_points[0].cpu().numpy())
    corr_mask = out.valid_correspondence_mask[0].cpu().numpy()
    np.savez_compressed(
        out_dir / "correspondences.npz",
        source_points=source_pts[corr_mask],
        target_matches=out.target_matches[0].cpu().numpy()[corr_mask],
        weights=out.correspondence_weights[0].cpu().numpy()[corr_mask],
        valid_mask=corr_mask,
    )
    np.savez_compressed(
        out_dir / "node_transforms.npz",
        rotations=out.node_rotations[0].cpu().numpy(),
        translations=out.node_translations[0].cpu().numpy(),
        validity=out.deformations_validity[0].cpu().numpy(),
        valid_solve=out.valid_solve.cpu().numpy(),
    )
    if out.mask_prediction is not None:
        write_png(out_dir / "mask_pred.png", (out.mask_prediction[0, ..., 0].cpu().numpy() * 255).astype(np.uint8))
    return {
        "valid_solve": bool(out.valid_solve[0]),
        "mean_translation": float(torch.linalg.norm(out.node_translations[0], dim=-1).mean()),
        "artifacts": sorted(p.name for p in out_dir.iterdir()),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--pair", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--max-nodes", type=int, default=128)
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("-o", "--out", type=str, required=True)
    args = parser.parse_args(argv)

    if args.synthetic or args.data is None:
        batch = synthetic_pair()
    else:
        from dynamicfuion_python_tpu_torch.data.deform_dataset import DeformDataset

        batch = DeformDataset(Path(args.data) / args.split, max_nodes=args.max_nodes).batch([args.pair])
    summary = run_alignment_demo(batch, args.out, args.checkpoint, device=args.device)
    print(
        f"valid_solve={summary['valid_solve']} mean |t|={summary['mean_translation']:.4f} m; wrote "
        + ", ".join(summary["artifacts"])
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
