"""FLOPs of DeformNet's work, counted once with
``torch.utils.flop_counter.FlopCounterMode`` over the reference's network
(``portbench/reference``) at a cell's shapes, so the count is the same
whatever the port runs. It counts the operators PyTorch has formulas for
(convolutions, matrix products) and nothing else: a lower bound.

    python3 portbench/counts/flops.py --config <name> [--device cuda]

prints the counts that the configuration's file names under ``flops``
(``train_step``, ``prior_forward``), as the file stores them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

SEED = 1


def train_step_flops(config: dict, device) -> int:
    """Forward, backward and optimizer FLOPs of one training step at the
    configuration's batch and input size."""
    from portbench.reference.apps import train
    from portbench.reference.data.deform_dataset import LabeledDeformDataset
    from portbench.traffic.pairs import write_split
    from portbench.weights import deform_net_state

    stage = train.STAGES[config["stage"]]
    with tempfile.TemporaryDirectory(prefix="portbench-flops-") as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            write_split(tmp, (480, 640), 7, SEED)
        dataset = LabeledDeformDataset(tmp, "train", input_size=tuple(config["input_size"]),
                                       max_nodes=config["max_nodes"])
        data = dataset.batch(list(range(config["batch_size"])))
    data["node_translations_gt"] = train.node_translations_gt_from_scene_flow(data)[0]
    data["match_subsample_uniforms"] = np.random.default_rng(SEED).uniform(size=data["target"].shape[:3]).astype(np.float32)
    model = train.build_model(stage, config["max_nodes"], config["gn_max_matches"])
    model.load_state_dict(deform_net_state(SEED, device, use_mask=stage.use_mask_net))
    model.to(device).train()
    optimizer = torch.optim.SGD(model.parameters(), lr=config["learning_rate"], momentum=config["momentum"])
    step = train.make_train_step(model, optimizer, stage)
    counter = FlopCounterMode(display=False)
    with counter:
        step(train.batch_to_device(data, device))
    return int(counter.get_total_flops())


def prior_forward_flops(config: dict) -> int:
    """FLOPs of DeformNet's networks (PWC-Net and MaskNet) on one pair at
    the configuration's input size, as the prior runs them per frame; the
    Gauss-Newton solve after them is not counted."""
    from portbench.reference.models.deform_net import DeformNet
    from portbench.reference.models.gn_point_cloud_optimizer import GnConfig

    h, w = config["input_size"]
    net = DeformNet(use_mask=True, num_nodes=1, gn_config=GnConfig()).to("meta")
    color = torch.zeros((1, h, w, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        features2 = net.flow_net(color, color)[-1]
        if net.enforce_bidirectional_consistency:
            net.flow_net(color, color)
        net.mask_net(features2, torch.zeros((1, h, w, 12), device="meta"))
    return int(counter.get_total_flops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    config = json.loads((root / "portbench" / "configs" / f"{args.config}.json").read_text())
    from portbench.check.precision import set_fp32

    set_fp32()
    counts = {"train_step": lambda: train_step_flops(config, args.device),
              "prior_forward": lambda: prior_forward_flops(config)}
    print(json.dumps({name: counts[name]() for name in config["flops"]}))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    raise SystemExit(main())
