"""FLOPs of U²-Net's forward on one frame, counted once with
``torch.utils.flop_counter.FlopCounterMode`` over the reference network
(``portbench/reference/models/u2net.py``) at the configuration's input
size, on the meta device, so the count is the same whatever the port runs.
It counts the operators PyTorch has formulas for (the convolutions) and
nothing else: BatchNorm, ReLU, pooling, up-sampling and the sigmoids are
left out, a lower bound.

    python3 portbench/counts/sod.py --config <name>

prints the counts that the configuration's file names under ``flops``
(``sod_forward``), as the file stores them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode


def plan_of(config: dict):
    """The configuration's channel plan as ``U2Net`` takes it: ((depth or
    None for RSU-4F, mid, out) x 6 encoder stages, x 5 decoder stages)."""
    stages = config["stages"]
    return tuple(tuple(tuple(spec) for spec in stages[part]) for part in ("encoder", "decoder"))


def sod_forward_flops(config: dict) -> int:
    from portbench.reference.models.u2net import U2Net

    h, w = config["input_size"]
    net = U2Net(plan_of(config)).to("meta").eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(torch.zeros((1, 3, h, w), device="meta"))
    return int(counter.get_total_flops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    config = json.loads((root / "portbench" / "configs" / f"{args.config}.json").read_text())
    counts = {"sod_forward": lambda: sod_forward_flops(config)}
    print(json.dumps({name: counts[name]() for name in config["flops"]}))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    raise SystemExit(main())
