"""Runs of the benchmark's drivers on the CPU at tiny sizes, past the
harness's look for a card: only tests drive them so."""

from __future__ import annotations

import json
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

# the cells at sizes a CPU test run can hold: the bending plane at 64x96,
# the training split at 96x128 cropped to 64x128
TINY = {
    "fusion.bend480": ({}, {"image_size": [64, 96], "focal": 64 * 1.4, "warm_frames": 1, "check_frames": 1,
                            "check_within": 2, "chain_within": 2, "trace_frames": 1}),
    "train.solver448": ({"input_size": [64, 128]}, {"split_size": [96, 128]}),
}


def tiny_run(workload: str, seed: int, seconds: float = 0.1, control: bool = False) -> harness.Run:
    bench = harness.load_bench(ROOT)
    cell, config, traffic, limits = harness.cell_files(bench, workload, ROOT)
    config_change, traffic_change = TINY[workload]
    config, traffic = {**config, **config_change}, {**traffic, **traffic_change}
    return harness.Run(workload, seed, seconds, False, cell, config, traffic, limits, time.perf_counter(),
                       device="cpu", control=control)


def correct(outcome: dict) -> bool:
    return all(v <= lim for v, lim in outcome["checks"].values())


def dump(outcome: dict) -> str:
    return json.dumps({k: outcome[k] for k in ("checks", "end_to_end")}, default=str)
