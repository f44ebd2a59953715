"""The port's own tracing (``dynamicfuion_python_tpu_torch/utils/trace.py``)
in one cell, in the two segments a driver would run after its profiled one:

(a) ``window`` frames or steps with tracing off, ``k`` with it on, ``window``
    off again, on the host clock and with no profiler: the cost of tracing
    when on (the median traced item over the median untraced one), the
    host ms per span and the counters per item;
(b) ``min(k, 3)`` more with tracing on under ``torch.profiler``: device ms,
    kernel launches and idle ms by ``dfu::`` span (``trace.read_profile``).

    python3 -m portbench.segments <cell> <seed> <window> <k> [cpu]

The cell's configuration, traffic and weights are the benchmark's, made
from the seed as its drivers make them; ``cpu`` cuts the shapes to a few
seconds' work. Prints one JSON line. No driver runs this: its segments are
what ``drivers/fusion.py`` and ``drivers/train.py`` lack for the span
metrics (PERF.md, section 7).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.utils import trace
from portbench import harness
from portbench.check.precision import set_fp32


def _ms(xs) -> float:
    return statistics.median(xs) * 1e3


def segments(run_item, first: int, window: int, k: int, cuda: bool) -> dict:
    """Segments (a) and (b) over ``run_item(i)`` for i from ``first`` on."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def timed(i):
        t = time.perf_counter()
        run_item(i)
        sync()
        return time.perf_counter() - t

    i = first
    trace.reset()
    off1 = [timed(i + j) for j in range(window)]
    i += window
    off_counters = trace.snapshot()["counters"]
    trace.reset()
    trace.enable(True)
    on = []
    for j in range(k):
        trace.item(i + j)
        on.append(timed(i + j))
    i += k
    host = trace.snapshot()
    trace.enable(False)
    trace.reset()
    off2 = [timed(i + j) for j in range(window)]
    i += window
    out = {
        "off_ms": [_ms(off1), _ms(off2)], "on_ms": _ms(on),
        "off_quartiles_ms": [q * 1e3 for q in statistics.quantiles(off1 + off2, n=4)],
        "on_quartiles_ms": [q * 1e3 for q in statistics.quantiles(on, n=4)],
        "on_cost": _ms(on) / _ms(off1 + off2) - 1.0,
        "spans_per_item": {n: {"calls": r["calls"] / k, "total_ms": r["total_ms"] / k, "self_ms": r["self_ms"] / k}
                           for n, r in sorted(host["spans"].items(), key=lambda kv: -kv[1]["total_ms"])},
        "counters_per_item_on": {n: v / k for n, v in sorted(host["counters"].items())},
        "counters_per_item_off": {n: v / window for n, v in sorted(off_counters.items())},
    }
    if cuda:
        kp = min(3, k)
        trace.reset()
        trace.enable(True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for j in range(kp):
                trace.item(i + j)
                run_item(i + j)
            sync()
        trace.enable(False)
        trace.reset()
        got = trace.read_profile(prof.events())
        out["profiled_items"] = kp
        out["device_ms_per_item"] = {n: v / kp for n, v in got["device_ms"].items()}
        out["launches_per_item"] = {n: v / kp for n, v in sorted(got["launches"].items(), key=lambda kv: -kv[1])}
        out["idle_ms_per_item"] = {n: v / kp for n, v in got["idle_ms"].items()}
    return out


def fusion(run, window: int, k: int) -> dict:
    """The closed frame loop after ``drivers/fusion.py``'s set-up."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides
    from portbench.traffic.bending_plane import BendingPlane
    from portbench.weights import deform_net_state, save_state

    t = run.traffic
    size = t["image_size"]
    plane = BendingPlane(*size, focal=t["focal"], period=t["period"], amplitude=t["amplitude"],
                         noise_mm_at_1m=t["noise_mm_at_1m"])
    period = plane.frames(run.seed)
    overrides = list(run.config["overrides"])
    if apply_overrides(Parameters(), overrides).fusion.use_neural_prior:
        path = run.scratch / "deform_net.pt"
        save_state(deform_net_state(run.seed, run.device, use_mask=True), path)
        overrides.append(f"fusion.prior_checkpoint={path}")
    pipe = FusionPipeline(apply_overrides(Parameters(), overrides), plane.intrinsics, device=run.device)
    pipe.initialize(*period[0])
    for i in range(1, t["warm_frames"] + 1):
        pipe.process_frame(*period[i])
    return segments(lambda i: pipe.process_frame(*period[i % plane.period]), t["warm_frames"] + 1, window, k,
                    run.device == "cuda")


def training(run, window: int, k: int) -> dict:
    """Closed-loop steps with their data path after ``drivers/train.py``'s
    set-up."""
    from dynamicfuion_python_tpu_torch.apps import train
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset
    from portbench.traffic.pairs import write_split
    from portbench.weights import deform_net_state

    c, t = run.config, run.traffic
    split = run.scratch / "split"
    with contextlib.redirect_stdout(sys.stderr):
        write_split(split, tuple(t["split_size"]), t["frames"], run.seed)
    dataset = LabeledDeformDataset(split, "train", input_size=tuple(c["input_size"]), max_nodes=c["max_nodes"])
    stage = train.STAGES[c["stage"]]
    model = train.build_model(stage, c["max_nodes"], c["gn_max_matches"])
    model.load_state_dict(deform_net_state(run.seed, run.device, use_mask=stage.use_mask_net))
    model.to(run.device).train()
    optimizer = torch.optim.SGD(model.parameters(), lr=c["learning_rate"], momentum=c["momentum"], dampening=0.0)
    step = train.make_train_step(model, optimizer, stage)
    rng = np.random.default_rng([run.seed, 2])
    order = rng.permutation(len(dataset))
    b = c["batch_size"]

    def item(i):
        data = dataset.batch([int(order[(i * b + j) % len(order)]) for j in range(b)])
        data["node_translations_gt"] = train.node_translations_gt_from_scene_flow(data)[0]
        data["match_subsample_uniforms"] = rng.uniform(size=data["target"].shape[:3]).astype(np.float32)
        loss, _ = step(train.batch_to_device(data, run.device))
        float(loss)

    for i in range(t["checked_steps"]):
        item(i)
    return segments(item, t["checked_steps"], window, k, run.device == "cuda")


def main(argv: list[str]) -> int:
    cell, seed, window, k = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    device = argv[4] if len(argv) > 4 else "cuda"
    bench = harness.load_bench()
    found, config, traffic, limits = harness.cell_files(bench, cell)
    if device == "cpu":
        config = dict(config, input_size=[64, 128], max_nodes=128, gn_max_matches=500)
        traffic = dict(traffic, split_size=[96, 160], warm_frames=1)
        if "image_size" in traffic:
            w = traffic["image_size"][1]
            traffic.update(image_size=[64, 128], focal=traffic["focal"] * 128 / w)
    set_fp32()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = harness.Run(cell, seed, 0, False, found, config, traffic, limits, t0, device=device, scratch=Path(tmp))
        out = (training if traffic["driver"] == "train" else fusion)(run, window, k)
    out.update(cell=cell, seed=seed, window=window, k=k, card=harness.card_line() if device == "cuda" else "cpu",
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
