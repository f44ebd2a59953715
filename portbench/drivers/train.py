"""Driver of the DeformNet training step (``apps/train.py::make_train_step``):
closed-loop steps, each with its data path as ``train()`` pays it (the
dataset's batch from the PNG split, the node ground truth and match
uniforms, the move to the device, the step, the loss read on the host).

Set-up: the seeded split and its graph data, the model with weights made on
the device from the seed, SGD, and the first ``checked_steps`` steps on
rows that all differ (a seeded order of the pairs), which warm every shape.
The same step object then runs the window. With ``--trace 1``,
``trace_steps`` more steps run under the profiler after the window. Then
the reference redoes the first steps.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

import numpy as np

from portbench.check import train as check
from portbench.check.precision import set_fp32
from portbench.trace import summarize
from portbench.traffic.pairs import write_split
from portbench.weights import deform_net_state


def run(run) -> dict:
    import torch

    from dynamicfuion_python_tpu_torch.apps import train
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset

    set_fp32()
    cuda = torch.device(run.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    c, t = run.config, run.traffic
    split = run.scratch / "split"
    with contextlib.redirect_stdout(sys.stderr):
        write_split(split, tuple(t["split_size"]), t["frames"], run.seed)
    dataset = LabeledDeformDataset(split, "train", input_size=tuple(c["input_size"]), max_nodes=c["max_nodes"])
    stage = train.STAGES[c["stage"]]
    model = train.build_model(stage, c["max_nodes"], c["gn_max_matches"])
    state = deform_net_state(run.seed, run.device, use_mask=stage.use_mask_net)
    model.load_state_dict(state)
    model.to(run.device).train()
    # the check's copy of the first weights waits on the host, so the card's
    # memory peak is the program's own
    state = {k: v.to("cpu", copy=True) for k, v in state.items()}
    optimizer = torch.optim.SGD(model.parameters(), lr=c["learning_rate"], momentum=c["momentum"], dampening=0.0)
    step = train.make_train_step(model, optimizer, stage)

    rng = np.random.default_rng([run.seed, 2])
    order = rng.permutation(len(dataset))
    b = c["batch_size"]

    def rows(i):
        return [int(order[(i * b + j) % len(order)]) for j in range(b)]

    def batch(i):
        data = dataset.batch(rows(i))
        data["node_translations_gt"] = train.node_translations_gt_from_scene_flow(data)[0]
        data["match_subsample_uniforms"] = rng.uniform(size=data["target"].shape[:3]).astype(np.float32)
        return data

    checked = t["checked_steps"]
    first = [batch(i) for i in range(checked)]
    uniforms = [d["match_subsample_uniforms"] for d in first]
    program = check.run_steps(model, optimizer, step, [train.batch_to_device(d, run.device) for d in first],
                              state)
    del first
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    times, data_s, marks = [], [], []
    t_start = time.perf_counter()
    setup_s = t_start - run.t0
    deadline = t_start + run.seconds
    i = checked
    while time.perf_counter() < deadline:
        t1 = time.perf_counter()
        on_device = train.batch_to_device(batch(i), run.device)
        data_s.append(time.perf_counter() - t1)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if cuda else None
        loss, _ = step(on_device, events)
        float(loss)  # the host reads each step's loss, as train() does
        times.append(time.perf_counter() - t1)
        marks.append(events)
        i += 1
    window_s = time.perf_counter() - t_start
    sync()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = len(times)
    print(f"window: {steps} steps in {window_s:.3f} s", file=sys.stderr)
    out = {
        "attempted": steps,
        "failed": 0,
        "end_to_end": {
            "train_step_ms": window_s * 1e3 / steps,
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        },
        "memory_peak_bytes": max(setup_peak, window_peak),
    }

    if run.trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        k = t["trace_steps"]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for j in range(k):
                with torch.profiler.record_function("pb::data"):
                    on_device = train.batch_to_device(batch(i + j), run.device)
                with torch.profiler.record_function("pb::step"):
                    loss, _ = step(on_device)
                    float(loss)
            sync()
            traced_s = time.perf_counter() - t1
        trace = summarize(prof, k)
        trace.update(
            untraced_ms=statistics.median(times) * 1e3,
            step_ms=out["end_to_end"]["train_step_ms"],
            data_ms=statistics.median(data_s) * 1e3,
            flops_per_step=c.get("flops", {}).get("train_step"),
        )
        if cuda:
            trace["forward_ms"] = statistics.median(m[0].elapsed_time(m[1]) for m in marks)
            trace["backward_ms"] = statistics.median(m[1].elapsed_time(m[2]) for m in marks)
        out["trace"] = trace
        out["device_trace"] = {"busy_s": trace["busy_s"], "window_s": traced_s, "breakdown": trace["breakdown"]}
        del prof

    del model, optimizer, step, marks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def compare(tf32: bool) -> dict:
        ref = check.reference_steps(c, state, split, [rows(j) for j in range(checked)], uniforms, run.device, tf32)
        return check.gaps(program, ref)

    gaps = compare(False)
    print(f"change compared over {gaps['leaves'][0]} of {gaps['leaves'][1]} leaves (the others' reference "
          f"gradient is under {check.NOUGHT} of the median leaf's)", file=sys.stderr)
    out["checks"] = {name: (gaps[name], run.limits[name]) for name in check.NAMES}
    if run.control:
        out["control"] = compare(True)
    return out
