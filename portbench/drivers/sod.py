"""Driver of the port's SOD loop (``apps/sod.py::masks_for_frames``, the
loop ``generate_masks`` and its command line run): closed loop, one batch
in flight, batches of the configuration's ``batch_frames``.

Set-up: the seeded frames written as PNGs to the run's scratch directory,
U²-Net built from the configuration's channel plan with weights made on the
device from the seed, and one batch through the loop, which warms every
shape the window uses. The window then hands the loop the frames in turn,
cycled, and stops handing them at the first batch boundary past the
deadline; a frame counts from the read of its PNG to the write of its mask,
and ``frame_ms`` is the window over the masks written. The loop's forward
and ``write_png`` are watched to keep host copies of what ``check_batches``
batches drawn from the seed among the window's first ``check_within``
produced. With ``--trace 1``, ``trace_batches`` more batches run under the
profiler after the window with the port's spans on. Then the reference
redoes the checked frames one at a time.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench.check import sod as check
from portbench.check.precision import set_fp32
from portbench.counts.sod import plan_of
from portbench.harness import NoResult
from portbench.program import port_counters
from portbench.trace import summarize
from portbench.traffic.sod_frames import write_frames
from portbench.weights_sod import u2net_state


class _Frames:
    """The frame paths cycled, handed out until the first batch boundary
    past ``deadline`` that lies past batch ``last``; the start of each
    batch's hand-out is kept in ``marks``."""

    def __init__(self, paths, batch: int, deadline: float, last: int):
        self.paths, self.batch, self.deadline, self.last = paths, batch, deadline, last
        self.marks: list[float] = []
        self.fed = []

    def __iter__(self):
        n = 0
        while True:
            if n % self.batch == 0:
                now = time.perf_counter()
                if now >= self.deadline and n // self.batch > self.last:
                    return
                self.marks.append(now)
            self.fed.append(self.paths[n % len(self.paths)])
            yield self.fed[-1]
            n += 1


@contextlib.contextmanager
def _recording(sod, model, frames: _Frames, batches: set[int], keep: dict):
    """Host copies of the network's input and outputs and of the written
    masks of the frames of ``batches`` (counted from the context's first
    forward), into ``keep`` by frame number. A batch's masks are written on
    the loop's codec threads, all of them before the next batch's: the
    count of writes gives the batch, the file's stem the frame in it."""
    calls, writes, lock = [0], [0], threading.Lock()
    b = frames.batch

    def forward_hook(module, args, outputs):
        i = calls[0]
        calls[0] += 1
        if i in batches:
            x, probs = args[0].cpu().numpy(), [o[:, 0].cpu().numpy() for o in outputs]
            for j in range(x.shape[0]):
                keep.setdefault(i * b + j, {}).update(input=x[j], probs=[p[j] for p in probs])

    write_png = sod.write_png

    def recording_write(path, image, **kwargs):
        with lock:
            batch = writes[0] // b
            writes[0] += 1
        if batch in batches:
            n = next(n for n in range(batch * b, (batch + 1) * b) if frames.fed[n].stem == Path(path).stem)
            mask = np.array(image, copy=True)
            with lock:
                keep.setdefault(n, {}).update(path=frames.fed[n], mask=mask)
        return write_png(path, image, **kwargs)

    handle = model.register_forward_hook(forward_hook)
    sod.write_png = recording_write
    try:
        yield
    finally:
        sod.write_png = write_png
        handle.remove()


def run(run) -> dict:
    import torch

    from dynamicfuion_python_tpu_torch.apps import sod
    from dynamicfuion_python_tpu_torch.models.u2net import U2Net
    from dynamicfuion_python_tpu_torch.utils import trace as port_trace

    set_fp32()
    port_trace.reset()  # the counters read are this run's
    cuda = torch.device(run.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    c, t = run.config, run.traffic
    paths = write_frames(run.scratch / "color", t["frames"], tuple(t["frame_size"]), run.seed)
    plan = plan_of(c)
    state = u2net_state(run.seed, run.device, plan)
    model = U2Net(plan)
    model.load_state_dict(state)
    model.to(run.device).eval()
    # the check's copy of the weights waits on the host, so the card's memory
    # peak is the program's own
    state = {k: v.to("cpu", copy=True) for k, v in state.items()}
    b, size, threshold = c["batch_frames"], tuple(c["input_size"]), c["threshold"]
    out_dir = run.scratch / "sod"
    sod.masks_for_frames(model, paths[:b], out_dir, b, size, threshold)
    sync()
    rng = np.random.default_rng([run.seed, 4])
    checked = {int(i) for i in rng.choice(t["check_within"], size=t["check_batches"], replace=False)}
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    kept: dict[int, dict] = {}
    t_start = time.perf_counter()
    setup_s = t_start - run.t0
    frames = _Frames(paths, b, t_start + run.seconds, max(checked))
    with _recording(sod, model, frames, checked, kept):
        written = sod.masks_for_frames(model, frames, out_dir, b, size, threshold)
        sync()
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = len(written)
    batch_ms = [(y - x) * 1e3 for x, y in zip(frames.marks, frames.marks[1:])]
    print(f"window: {n} frames in {len(frames.marks)} batches of {b} in {window_s:.3f} s; batch ms quartiles "
          f"{[round(q, 2) for q in (statistics.quantiles(batch_ms, n=4) if len(batch_ms) > 1 else batch_ms)]}",
          file=sys.stderr)
    out = {
        "attempted": n,
        "failed": len(frames.fed) - n,
        "end_to_end": {
            "frame_ms": window_s * 1e3 / n,
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        },
        "memory_peak_bytes": max(setup_peak, window_peak),
    }

    if run.trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        k = t["trace_batches"] * b
        port_trace.enable(True)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t1 = time.perf_counter()
                sod.masks_for_frames(model, [paths[i % len(paths)] for i in range(k)], out_dir, b, size, threshold)
                sync()
                traced_s = time.perf_counter() - t1
        finally:
            port_trace.enable(False)
        spans = port_trace.snapshot()["spans"]
        events = list(prof.events())
        device = port_trace.read_profile(events)["device_ms"]
        # the port's spans also lie on the device timeline as rows of their
        # own: busy time and the breakdown count the device's work alone
        work = [e for e in events if not (e.device_type == torch.autograd.DeviceType.CUDA
                                          and e.name.startswith(port_trace.PREFIX))]
        trace = summarize(SimpleNamespace(events=lambda: work), k)
        counters = port_counters()
        trace.update(
            untraced_ms=statistics.median(batch_ms) / b if batch_ms else window_s * 1e3 / n,
            frame_ms=out["end_to_end"]["frame_ms"],
            sod_forward_flops=c["flops"]["sod_forward"],
            span_device_ms={name: ms / k for name, ms in device.items()},
            span_host_ms={name: row["total_ms"] / k for name, row in spans.items()},
            counters=counters,
        )
        print(f"traced: {k} frames; device ms a frame by span {trace['span_device_ms']}; host ms a frame by span "
              f"{trace['span_host_ms']}; counters {counters}; frames fed {len(frames.fed) + k + b}", file=sys.stderr)
        out["trace"] = trace
        out["device_trace"] = {"busy_s": trace["busy_s"], "window_s": traced_s, "breakdown": trace["breakdown"]}
        del prof

    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    recorded = [kept[i] for i in sorted(kept)]
    flat = check.saturated(recorded)
    if flat:
        raise NoResult(f"checked frames too flat to check (fused range under {check.MIN_RANGE} or a constant "
                       f"mask): {flat}")

    from portbench.reference.models.u2net import U2Net as Reference

    reference = Reference(plan)
    reference.load_state_dict(state)
    reference.to(run.device).eval()

    def compare(tf32: bool) -> dict:
        return check.gaps(recorded, reference, size, threshold, tf32)

    gaps = compare(False)
    limits = {**check.EXACT, **run.limits}
    out["checks"] = {name: (gaps[name], limits[name]) for name in ("input", "prob", "mask")}
    if run.control:
        out["control"] = compare(True)
    return out
