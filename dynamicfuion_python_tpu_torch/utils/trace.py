"""The port's tracing: spans, counters and the host's waits on the device.

Spans are off by default; ``enable(True)`` turns them on::

    trace.enable(True)
    trace.item(frame_number)  # the spans that follow carry this id
    with trace.span("fit.data_term"):
        ...
    trace.snapshot()  # per name: calls, total ms, self ms; the counters

Off, :func:`span` is one flag check returning a shared no-op context: it
opens no profiler range and keeps nothing. On, each span is kept as a
:class:`Span` (name, parent, item, start and end ns on the host clock) and
opens ``torch.profiler.record_function("dfu::<name>")``, so under a running
profiler it lies on the profiler's timeline beside the device rows
(:func:`read_profile` reads it there).

Counters (:func:`count`) are plain integers and always on. The host's waits
on the device are counted by site, always: :func:`host_read` reads a tensor
into a Python scalar (``host_read.<site>``), :func:`blocking` wraps an
operator that reads a size from the device inside, or a copy back to the
host (``host_read.<site>``), and :func:`upload` copies host data to the
device from pageable memory, which waits for the stream as a read does
(``host_write.<site>``). With
spans on, each wait is also a span under its counter's name.

The registry is one per process: :func:`reset` clears spans and counters.
"""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple

import torch

PREFIX = "dfu::"


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in :func:`spans`, -1 at the top
    item: int | None  # the frame or step number set by :func:`item`
    start_ns: int
    end_ns: int  # 0 while the span is open


_on = False
_item: int | None = None
_records: list[list] = []  # [name, parent, item, start_ns, end_ns]
_open: list[int] = []
_counters: dict[str, int] = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "index", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.index = len(_records)
        _records.append([self.name, _open[-1] if _open else -1, _item, time.perf_counter_ns(), 0])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _records[self.index][4] = time.perf_counter_ns()
        _open.pop()
        self.range.__exit__(*exc)
        return False


def enable(on: bool = True) -> None:
    """Turn spans on or off (counters are always on)."""
    global _on
    _on = bool(on)


def item(i: int | None) -> None:
    """The frame or step number the spans opened from now on carry."""
    global _item
    _item = i


def span(name: str):
    """A context that times its body as span ``name`` while tracing is on."""
    return _OpenSpan(name) if _on else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def host_read(tensor: torch.Tensor, site: str):
    """``tensor.item()``: the host waits for the device and copies one
    value back. Counted as ``host_read.<site>``."""
    key = "host_read." + site
    _counters[key] = _counters.get(key, 0) + 1
    if not _on:
        return tensor.item()
    with _OpenSpan(key):
        return tensor.item()


def blocking(site: str):
    """A context around an operator whose output size the host reads from
    the device inside it (``torch.unique``), or a copy of a tensor back to
    the host (``.cpu()``). Counted as ``host_read.<site>``."""
    key = "host_read." + site
    _counters[key] = _counters.get(key, 0) + 1
    return _OpenSpan(key) if _on else _NO_SPAN


def upload(data, device, site: str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype, device)`` from host memory: a copy
    from pageable memory waits for the device's stream. Counted as
    ``host_write.<site>``."""
    key = "host_write." + site
    _counters[key] = _counters.get(key, 0) + 1
    if not _on:
        return torch.as_tensor(data, dtype=dtype, device=device)
    with _OpenSpan(key):
        return torch.as_tensor(data, dtype=dtype, device=device)


class _DeviceAllocations:
    __slots__ = ("device", "before")

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        self.before = torch.cuda.memory_stats(self.device).get("num_device_alloc", 0)
        return self

    def __exit__(self, *exc):
        count("alloc.device", torch.cuda.memory_stats(self.device).get("num_device_alloc", 0) - self.before)
        return False


def device_allocations(device):
    """A context that, while tracing is on, counts the caching allocator's
    new device allocations (``cudaMalloc``s) over its body as
    ``alloc.device``; off, the shared no-op after one flag check."""
    if not _on:
        return _NO_SPAN
    device = torch.device(device)
    return _DeviceAllocations(device) if device.type == "cuda" else _NO_SPAN


def spans() -> list[Span]:
    """Every span kept since the last :func:`reset`, in the order opened."""
    return [Span(*r) for r in _records]


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "total_ms", "self_ms"}}, "counters":
    {name: n}}``; self time is a span's duration less that of its child
    spans. Spans still open are left out."""
    child_ns = [0] * len(_records)
    for _, parent, _, start, end in _records:
        if parent >= 0 and end:
            child_ns[parent] += end - start
    out: dict[str, dict] = {}
    for i, (name, _, _, start, end) in enumerate(_records):
        if not end:
            continue
        row = out.setdefault(name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["total_ms"] += (end - start) / 1e6
        row["self_ms"] += (end - start - child_ns[i]) / 1e6
    return {"spans": out, "counters": dict(_counters)}


def reset() -> None:
    """Clear the kept spans and the counters."""
    _records.clear()
    _counters.clear()


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def read_profile(events) -> dict:
    """What a ``torch.profiler`` trace (``prof.events()``) recorded under the
    spans: per span name the device ms and kernel launches of the device
    operations inside its device-side range (on the device timeline, so the
    hand-written kernels launched through ``ctypes`` count too), and the
    device's idle ms between operations, each gap given to the innermost
    span the host was in at its midpoint (``none`` outside every span)."""
    events = list(events)
    device = sorted((e for e in events if _is_device(e) and not e.name.startswith(PREFIX)),
                    key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in device]
    # a span's device-side range may come as several rows that overlap (the
    # profiler gave a U2NET forward's range twice, the second inside the
    # first): each span name's rows are merged, so a kernel counts once
    ranges: dict[str, list[list[float]]] = {}
    for r in sorted((r for r in events if _is_device(r) and r.name.startswith(PREFIX)),
                    key=lambda r: r.time_range.start):
        merged = ranges.setdefault(r.name[len(PREFIX):], [])
        if merged and r.time_range.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], r.time_range.end)
        else:
            merged.append([r.time_range.start, r.time_range.end])
    device_us: dict[str, float] = {}
    launches: dict[str, int] = {}
    for name, rows in ranges.items():
        for lo, hi in rows:
            i = bisect.bisect_left(starts, lo)
            while i < len(device) and device[i].time_range.start <= hi:
                e = device[i]
                if e.time_range.end <= hi:
                    device_us[name] = device_us.get(name, 0.0) + (e.time_range.end - e.time_range.start)
                    if not e.name.startswith(("Memcpy", "Memset")):
                        launches[name] = launches.get(name, 0) + 1
                i += 1
    host = sorted((e for e in events if not _is_device(e) and e.name.startswith(PREFIX)),
                  key=lambda e: e.time_range.start)
    idle_us: dict[str, float] = {}
    end = None
    for e in device:
        if end is not None and e.time_range.start > end:
            mid = (end + e.time_range.start) / 2
            name = "none"
            for r in host:  # sorted by start: a later start that holds mid is nested deeper
                if r.time_range.start > mid:
                    break
                if mid <= r.time_range.end:
                    name = r.name[len(PREFIX):]
            idle_us[name] = idle_us.get(name, 0.0) + (e.time_range.start - end)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    return {"device_ms": _ms(device_us), "launches": launches, "idle_ms": _ms(idle_us)}


def _ms(us: dict[str, float]) -> dict[str, float]:
    return {k: v / 1e3 for k, v in sorted(us.items(), key=lambda kv: -kv[1])}
