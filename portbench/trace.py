"""Spans and device time of a traced segment.

:class:`Ranges` wraps functions of the port in ``torch.profiler`` ranges
named ``pb::<label>`` while it is open, as ``apps/profile_frame.py``'s
``_Ranges`` wraps module functions, and can record the arguments of calls
(for the kernels' operation and byte counts). :func:`summarize` reads a
profile: device busy time (kernel, copy and set rows), kernel launches,
device time under each range, the costliest device operations and the
longest idle gaps by what the host was in.
"""

from __future__ import annotations

import bisect
import importlib
import sys

import torch

PREFIX = "pb::"
PROGRAM = "dynamicfuion_python_tpu_torch"


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


class Ranges:
    """``targets``: (label, "module.path", "name" or "Class.method") of the
    port, the module path relative to the package. Every loaded module of
    the port that holds the same function under that name gets the wrapped
    one, so callers that imported it by name see it too. ``record``: labels
    whose calls' (args, kwargs) are kept in :attr:`calls`. A target the port
    does not have is skipped."""

    def __init__(self, targets, record=()):
        self.calls: dict[str, list] = {label: [] for label in record}
        self._patches = []
        for label, module, name in targets:
            try:
                mod = importlib.import_module(f"{PROGRAM}.{module}")
            except ImportError:
                continue
            owner_name, _, attr = name.rpartition(".")
            owner = getattr(mod, owner_name, None) if owner_name else mod
            fn = getattr(owner, attr, None) if owner is not None else None
            if fn is None:
                continue
            wrapped = self._wrap(fn, label)
            if owner_name:
                self._patches.append((owner, attr, fn, wrapped))
                continue
            for other in list(sys.modules.values()):
                if getattr(other, "__name__", "").startswith(PROGRAM) and getattr(other, attr, None) is fn:
                    self._patches.append((other, attr, fn, wrapped))

    def _wrap(self, fn, label):
        calls = self.calls.get(label)

        def call(*args, **kwargs):
            if calls is not None:
                calls.append((args, kwargs))
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)

        return call

    def __enter__(self):
        for owner, attr, _, wrapped in self._patches:
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn, _ in reversed(self._patches):
            setattr(owner, attr, fn)


def summarize(prof, items: int) -> dict:
    """Per traced item (frame or step): device busy ms, kernel launches,
    device ms under each range; for the whole segment
    busy seconds and the breakdown (the 10 costliest device operations and
    the 10 largest sums of idle gaps by the range and operator the host was
    in, both in seconds)."""
    events = list(prof.events())
    device = sorted((e for e in events if _is_device(e) and not e.name.startswith(PREFIX)),
                    key=lambda e: e.time_range.start)
    busy_us = sum(e.time_range.end - e.time_range.start for e in device)
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    launches = sum(1 for e in device if not e.name.startswith(("Memcpy", "Memset")))
    # the device time under each range: the device operations inside the
    # range's span on the device timeline (one stream, in order), so kernels
    # launched outside an operator (the hand-written ones, by ctypes) count too
    starts = [e.time_range.start for e in device]
    in_range: dict[str, float] = {}
    for r in events:
        if not (_is_device(r) and r.name.startswith(PREFIX)):
            continue
        label, lo, hi = r.name[len(PREFIX):], r.time_range.start, r.time_range.end
        i = bisect.bisect_left(starts, lo)
        while i < len(device) and device[i].time_range.start <= hi:
            if device[i].time_range.end <= hi:
                in_range[label] = in_range.get(label, 0.0) + (device[i].time_range.end - device[i].time_range.start)
            i += 1
    return {
        "items": items,
        "busy_ms": busy_us / 1e3 / items,
        "launches": launches / items,
        "range_device_ms": {k: v / 1e3 / items for k, v in in_range.items()},
        "busy_s": busy_us / 1e6,
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": _idle_gaps(events, device),
        },
    }


def _idle_gaps(events, device) -> list:
    """Idle device time between consecutive device operations, summed by
    ``<range>/<operator>``: the innermost benchmark range and the innermost
    operator the host was in at each gap's midpoint (``python`` between
    operators)."""
    host = [e for e in events if not _is_device(e)]
    ranges = sorted((e for e in host if e.name.startswith(PREFIX)), key=lambda e: e.time_range.start)
    leaves = sorted((e for e in host if not e.name.startswith(PREFIX) and not e.cpu_children),
                    key=lambda e: e.time_range.start)
    leaf_starts = [e.time_range.start for e in leaves]
    sums: dict[str, float] = {}
    end = None
    for e in device:
        if end is not None and e.time_range.start > end:
            mid = (end + e.time_range.start) / 2
            label = "none"
            for r in ranges:
                if r.time_range.start <= mid <= r.time_range.end:
                    label = r.name[len(PREFIX):]  # later starts are nested deeper
            i = bisect.bisect_right(leaf_starts, mid) - 1
            op = leaves[i].name if i >= 0 and leaves[i].time_range.end >= mid else "python"
            key = f"{label}/{op}"
            sums[key] = sums.get(key, 0.0) + (e.time_range.start - end)
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    return [[k, v / 1e6] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]
