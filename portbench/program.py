"""The port's own counters (``dynamicfuion_python_tpu_torch/utils/trace.py``)
as a run's per-layer readers see them: the counters of the run's process,
always on, kept over every frame the run fed the pipeline (set-up, window,
the frames past it, the traced segment; the check's reference counts
nothing), and ``initialize``'s too. A port without the module has nothing
to read."""

from __future__ import annotations


def port_counters() -> dict[str, int] | None:
    """The port's counters in this process, or None where the port has no
    ``utils/trace.py``."""
    try:
        from dynamicfuion_python_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()["counters"]


def per_frame(trace: dict, prefixes: str | tuple[str, ...]) -> float | None:
    """The sum of the counters whose names start with one of ``prefixes``
    over the counter ``frames`` (one per ``process_frame``), where the run
    traced a segment (its reader dict has ``items``) and fed frames."""
    counters = port_counters() if trace.get("items") else None
    if not counters or not counters.get("frames"):
        return None
    return sum(v for k, v in counters.items() if k.startswith(prefixes)) / counters["frames"]
