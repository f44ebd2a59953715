"""Kernels B1 and B2's share of their roofline, in %: the least time the
traced calls could take (``portbench/counts/raster.py``: bytes read once
and written once at 3.35 TB/s, or FP32 operations at 67 TFLOP/s, whichever
is longer, per call) over the device time under their calls."""


def read(trace):
    r = trace.get("raster")
    if not r or r["device_ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["device_ms"]
