"""The training step's share of the card's FP32 peak, in %: forward and
backward FLOPs of a step (counted once by ``portbench/counts/flops.py``
over the reference's step at the cell's shapes, stored in the
configuration) over the window's mean step time at 67 TFLOP/s."""

from portbench.counts import PEAK_FP32_FLOPS as PEAK


def read(trace):
    flops = trace.get("flops_per_step")
    if not flops:
        return None
    return 100.0 * flops / (trace["step_ms"] / 1e3 * PEAK)
