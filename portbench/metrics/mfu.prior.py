"""The frame's share of the card's FP32 peak with the prior on, in %:
DeformNet's forward FLOPs per frame (counted once by
``portbench/counts/flops.py`` over the reference's network at the cell's
shapes, stored in the configuration) over the window's mean frame time at
67 TFLOP/s. A lower bound: the fusion loop's own arithmetic is not
counted."""

from portbench.counts import PEAK_FP32_FLOPS as PEAK


def read(trace):
    flops = trace.get("flops_per_frame")
    if not flops:
        return None
    return 100.0 * flops / (trace["frame_ms"] / 1e3 * PEAK)
