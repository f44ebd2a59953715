"""The SOD frame's share of the card's FP32 peak, in %: U²-Net's forward
FLOPs per frame (counted once by ``portbench/counts/sod.py`` over the
reference's network at the cell's input size, stored in the configuration)
over the window's mean frame time at 67 TFLOP/s. The whole frame's share:
the resizes and normalizations are not counted, so a lower bound. Read only
where the traced batches ran on the card."""

from portbench.counts import PEAK_FP32_FLOPS as PEAK


def read(trace):
    flops = trace.get("sod_forward_flops")
    if not flops or trace.get("busy_ms", 0.0) <= 0:
        return None
    return 100.0 * flops / (trace["frame_ms"] / 1e3 * PEAK)
