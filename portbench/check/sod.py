"""The SOD cell's comparison: what the port's batched path produced for the
checked frames against the reference's frame-by-frame path
(``portbench/reference/apps/sod.py``) on the same PNGs and weights.

Numbers compared (the worst over the checked frames):
  - ``input``: the largest absolute difference of the network's input. The
    resize is integer arithmetic and the normalization the same IEEE
    operations in the same order, so its limit is 0;
  - ``prob``: the largest absolute difference over the fused output and
    the six side outputs, the reference's forward at batch 1 on its own
    input; its limit is set from readings (PERF.md);
  - ``mask``: the pixels where a written mask differs from the reference's
    host post-processing of the port's own fused output; limit 0.

The exact numbers' limits are fixed here, not read: a limit file holds the
numbers that rounding moves. A checked frame whose fused output spans less
than ``MIN_RANGE`` or whose mask is constant would let every number pass
whatever the path did, so it fails the run instead.
"""

from __future__ import annotations

import numpy as np

EXACT = {"input": 0.0, "mask": 0.0}
MIN_RANGE = 0.05


def saturated(recorded: list[dict]) -> list[str]:
    """The checked frames (by file name) that are too flat to check."""
    return [r["path"].name for r in recorded
            if float(r["probs"][0].max() - r["probs"][0].min()) < MIN_RANGE or r["mask"].min() == r["mask"].max()]


def gaps(recorded: list[dict], model, resize_to, threshold, tf32: bool = False) -> dict:
    """``recorded``: per checked frame, ``path`` (its PNG), ``input`` (f32
    [3, h, w]), ``probs`` (fused, side1 .. side6, each f32 [h, w]) and
    ``mask`` (the written uint8 [H, W]), all host copies of what the port
    produced. ``model``: the reference network with the run's weights, in
    eval mode on the device."""
    from portbench.reference.apps import sod
    from portbench.reference.data.images import load_color

    out = {"input": 0.0, "prob": 0.0, "mask": 0.0}
    for r in recorded:
        rgb = load_color(r["path"])
        x_ref, probs_ref = sod.frame_outputs(model, rgb, resize_to, tf32)
        out["input"] = max(out["input"], float(np.abs(r["input"] - x_ref).max()))
        out["prob"] = max(out["prob"], max(float(np.abs(p - q).max()) for p, q in zip(r["probs"], probs_ref)))
        want = sod.mask_from_probability(r["probs"][0], rgb.shape[:2], threshold)
        out["mask"] = max(out["mask"], float(np.count_nonzero(want != r["mask"])))
    return out
