"""The segment sums' card forms on the inputs the card's paths give them.

    python -m dynamicfuion_python_tpu_torch.apps.sum_forms

Runs the 480x640 slice (:func:`profile_frame.make_slice`, 5 fitted frames)
and the 448x640 bending plane through a seeded DeformNet prior, keeping the
last call's inputs of every ``segment_sum`` call site and shape; then, for
each, times ``index_add_`` (what the port summed with before), the one-hot
form and the sorted form with CUDA events, checks that each form repeats
bit for bit over 20 calls and reports its largest difference from
``index_add_`` in f64 on the CPU, relative to the largest entry. Prints one
JSON line per site and shape, and the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from pathlib import Path

import torch

from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
from dynamicfuion_python_tpu_torch.apps.profile_frame import PRIOR_IMAGE_SIZE, make_slice, use_fp32_matmuls
from dynamicfuion_python_tpu_torch.models import deform_net, fitter, gn_point_cloud_optimizer
from dynamicfuion_python_tpu_torch.ops import arap, normals
from dynamicfuion_python_tpu_torch.ops import segment_sum as ss
from dynamicfuion_python_tpu_torch.ops.linalg import arrowhead
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

SITES = {"data_term": fitter, "arap": arap, "arrowhead": arrowhead, "normals": normals,
         "prior_gn": gn_point_cloud_optimizer, "deform_net": deform_net}
REPEATS = 20


def _run(params, seq) -> None:
    frames = list(seq)
    pipe = FusionPipeline(params, seq.intrinsics)
    pipe.initialize(frames[0].depth, frames[0].color)
    for f in frames[1:]:
        pipe.process_frame(f.depth, f.color)
    torch.cuda.synchronize()


def capture_site_inputs() -> dict:
    """{(site, shape, segments): (values, seg)} of the last call of each."""
    inputs, originals = {}, {}
    for site, module in SITES.items():
        originals[site] = module.segment_sum

        def keep(values, seg, n, acc=None, _site=site):
            inputs[(_site, tuple(values.shape), n)] = (values.detach().clone(), seg.clone())
            return originals[_site](values, seg, n, acc=acc)

        module.segment_sum = keep
    try:
        _run(*make_slice(frame_count=6))
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "deform_net.pt"
            torch.save(deform_net.seeded_state_dict(deform_net.DeformNet(), torch.Generator().manual_seed(0)), path)
            params, seq = make_slice(frame_count=3, image_size=PRIOR_IMAGE_SIZE)
            _run(apply_overrides(params, ["fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}"]), seq)
    finally:
        for site, module in SITES.items():
            module.segment_sum = originals[site]
    return inputs


def event_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sum_forms: needs a CUDA card")
    use_fp32_matmuls()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for (site, shape, n), (values, seg) in capture_site_inputs().items():
        want = ss._index_add_sum(values.double().cpu(), seg.cpu(), n)
        scale = max(float(want.abs().max()), 1e-30)
        row = {"site": site, "rows_shape": list(shape), "segments": n,
               "chosen": "onehot" if n <= ss.ONEHOT_MAX_SEGMENTS else "sorted",
               "index_add_ms": event_ms(lambda: ss._index_add_sum(values, seg, n))}
        for name, form in (("onehot", ss.segment_sum_onehot), ("sorted", ss.segment_sum_sorted)):
            if name == "onehot" and n > 4 * ss.ONEHOT_MAX_SEGMENTS:
                continue  # the product's work is segments x rows x columns: skipped past 4096 segments
            first = form(values, seg, n)
            row[f"{name}_repeats"] = all(torch.equal(form(values, seg, n), first) for _ in range(REPEATS - 1))
            row[f"{name}_ms"] = event_ms(lambda: form(values, seg, n))
            row[f"{name}_max_err"] = float((first.double().cpu() - want).abs().max()) / scale
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
