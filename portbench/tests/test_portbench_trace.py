"""The spans: ``Ranges`` wraps a function of the port wherever it was
imported by name, records its calls and restores it; ``summarize`` reads a
profile without device rows as nothing to read, so readers leave their
metrics out."""

import torch

from portbench import harness
from portbench.tests.helpers import ROOT
from portbench.trace import Ranges, summarize


def test_ranges_wrap_record_and_restore():
    from dynamicfuion_python_tpu_torch.apps import fusion_pipeline
    from dynamicfuion_python_tpu_torch.ops import camera

    original = camera.unproject_depth_image
    assert fusion_pipeline.unproject_depth_image is original
    ranges = Ranges([("unproject", "ops.camera", "unproject_depth_image"), ("absent", "ops.camera", "no_such")],
                    record=("unproject",))
    with ranges, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert fusion_pipeline.unproject_depth_image is not original
        depth = torch.full((4, 6), 1000, dtype=torch.int32)
        fusion_pipeline.unproject_depth_image(depth, torch.eye(3), 1000.0, 3.0)
    assert camera.unproject_depth_image is original and fusion_pipeline.unproject_depth_image is original
    assert len(ranges.calls["unproject"]) == 1
    trace = summarize(prof, 1)
    assert trace["busy_ms"] == 0 and trace["launches"] == 0 and trace["range_device_ms"] == {}
    trace.update(untraced_ms=1.0, raster={"bound_ms": 1.0, "device_ms": 0.0}, frame_ms=1.0, step_ms=1.0)
    for name in ("idle_share.frame", "launches.frame", "fit.device_ms", "raster.roofline_share", "mfu.prior"):
        assert harness.reader(name, ROOT).read(trace) is None
