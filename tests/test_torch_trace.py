"""The port's tracing (``utils/trace.py``) on a 64x96 bending-plane frame on
the CPU: off, it keeps nothing and opens no profiler range; on, its spans
nest as the frame's stages do and leave the pipeline's state bit for bit as
it is; the GN loop's own counter sees the convergence exit that the padded
diagnostics hide; every host read of the frame is counted at its site. And
``read_profile`` on a hand-made device timeline."""

import contextlib
import copy
import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu_torch.settings import Parameters
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

OVERRIDES = [
    "tsdf.voxel_size=0.01",
    "tsdf.sdf_truncation_distance=0.04",
    "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12",
    "graph.layer_count=2",
    "graph.erosion_num_iterations=1",
    "alignment.max_iteration_count=2",
    "alignment.arap_term_weight=20.0",
    "fusion.far_clip_distance=2.0",
    "fusion.extraction_max_triangles=60000",
    "fusion.mesh_capacity_hint=65536",
    "telemetry.print_runtime=false",
]
# the frame's stages, each a child of ``frame``; GN's parts, each a child of
# ``fit.iteration``
STAGES = {"odometry", "observe", "fit", "volume", "mesh", "metrics"}
GN_PARTS = {"fit.raster", "fit.data_term", "fit.arap", "fit.solve", "fit.guard"}


class _Ranges:
    """Stands in for ``torch.profiler.record_function``: records the name of
    each profiler range opened and opens it."""

    def __init__(self):
        self.names = []
        self._real = torch.profiler.record_function

    def __call__(self, name):
        self.names.append(name)
        return self._real(name)


class _Reads(TorchDispatchMode):
    """Counts each device-to-host read (``_local_scalar_dense``) and each
    ``torch.unique`` by the innermost span open when it runs."""

    def __init__(self):
        super().__init__()
        self.by_span: dict[tuple, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = {"_local_scalar_dense": "read", "unique_dim": "unique"}.get(func.__name__.split(".")[0])
        if kind:
            open_spans = [s.name for s in trace.spans() if not s.end_ns]
            key = (kind, open_spans[-1] if open_spans else None)
            self.by_span[key] = self.by_span.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _state(pipe) -> list[torch.Tensor]:
    f, v = pipe.warp_field, pipe.volume
    return [f.node_rotations, f.node_translations, v.tsdf, v.weight, v.color, v.slot_keys, pipe.extrinsics,
            pipe.canonical_vertices, pipe.canonical_triangles, torch.tensor(pipe.canonical_triangle_count)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for the file's frames: the suite's workers share the
    cores, and under that load a frame's many small operators ran 2.5 times
    slower with a thread per core than with one."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def warm(one_thread):
    """A pipeline after ``initialize`` and one frame (so the next frame runs
    the odometry), and the next frame."""
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    pipe = FusionPipeline(apply_overrides(Parameters(), OVERRIDES), seq.intrinsics, device="cpu")
    pipe.fitter_config = dataclasses.replace(pipe.fitter_config, max_faces_per_bin=1024)
    pipe.initialize(frames[0].depth, frames[0].color)
    pipe.process_frame(frames[1].depth, frames[1].color)
    return pipe, frames[2]


@pytest.fixture(scope="module")
def runs(warm):
    """The next frame from the same state with tracing off and on, each with
    the profiler ranges it opened, and with tracing on the reads it made. An
    update threshold no step stays above ends the fit after its first GN
    iteration."""
    out = {}
    for on in (False, True):
        pipe, frame = copy.deepcopy(warm[0]), warm[1]
        pipe.fitter_config = dataclasses.replace(pipe.fitter_config, min_update_threshold=1e9)
        ranges, reads = _Ranges(), _Reads()
        real = torch.profiler.record_function
        torch.profiler.record_function = ranges
        trace.reset()
        trace.enable(on)
        try:
            with reads if on else contextlib.nullcontext():
                metrics = pipe.process_frame(frame.depth, frame.color)
            out[on] = {"state": _state(pipe), "ranges": ranges.names, "spans": trace.spans(),
                       "snapshot": trace.snapshot(), "reads": reads.by_span, "metrics": metrics,
                       "frame": pipe.frames_processed}
        finally:
            torch.profiler.record_function = real
            trace.enable(False)
            trace.reset()
    return out


def test_off_keeps_no_span_and_opens_no_range(runs):
    """With tracing off a frame opens no profiler range (a ``torch.profiler``
    run would hold no ``dfu::`` row) and keeps no span; counters count."""
    off = runs[False]
    assert off["ranges"] == [] and off["spans"] == [] and off["snapshot"]["spans"] == {}
    assert off["snapshot"]["counters"]["frames"] == 1
    assert off["snapshot"]["counters"]["host_read.frame.valid_solve"] == 1


def test_spans_nest_as_the_frame_and_share_its_id(runs):
    on = runs[True]
    spans = on["spans"]
    assert on["ranges"] == [trace.PREFIX + s.name for s in spans]  # each span is a profiler range
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    assert {s.item for s in spans} == {on["frame"]}
    parents = {}
    for s in spans:
        parents.setdefault(s.name, set()).add(spans[s.parent].name if s.parent >= 0 else None)
    assert parents["frame"] == {None}
    assert STAGES <= {n for n, p in parents.items() if p == {"frame"}}
    assert parents["fit.setup"] == parents["fit.iteration"] == {"fit"}
    assert all(parents[n] == {"fit.iteration"} for n in GN_PARTS)
    assert parents["host_read.fit.exit"] == {"fit.iteration"}
    assert parents["host_read.arrowhead.tries"] == {"fit.solve"}
    assert parents["host_read.mesh.counts"] == {"mesh"} and parents["host_read.frame.metrics"] == {"metrics"}
    for row in on["snapshot"]["spans"].values():
        assert 0 <= row["self_ms"] <= row["total_ms"]


def test_tracing_leaves_the_state_bit_for_bit(runs):
    assert all(torch.equal(a, b) for a, b in zip(runs[False]["state"], runs[True]["state"]))
    assert runs[False]["snapshot"]["counters"] == runs[True]["snapshot"]["counters"]


def test_host_read_counters_count_every_read_at_its_site(runs):
    on = runs[True]
    reads = on["reads"]
    counters = {k: v for k, v in on["snapshot"]["counters"].items() if k.startswith("host_read.")}
    # no read outside a host_read span
    assert {span for (kind, span) in reads if kind == "read"} <= set(counters), reads
    for site, n in counters.items():
        kind = "unique" if site == "host_read.volume.unique" else "read"
        assert reads.get((kind, site)) == n, (site, n, reads)
    iterations = len(on["metrics"]["data_loss"])
    assert counters["host_read.frame.metrics"] == 5 * iterations + 3
    assert counters["host_read.mesh.counts"] == 2 and counters["host_read.frame.valid_solve"] == 1
    assert counters["host_read.arrowhead.tries"] == 3 * counters["host_read.fit.exit"]


def test_gn_iteration_counter_sees_the_early_exit(warm, runs):
    """The fit exits after its first iteration: the loop's counter reads 1,
    while the diagnostics, padded to the schedule, still hold
    ``max_iteration_count`` rows."""
    counters, metrics = runs[False]["snapshot"]["counters"], runs[False]["metrics"]
    assert warm[0].params.alignment.max_iteration_count == len(metrics["data_loss"]) == 2
    assert counters["fit.gn_iterations"] == counters["fit.early_exits"] == counters["host_read.fit.exit"] == 1


def _evt(name, start, end, device=True):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=start, end=end))


def test_read_profile_on_a_hand_made_timeline():
    """Host spans ``fit`` [0, 100] holding ``fit.data_term`` [10, 60]; on the
    device their ranges [5, 110] and [12, 70], kernels at [12, 30], [40, 70]
    (a copy) and [90, 100] and one outside every range at [130, 140]. Gaps:
    30-40 (midpoint 35, in ``fit.data_term``), 70-90 (80, in ``fit``) and
    100-130 (115, outside)."""
    p = trace.PREFIX
    events = [
        _evt(p + "fit", 0, 100, device=False), _evt(p + "fit.data_term", 10, 60, device=False),
        _evt(p + "fit", 5, 110), _evt(p + "fit.data_term", 12, 70),
        _evt("gemm", 12, 30), _evt("Memcpy DtoD", 40, 70), _evt("cat", 90, 100), _evt("later", 130, 140),
    ]
    got = trace.read_profile(events)
    assert got["device_ms"] == {"fit": 0.058, "fit.data_term": 0.048}
    assert got["launches"] == {"fit": 2, "fit.data_term": 1}
    assert got["idle_ms"] == {"none": 0.03, "fit": 0.02, "fit.data_term": 0.01}


def test_read_profile_counts_a_kernel_once_under_a_repeated_range():
    """The profiler may give one span's device-side range as several rows
    (a U2NET forward's range came twice on the card, the second inside the
    first): the kernels under them count once; a later range of the same
    name that does not overlap counts on its own."""
    p = trace.PREFIX
    events = [
        _evt(p + "sod.forward", 0, 100), _evt(p + "sod.forward", 40, 80), _evt(p + "sod.forward", 200, 260),
        _evt("conv", 0, 50), _evt("conv", 50, 100), _evt("conv", 200, 260),
    ]
    got = trace.read_profile(events)
    assert got["device_ms"] == {"sod.forward": 0.16}
    assert got["launches"] == {"sod.forward": 3}
