"""The SOD cell, ``sod.u2net320``, on the CPU at a tiny size, past the
harness's look for a card: a sound run is correct and its traced segment
feeds the readers; each fault planted in the port (``faults_sod.py``)
fails the check it is aimed at; the seeded weights are the same tensors for
the port and the reference; the configuration's FLOPs and plan are the
counts' and the published U2NET's; the import rules cover the new files."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import ROOT, correct, dump

CELL = "sod.u2net320"
# U2NetLite(mid=4, out=8)'s plan, 48x64 frames at a 64x64 input, batches of 3
TINY_PLAN = {"encoder": [[7, 4, 8], [6, 4, 8], [5, 4, 8], [4, 4, 8], [None, 4, 8], [None, 4, 8]],
             "decoder": [[None, 4, 8], [4, 4, 8], [5, 4, 8], [6, 4, 8], [7, 4, 8]]}
TINY = ({"stages": TINY_PLAN, "input_size": [64, 64], "batch_frames": 3},
        {"frame_size": [48, 64], "frames": 8, "check_within": 4, "trace_batches": 1})


def tiny_run(seed: int, trace: bool = False) -> harness.Run:
    bench = harness.load_bench(ROOT)
    cell, config, traffic, limits = harness.cell_files(bench, CELL, ROOT)
    config, traffic = {**config, **TINY[0]}, {**traffic, **TINY[1]}
    return harness.Run(CELL, seed, 0.1, trace, cell, config, traffic, limits, time.perf_counter(), device="cpu")


@pytest.fixture(autouse=True)
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def test_a_sound_traced_run_is_correct_and_feeds_the_readers():
    bench = harness.load_bench(ROOT)
    run = tiny_run(2**31 + 21, trace=True)
    out = harness.run_cell(run)
    assert correct(out), dump(out)
    assert {k: v for k, (v, _) in out["checks"].items()} == {"input": 0.0, "prob": out["checks"]["prob"][0],
                                                             "mask": 0.0}
    assert out["attempted"] % 3 == 0 and out["attempted"] >= 2 * 3 and out["failed"] == 0
    line = harness.result_line(bench, run, out, "cpu")
    # no device rows on the CPU: the device readers leave their metrics out
    assert set(line["metrics"]) == {"sod.host_ms", "host_reads.sod"}, line["metrics"]
    counters = out["trace"]["counters"]
    assert line["metrics"]["host_reads.sod"]["value"] == counters["host_read.sod.masks"] / counters["sod.frames"]


@pytest.mark.parametrize("fault, check", [
    ("bilinear_resize", "input"),
    ("batchnorm_training", "prob"),
    ("previous_masks", "mask"),
])
def test_a_broken_run_fails_its_check(fault, check):
    from portbench.faults_sod import planted

    with planted(fault):
        out = harness.run_cell(tiny_run(2**31 + 22))
    value, limit = out["checks"][check]
    assert value > limit, dump(out)


def test_the_port_and_the_reference_get_the_same_weights():
    from dynamicfuion_python_tpu_torch.models.u2net import U2NET_PLAN as PORT_PLAN, U2NetFull
    from portbench.counts.sod import plan_of
    from portbench.reference.models.u2net import U2NET_PLAN, U2Net
    from portbench.weights_sod import u2net_state

    config = json.loads((ROOT / "portbench" / "configs" / "sod_u2net_deepdeform_480x640.json").read_text())
    assert plan_of(config) == U2NET_PLAN == PORT_PLAN
    state = u2net_state(2**31 + 23, "cpu", U2NET_PLAN)
    port, reference = U2NetFull(), U2Net(U2NET_PLAN)
    port.load_state_dict(state, strict=True)
    reference.load_state_dict(state, strict=True)
    theirs = reference.state_dict()
    assert all(torch.equal(v, theirs[k]) for k, v in port.state_dict().items())
    assert sum(p.numel() for p in port.parameters()) == config["parameters"] == 44_009_869
    again = u2net_state(2**31 + 23, "cpu", U2NET_PLAN)
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    assert not torch.equal(state["outconv.weight"], u2net_state(2**31 + 24, "cpu", U2NET_PLAN)["outconv.weight"])


def test_the_configurations_flops_are_the_counts():
    from portbench.counts.sod import sod_forward_flops

    config = json.loads((ROOT / "portbench" / "configs" / "sod_u2net_deepdeform_480x640.json").read_text())
    assert sod_forward_flops(config) == config["flops"]["sod_forward"] == 117_196_492_800


def test_the_import_rules_cover_the_new_files():
    from portbench.tests import test_portbench_imports as rules

    new = ["reference/apps/sod.py", "reference/models/u2net.py", "weights_sod.py", "faults_sod.py",
           "counts/sod.py", "check/sod.py", "drivers/sod.py", "traffic/sod_frames.py",
           "metrics/sod.forward.device_ms.py", "metrics/mfu.sod.py"]
    sources = {p.relative_to(ROOT / "portbench").as_posix(): p for p in rules.SOURCES}
    for name in new:
        names = {n.split(".")[0] for n in rules._imports(sources[name])}
        assert not names & set(harness.FORBIDDEN), name
        if name.split("/")[0] in ("reference", "traffic", "counts", "check", "weights_sod.py"):
            assert rules.PORT not in names, name
