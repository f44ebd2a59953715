"""A run whose timed path is broken underneath comes out not correct, with
the cells' own limits: for the fusion loop, a frame that leaves its state
unchanged and an answer altered where it is produced; for training, a step
that leaves the weights unchanged and half of the batch left out. Sound
runs of the same sizes come out correct. Runs on the CPU at tiny sizes,
past the harness's look for a card."""

import pytest

from portbench import harness
from portbench.faults import planted
from portbench.tests.helpers import correct, dump, tiny_run


@pytest.mark.parametrize("workload", ["fusion.bend480", "train.solver448"])
def test_a_sound_run_is_correct(workload):
    out = harness.run_cell(tiny_run(workload, 2**31 + 11))
    assert correct(out), dump(out)


@pytest.mark.parametrize("workload, fault", [
    ("fusion.bend480", "unchanged_frame"),
    ("fusion.bend480", "altered_frame"),
    ("train.solver448", "unchanged_step"),
    ("train.solver448", "half_batch"),
])
def test_a_broken_run_is_not_correct(workload, fault):
    with planted(fault):
        out = harness.run_cell(tiny_run(workload, 2**31 + 12))
    assert not correct(out), dump(out)
