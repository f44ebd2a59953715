"""The control fails where the port passes: the reference computed with TF32
on (the precision below the configurations' FP32) in the port's place
reads over at least one limit of each cell, at sizes a test run can hold.
Needs the card (TF32 exists only there); ``control.py`` takes the same
readings at the cells' own sizes."""

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import tiny_run

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload", ["fusion.bend480", "train.solver448"])
def test_the_control_fails_where_the_port_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, exists only there")
    run = tiny_run(workload, 2**31 + 21, control=True)
    run.device = "cuda"
    out = harness.run_cell(run)
    assert all(v <= lim for v, lim in out["checks"].values()), out["checks"]
    assert any(out["control"][k] > lim for k, (_, lim) in out["checks"].items()), out["control"]
