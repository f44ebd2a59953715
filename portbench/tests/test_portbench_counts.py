"""The yardstick's operation, byte and FLOP counts: hand counts at tiny
shapes, and the same count whichever implementation runs."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import raster
from portbench.counts.flops import prior_forward_flops
from portbench.tests.helpers import ROOT


def test_b2_hand_count():
    # 4 vertices (12 B each), 2 faces (12 B of indices in, 36 B of corners
    # and a 1 B flag out), the 3x3 intrinsics; 6 operations per corner
    assert raster.b2_work(4, 2) == {"operations": 36, "bytes": 48 + 24 + 36 + 74}


def test_b1_hand_count():
    # one 4x4-pixel image in one 4 px tile, one face whose box (u in
    # 0.2..2.5, v in 1..2) holds pixel centers 1..2 in u and 1..2 in v: 4
    # tests, 1 entry, the bin's -1 end, one distinct face, 16 pixels of
    # outputs (24 B each)
    faces = torch.tensor([[0.2, 1.0, 1.0, 2.5, 1.0, 1.0, 0.2, 2.0, 1.0]])
    table = torch.tensor([[0, -1]], dtype=torch.int32)
    work = raster.b1_work(faces, table, (4, 4), 4)
    assert work == {"operations": 4 * 51 + 21, "bytes": 2 * 4 + 36 + 16 * 24}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_count_equals_the_ports_and_the_references(seed):
    from dynamicfuion_python_tpu_torch.ops.rasterize import rasterize_tiles_work as port_work
    from portbench.reference.ops.rasterize import rasterize_tiles_work as reference_work

    g = torch.Generator().manual_seed(seed)
    h, w, tile = 24, 40, 8
    faces = torch.rand((50, 9), generator=g) * torch.tensor([w, h, 1.0] * 3)
    table = torch.randint(-1, 50, (3 * 5, 12), generator=g, dtype=torch.int32)
    ours = raster.b1_work(faces, table, (h, w), tile, 0.5)
    for theirs in (port_work(faces, table, (h, w), tile, 0.5), reference_work(faces, table, (h, w), tile, 0.5)):
        assert (ours["operations"], ours["bytes"]) == (theirs["operations"], theirs["bytes"])


def _flow_flops(net, h, w):
    color = torch.zeros((1, h, w, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(color, color)
    return counter.get_total_flops()


def test_flop_count_is_the_same_over_the_port_and_the_reference():
    from dynamicfuion_python_tpu_torch.models.pwcnet import PWCNet as PortPWCNet
    from portbench.reference.models.pwcnet import PWCNet

    assert _flow_flops(PortPWCNet().to("meta"), 64, 128) == _flow_flops(PWCNet().to("meta"), 64, 128) > 0


def test_prior_flops_scale_with_the_image():
    config = json.loads((ROOT / "portbench" / "configs" / "fusion_prior_nnrt_448x640.json").read_text())
    small = prior_forward_flops({**config, "input_size": [64, 128]})
    assert prior_forward_flops(config) > 30 * small > 0
