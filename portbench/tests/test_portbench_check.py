"""The fusion check keeps its copies of the program's state on the host, so
the card's memory peak that a run reports is the program's own; its copies
share no storage with the state the loop goes on to change."""

import dataclasses
from types import SimpleNamespace

import torch

from portbench.check import fusion as check


@dataclasses.dataclass(frozen=True)
class _State:
    values: torch.Tensor
    size: int = 3


def _pipe():
    return SimpleNamespace(
        volume=_State(torch.arange(6.0)), warp_field=_State(torch.ones(4, 3)), extrinsics=torch.eye(4),
        previous_depth=torch.zeros(2, 3, dtype=torch.int32), frames_processed=5, _mesh_v_cap=8, _mesh_t_cap=16,
        _count_host=(4, 2), canonical_vertices=torch.rand(8, 3),
        canonical_triangles=torch.arange(48, dtype=torch.int32).reshape(16, 3) % 8, canonical_triangle_count=2,
    )


def _tensors(snapshot):
    yield snapshot["volume"].values
    yield snapshot["warp_field"].values
    yield from (snapshot[k] for k in ("extrinsics", "previous_depth"))
    yield from snapshot["mesh"]


def test_a_snapshot_is_a_host_copy():
    pipe = _pipe()
    snap = check.snapshot(pipe)
    live = [pipe.volume.values, pipe.warp_field.values, pipe.extrinsics, pipe.previous_depth,
            pipe.canonical_vertices, pipe.canonical_triangles]
    for t in _tensors(snap):
        assert t.device.type == "cpu"
        assert all(t.untyped_storage().data_ptr() != u.untyped_storage().data_ptr() for u in live)
    assert snap["mesh"][1].shape == (2, 3) and snap["mesh_state"] == {"v_cap": 8, "t_cap": 16, "count_host": [4, 2]}


def test_a_snapshot_does_not_follow_later_changes():
    pipe = _pipe()
    snap = check.snapshot(pipe)
    before = [t.clone() for t in _tensors(snap)]
    for t in (pipe.volume.values, pipe.warp_field.values, pipe.extrinsics, pipe.canonical_vertices):
        t.add_(1)
    pipe.previous_depth.add_(1)
    pipe.canonical_triangles.add_(1)
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(snap)))


def test_prior_outputs_are_host_copies():
    class Net:
        def forward(self, out):
            return out

    out = SimpleNamespace(flows=[torch.ones(2, 2)], mask_prediction=torch.ones(3), node_rotations=torch.ones(1, 3, 3),
                          node_translations=torch.ones(1, 3))
    into = {}
    with check.prior_outputs(Net, into):
        Net().forward(out)
    assert set(into) == {"flow", "mask", "prior_r", "prior_t"}
    out.flows[0].add_(1)
    assert all(v.device.type == "cpu" for v in into.values()) and torch.equal(into["flow"], torch.ones(2, 2))
