"""The traffic is made from the seed alone: the same seed gives the same
bytes, two seeds differ, and every seed gives the same sizes."""

import numpy as np

from portbench.traffic.bending_plane import BendingPlane
from portbench.traffic.pairs import write_split


def test_bending_plane_same_seed_same_bytes_other_seed_differs():
    plane = BendingPlane(48, 64, 48 * 1.4, period=6)
    a, b, c = plane.frames(2**33 + 1), plane.frames(2**33 + 1), plane.frames(2**33 + 2)
    assert all(np.array_equal(x[i], y[i]) for x, y in zip(a, b) for i in (0, 1))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    assert [x[0].shape for x in a] == [x[0].shape for x in c] and len(a) == len(c) == 6
    # the same scene under other noise: the patch's pixels and colours agree
    assert all(np.array_equal(x[0] > 0, y[0] > 0) and np.array_equal(x[1], y[1]) for x, y in zip(a, c))


def test_bending_plane_is_periodic_and_bends_a_bounded_amount():
    plane = BendingPlane(48, 64, 48 * 1.4)
    assert plane.bend(0) == plane.bend(plane.period) == 0.0
    steps = [abs(plane.bend(t + 1) - plane.bend(t)) for t in range(plane.period)]
    assert max(steps) <= np.pi * plane.amplitude / plane.period + 1e-12


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_split_same_seed_same_bytes_other_seed_differs(tmp_path):
    for name, seed in (("a", 7), ("b", 7), ("c", 8)):
        write_split(tmp_path / name, (48, 64), 3, seed)
    a, b, c = (_files(tmp_path / n) for n in "abc")
    assert a.keys() == c.keys() and a == b
    assert a != c
