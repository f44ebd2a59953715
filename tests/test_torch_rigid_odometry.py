"""Rigid odometry of the port against the JAX package: the zero-ignoring
min-pool, one ICP level, the three-level estimate on the scenes of
``tests/test_odometry_and_io.py::TestRigidOdometry``, and the fixed-count loop
whose device-side flag stops where the JAX ``while_loop`` stops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.ops import rigid_odometry as J
from dynamicfuion_python_tpu.ops.camera import project_points as j_project, unproject_depth_image as j_unproject
from dynamicfuion_python_tpu.ops.linalg import axis_angle_to_matrix as j_rodrigues
from dynamicfuion_python_tpu.ops.normals import point_image_normals as j_normals
from dynamicfuion_python_tpu_torch.ops import rigid_odometry as P
from dynamicfuion_python_tpu_torch.ops.camera import unproject_depth_image as p_unproject
from dynamicfuion_python_tpu_torch.ops.normals import point_image_normals as p_normals

INTR = np.asarray([[160.0, 0.0, 80.0], [0.0, 160.0, 60.0], [0.0, 0.0, 1.0]], np.float32)
H, W = 120, 160


def _wavy_depth(shift_z=0.0):
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 1.2 + 0.08 * np.sin(u / 12) * np.cos(v / 12) + shift_z
    return (z * 1000).astype(np.uint16)


def _rotated_target():
    """The wavy surface rotated by 0.01 rad about y, splatted to its nearest
    pixels (as TestRigidOdometry.test_recovers_small_rotation builds it)."""
    src = jnp.asarray(_wavy_depth())
    pts, mask = j_unproject(src, jnp.asarray(INTR), 1000.0, 5.0)
    rot = j_rodrigues(jnp.asarray([0.0, 0.01, 0.0]))
    moved = pts.reshape(-1, 3) @ rot.T
    uv, _ = j_project(moved, jnp.asarray(INTR))
    u = np.round(np.asarray(uv)[:, 0]).astype(int)
    v = np.round(np.asarray(uv)[:, 1]).astype(int)
    ok = np.asarray(mask).reshape(-1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    tgt = np.zeros((H, W), np.float32)
    tgt[v[ok], u[ok]] = np.asarray(moved)[:, 2][ok] * 1000
    return tgt.astype(np.uint16), np.asarray(rot)


def _t(depth):
    return torch.as_tensor(depth.astype(np.int32))


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_depth_bit_equal(factor, rng):
    depth = _wavy_depth()
    depth[rng.random(depth.shape) < 0.3] = 0  # holes the min-pool must ignore
    depth[:8, :8] = 0  # a fully empty cell
    got = P._downsample_depth(_t(depth), factor).numpy()
    want = np.asarray(J._downsample_depth(jnp.asarray(depth), factor))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got > 0).any()


def _level_inputs(source, target):
    """Full-resolution level inputs for both packages."""
    j_sp, j_sm = j_unproject(jnp.asarray(source).astype(jnp.float32), jnp.asarray(INTR), 1000.0, 3.0)
    j_tp, j_tm = j_unproject(jnp.asarray(target).astype(jnp.float32), jnp.asarray(INTR), 1000.0, 3.0)
    p_sp, p_sm = p_unproject(_t(source).float(), torch.as_tensor(INTR), 1000.0, 3.0)
    p_tp, p_tm = p_unproject(_t(target).float(), torch.as_tensor(INTR), 1000.0, 3.0)
    j_in = (j_sp, j_sm, j_tp, j_normals(j_tp), j_tm, jnp.asarray(INTR))
    p_in = (p_sp, p_sm, p_tp, p_normals(p_tp), p_tm, torch.as_tensor(INTR))
    return j_in, p_in


def test_one_icp_level_matches():
    j_in, p_in = _level_inputs(_wavy_depth(), _wavy_depth(0.01))
    # the same start: a small offset from the truth
    start = np.eye(4, dtype=np.float32)
    start[:3, 3] = [0.002, -0.001, 0.004]
    jt, jr = J._icp_level(*j_in, jnp.asarray(start), 10, 0.07)
    pt, pr = P._icp_level(*p_in, torch.as_tensor(start), 10, 0.07)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    assert abs(float(pr) - float(jr)) <= 1e-5


SCENES = {
    "identity": lambda: (_wavy_depth(), _wavy_depth(), None),
    "z_shift_1cm": lambda: (_wavy_depth(), _wavy_depth(0.01), None),
    "rotation_y_0.01": lambda: (_wavy_depth(), *_rotated_target()),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_multi_scale_matches_jax(scene):
    source, target, rot = SCENES[scene]()
    jt, jr = J.rigid_odometry_multi_scale(jnp.asarray(source), jnp.asarray(target), jnp.asarray(INTR))
    pt, pr = P.rigid_odometry_multi_scale(_t(source), _t(target), torch.as_tensor(INTR))
    pt = pt.numpy()
    np.testing.assert_allclose(pt, np.asarray(jt), atol=1e-4)
    assert abs(float(pr) - float(jr)) <= 1e-5
    # the JAX tests' own gates
    if scene == "identity":
        np.testing.assert_allclose(pt, np.eye(4), atol=1e-4)
        assert float(pr) < 1e-4
    elif scene == "z_shift_1cm":
        np.testing.assert_allclose(pt[:3, 3], [0, 0, 0.01], atol=2e-3)
        assert float(pr) < 2e-3
    else:
        np.testing.assert_allclose(pt[:3, :3], rot, atol=3e-3)


def test_fixed_loop_stops_where_jax_stops():
    """With a coarse update threshold the level converges after a few of
    its 10 iterations: the port's frozen result is exactly its own result
    after that many iterations, and matches the JAX while_loop's."""
    j_in, p_in = _level_inputs(_wavy_depth(), _wavy_depth(0.01))
    eye = np.eye(4, dtype=np.float32)
    threshold = 1e-4
    jt, jr = J._icp_level(*j_in, jnp.asarray(eye), 10, 0.07, update_threshold=threshold)
    pt, pr = P._icp_level(*p_in, torch.as_tensor(eye), 10, 0.07, update_threshold=threshold)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
    assert abs(float(pr) - float(jr)) <= 1e-5
    ran = [
        n
        for n in range(1, 11)
        if torch.equal(P._icp_level(*p_in, torch.as_tensor(eye), n, 0.07, update_threshold=0.0)[0], pt)
    ]
    assert ran and ran[0] < 10, ran
    # iterating on changes the result: the flag really stopped the loop
    full, _ = P._icp_level(*p_in, torch.as_tensor(eye), 10, 0.07, update_threshold=0.0)
    assert not torch.equal(full, pt)


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_result_independent_of_the_thread_count(threads):
    """The odometry's result does not depend on the CPU thread count.

    ``test_torch_entry_point.py::test_rigid_pipeline_node_translations`` was
    unsteady across whole-suite runs: the normal equations' sums over pixels
    were f32 matrix products, which a CPU splits by its thread count, so the
    pose of the bending plane's frame 2 moved by up to 2.5e-7 between 1-8
    threads and the fits after it moved the final node translations by up
    to 1.5e-4 m, above that test's 1e-4 m. The sums now accumulate in f64."""
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence

    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    pairs = [(frames[1].depth, frames[2].depth, seq.intrinsics), (_wavy_depth(), _rotated_target()[0], INTR)]
    default = torch.get_num_threads()
    for source, target, k in pairs:
        args = (_t(source), _t(target), torch.as_tensor(k))
        want = P.rigid_odometry_multi_scale(*args, depth_max=2.0)
        torch.set_num_threads(threads)
        try:
            got = P.rigid_odometry_multi_scale(*args, depth_max=2.0)
        finally:
            torch.set_num_threads(default)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the CUDA graph path's choice and key (the replay itself: gpu tests) -----


def test_cpu_calls_run_eagerly(monkeypatch):
    """CPU tensors take the eager path, count ``odometry.eager`` and give the
    eager loop's result; nothing is captured."""
    from dynamicfuion_python_tpu_torch.utils import trace

    monkeypatch.setattr(P, "_GRAPHS", {})
    source, target = _t(_wavy_depth()), _t(_wavy_depth(0.01))
    before = trace.snapshot()["counters"]
    got = P.rigid_odometry_multi_scale(source, target, torch.as_tensor(INTR))
    after = trace.snapshot()["counters"]
    want = P._odometry(source, target, torch.as_tensor(INTR), None, (4, 2, 1), 10, 1000.0, 3.0, 0.07)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert after.get("odometry.eager", 0) == before.get("odometry.eager", 0) + 1
    for name in ("odometry.graph_captures", "odometry.graph_replays"):
        assert after.get(name, 0) == before.get(name, 0)
    assert P._GRAPHS == {}


def test_a_process_group_never_reaches_the_graph(monkeypatch):
    """With a group the call runs eagerly on any device, its all_reduce
    outside any graph: the choice, and a one-rank stub group on CPU tensors
    whose sums pass through, giving the ungrouped result."""
    from dynamicfuion_python_tpu_torch.parallel import spmd

    cuda = torch.device("cuda")
    assert P._replays(cuda, None) and not P._replays(cuda, object())
    assert not P._replays(torch.device("cpu"), None)
    reduced = []
    monkeypatch.setattr(spmd, "row_range", lambda height, group: (0, height))
    monkeypatch.setattr(spmd, "all_reduce_sum", lambda tensors, group: reduced.append(group) or list(tensors))
    monkeypatch.setattr(P, "_GRAPHS", {})
    args = (_t(_wavy_depth()), _t(_wavy_depth(0.01)), torch.as_tensor(INTR))
    stub = object()
    got = P.rigid_odometry_multi_scale(*args, group=stub)
    want = P.rigid_odometry_multi_scale(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert reduced and all(g is stub for g in reduced) and P._GRAPHS == {}


_KEY_ARGS = dict(levels=(4, 2, 1), iterations_per_level=10, depth_scale=1000.0, depth_max=3.0,
                 distance_threshold=0.07)
_KEY_CHANGES = {
    "shape": lambda a, s: ((a[0][:60], a[1][:60], *a[2:]), s),
    "dtype": lambda a, s: ((a[0].float(), a[1].float(), *a[2:]), s),
    "levels": lambda a, s: (a, {**s, "levels": (2, 1)}),
    "iterations_per_level": lambda a, s: (a, {**s, "iterations_per_level": 5}),
    "depth_scale": lambda a, s: (a, {**s, "depth_scale": 5000.0}),
    "depth_max": lambda a, s: (a, {**s, "depth_max": 2.0}),
    "distance_threshold": lambda a, s: (a, {**s, "distance_threshold": 0.05}),
    "initial_transform": lambda a, s: ((*a[:3], torch.eye(4)), s),
}


@pytest.mark.parametrize("change", [*_KEY_CHANGES, "tf32", "matmul_precision"])
def test_graph_key_changes_with_what_the_capture_depends_on(change):
    """Each of shape, dtype, levels, iterations, depth scale, depth cut-off,
    distance threshold, the presence of a start transform and the TF32
    settings gives another key; new values in the same tensors do not."""
    args = (_t(_wavy_depth()), _t(_wavy_depth(0.01)), torch.as_tensor(INTR), None)
    key = P._graph_key(*args, **_KEY_ARGS)
    assert P._graph_key(_t(_wavy_depth(0.02)), _t(_wavy_depth()), torch.as_tensor(INTR) * 2, None,
                        **_KEY_ARGS) == key
    if change in _KEY_CHANGES:
        changed_args, changed_settings = _KEY_CHANGES[change](args, _KEY_ARGS)
        assert P._graph_key(*changed_args, **changed_settings) != key
        return
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        if change == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = not tf32
        else:
            torch.set_float32_matmul_precision("medium" if precision != "medium" else "highest")
        assert P._graph_key(*args, **_KEY_ARGS) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
