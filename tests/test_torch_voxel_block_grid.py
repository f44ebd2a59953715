"""PyTorch port vs JAX package: voxel block grid activation, rigid and
non-rigid integration (from a converted warp field) and the welded
marching-cubes mesh the fitter consumes."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfuion_python_tpu.apps.fusion_pipeline import _volume_update_program
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.models.voxel_block_grid import (
    VoxelBlockGrid as JV,
    extract_mesh_fitter_arrays as j_extract,
)
from dynamicfuion_python_tpu.models.warp_field import HierarchicalGraphWarpField as JH, NodeCoverageMethod
from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import volume_update
from dynamicfuion_python_tpu_torch.models.voxel_block_grid import (
    VoxelBlockGrid as PV,
    extract_mesh_fitter_arrays as p_extract,
)
from dynamicfuion_python_tpu_torch.utils.state_conversion import (
    voxel_block_grid_from_numpy,
    warp_field_from_numpy,
)

GRID = dict(capacity=512, voxel_size=0.01, block_resolution=8, sdf_truncation_distance=0.04, depth_scale=1000.0, depth_max=2.0)


def _state(obj) -> dict:
    return {f.name: (np.array(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _depth(frame):
    return torch.as_tensor(frame.depth.astype(np.int32))


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticBendingPlaneSequence(frame_count=3, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    frames = list(seq)
    k = seq.intrinsics
    jv = JV.create(**GRID)
    pv = PV.create(**GRID, device="cpu")
    d0 = frames[0]
    jkeys = jv.compute_unique_block_coordinates(jnp.asarray(d0.depth), jnp.asarray(k), stride=2)
    pkeys = pv.compute_unique_block_coordinates(_depth(d0), torch.as_tensor(k), stride=2)
    jv, pv = jv.activate(jkeys), pv.activate(pkeys)
    jv = jv.integrate(jnp.asarray(d0.depth), jnp.asarray(k), color=jnp.asarray(d0.color, jnp.float32) / 255.0)
    pv = pv.integrate(_depth(d0), torch.as_tensor(k), color=torch.as_tensor(d0.color).float() / 255.0)
    return dict(frames=frames, k=k, jkeys=jkeys, pkeys=pkeys, jv=jv, pv=pv)


def test_activate(scene):
    np.testing.assert_array_equal(scene["pkeys"].numpy(), np.asarray(scene["jkeys"]))
    for name in ("slot_keys", "sorted_keys", "slot_of_sorted"):
        np.testing.assert_array_equal(getattr(scene["pv"], name).numpy(), np.asarray(getattr(scene["jv"], name)))
    assert int(scene["pv"].occupied_count()) > 100


def test_activate_with_fewer_candidates_than_slots():
    """A candidate list shorter than the block table (the 16x16 default
    scene's first frame has 1728 keys for 2048 slots): the port indexed past
    its end, where the JAX gather clamps."""
    keys = np.full((40,), 2**31 - 1, np.int32)
    keys[:5] = [(512 << 20) | (512 << 10) | (512 + i) for i in (3, 1, 4, 1, 5)]
    jv = JV.create(capacity=64).activate(jnp.asarray(keys))
    pv = PV.create(capacity=64, device="cpu").activate(torch.as_tensor(keys))
    for name in ("slot_keys", "sorted_keys", "slot_of_sorted"):
        np.testing.assert_array_equal(getattr(pv, name).numpy(), np.asarray(getattr(jv, name)))
    assert int(pv.occupied_count()) == 4


def test_rigid_integrate(scene):
    jv, pv = scene["jv"], scene["pv"]
    np.testing.assert_allclose(pv.tsdf.numpy(), np.asarray(jv.tsdf), atol=1e-5)
    np.testing.assert_array_equal(pv.weight.numpy(), np.asarray(jv.weight))
    np.testing.assert_allclose(pv.color.numpy(), np.asarray(jv.color), atol=1e-5)


def test_extract_mesh_fitter_arrays(scene):
    ja = j_extract(scene["jv"], 16384, 8192, 0.0)
    pa = p_extract(scene["pv"], 16384, 8192, 0.0)
    assert int(pa[2]) == int(ja[2]) and int(pa[3]) == int(ja[3]) > 1000
    np.testing.assert_array_equal(pa[1].numpy(), np.asarray(ja[1]))
    # XLA fuses the edge interpolation into FMAs: vertices agree to 1 ulp
    np.testing.assert_allclose(pa[0].numpy(), np.asarray(ja[0]), rtol=0, atol=1e-7)


def test_integrate_non_rigid_from_converted_field(scene, rng):
    jv, frames, k = scene["jv"], scene["frames"], scene["k"]
    verts = np.asarray(j_extract(jv, 16384, 8192, 0.0)[0])[:2000]
    jf = JH.build(
        verts[::25], node_coverage=0.12, layer_count=2, anchor_count=4,
        minimum_valid_anchor_count=3, threshold_nodes_by_distance=True,
        coverage_method=NodeCoverageMethod.FIXED,
    )
    jf = jf.replace(node_translations=jnp.asarray(rng.normal(0, 0.003, (jf.num_nodes, 3)).astype(np.float32)))
    pf = warp_field_from_numpy(_state(jf), device="cpu")
    pv = voxel_block_grid_from_numpy(_state(jv), device="cpu")
    d, c = frames[1].depth, frames[1].color
    jv2, jn = _volume_update_program(jv, jf, jnp.asarray(d), jnp.asarray(c), jnp.asarray(k), jnp.eye(4), jnp.asarray(True), 512, True, 1000.0, 2.0)
    pv2, pn = volume_update(pv, pf, torch.as_tensor(d.astype(np.int32)), torch.as_tensor(c), torch.as_tensor(k), 512, 1000.0, 2.0)
    assert int(pn) == int(jn) > 100
    np.testing.assert_array_equal(pv2.slot_keys.numpy(), np.asarray(jv2.slot_keys))
    np.testing.assert_array_equal(pv2.weight.numpy(), np.asarray(jv2.weight))
    assert (np.asarray(jv2.weight) != np.asarray(jv.weight)).any()
    np.testing.assert_allclose(pv2.tsdf.numpy(), np.asarray(jv2.tsdf), atol=1e-5)
    np.testing.assert_allclose(pv2.color.numpy(), np.asarray(jv2.color), atol=1e-5)


def _pose() -> np.ndarray:
    """A small rigid camera motion (0.01 rad about y, ~1 cm)."""
    c, s = np.cos(0.01), np.sin(0.01)
    pose = np.eye(4)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.005, -0.003, 0.01]
    return pose.astype(np.float32)


def test_camera_pose_arguments(scene, rng):
    """extrinsics (world -> camera, before the warp) and post_warp_extrinsics
    (after it) in block discovery, rigid and non-rigid integration."""
    jv, frames, k = scene["jv"], scene["frames"], scene["k"]
    pose = _pose()
    jpose, ppose = jnp.asarray(pose), torch.as_tensor(pose)
    pv = voxel_block_grid_from_numpy(_state(jv), device="cpu")
    d, c = frames[1].depth, frames[1].color
    jd, pd, jk, pk = jnp.asarray(d), torch.as_tensor(d.astype(np.int32)), jnp.asarray(k), torch.as_tensor(k)

    jkeys = np.asarray(jv.compute_unique_block_coordinates(jd, jk, extrinsics=jpose, stride=2))
    pkeys = pv.compute_unique_block_coordinates(pd, pk, extrinsics=ppose, stride=2).numpy()
    np.testing.assert_array_equal(pkeys, jkeys)
    assert not np.array_equal(jkeys, np.asarray(jv.compute_unique_block_coordinates(jd, jk, stride=2)))

    jr = jv.integrate(jd, jk, extrinsics=jpose)
    pr = pv.integrate(pd, pk, extrinsics=ppose)
    np.testing.assert_array_equal(pr.weight.numpy(), np.asarray(jr.weight))
    np.testing.assert_allclose(pr.tsdf.numpy(), np.asarray(jr.tsdf), atol=1e-5)

    verts = np.asarray(j_extract(jv, 16384, 8192, 0.0)[0])[:2000]
    jf = JH.build(
        verts[::25], node_coverage=0.12, layer_count=2, anchor_count=4,
        minimum_valid_anchor_count=3, threshold_nodes_by_distance=True,
        coverage_method=NodeCoverageMethod.FIXED,
    )
    jf = jf.replace(node_translations=jnp.asarray(rng.normal(0, 0.003, (jf.num_nodes, 3)).astype(np.float32)))
    pf = warp_field_from_numpy(_state(jf), device="cpu")
    for kwargs in ({"extrinsics": True}, {"post_warp_extrinsics": True}):
        jkw = {name: jpose for name in kwargs}
        pkw = {name: ppose for name in kwargs}
        jm = jv.find_blocks_intersecting_truncation_region(jd, jf, jk, **jkw)
        pm = pv.find_blocks_intersecting_truncation_region(pd, pf, pk, **pkw)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        slots = np.nonzero(np.asarray(jm))[0].astype(np.int32)
        valid = np.ones(len(slots), bool)
        jn = jv.integrate_non_rigid(jnp.asarray(slots), jnp.asarray(valid), jf, jd, jk, **jkw)
        pn = pv.integrate_non_rigid(torch.as_tensor(slots), torch.as_tensor(valid), pf, pd, pk, **pkw)
        np.testing.assert_array_equal(pn.weight.numpy(), np.asarray(jn.weight))
        assert (np.asarray(jn.weight) != np.asarray(jv.weight)).any()
        np.testing.assert_allclose(pn.tsdf.numpy(), np.asarray(jn.tsdf), atol=1e-5)
