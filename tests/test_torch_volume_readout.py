"""The port's volume read-out against the JAX package, on the CPU: trilinear
TSDF and color samples, voxel probes, ray casting (depth, hit mask, points,
normals, colors) and marching tetrahedra, on the analytic sphere volume and
the integrated plane of tests/test_voxel_block_grid.py, carried across with
utils/state_conversion.py (both packages read the same arrays)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.models.voxel_block_grid import VoxelBlockGrid as JV
from dynamicfuion_python_tpu.ops.marching_tetrahedra import marching_tetrahedra as j_tetrahedra
from dynamicfuion_python_tpu_torch.models.voxel_block_grid import VoxelBlockGrid as PV
from dynamicfuion_python_tpu_torch.ops.marching_tetrahedra import marching_tetrahedra as p_tetrahedra
from dynamicfuion_python_tpu_torch.utils.state_conversion import voxel_block_grid_from_numpy

INTRINSICS = np.asarray([[500.0, 0.0, 32.0], [0.0, 500.0, 24.0], [0.0, 0.0, 1.0]], np.float32)
H, W = 48, 64
# the sphere's camera: at z = -0.6 looking along +z (world -> camera)
SPHERE_EXTRINSICS = np.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0.6], [0, 0, 0, 1.0]], np.float32)


def _state(obj) -> dict:
    return {f.name: (np.array(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _sphere(r_sphere=0.2) -> dict:
    """tests/test_voxel_block_grid.py's analytic sphere volume (radius 0.2 m,
    blocks [-4, 4)^3 of 8^3 voxels of 1 cm), as numpy arrays, with a color
    ramp along x and y so the color samples vary."""
    grid = PV.create(capacity=1024, voxel_size=0.01, block_resolution=8, sdf_truncation_distance=0.04, device="cpu")
    coords = np.array([[i, j, k] for i in range(-4, 4) for j in range(-4, 4) for k in range(-4, 4)], np.int32)
    keys = np.full((1024,), 2**31 - 1, np.int32)
    keys[: len(coords)] = ((coords[:, 0] + 512) << 20) | ((coords[:, 1] + 512) << 10) | (coords[:, 2] + 512)
    grid = grid.activate(torch.as_tensor(keys))
    world = grid._voxel_world_positions(torch.arange(grid.capacity)).numpy().astype(np.float64)
    occ = grid.occupied_mask().numpy()[:, None, None, None]
    sdf = np.clip((np.linalg.norm(world, axis=-1) - r_sphere) / 0.04, -1.0, 1.0)
    color = np.stack([0.5 + world[..., 0], 0.5 - world[..., 1], np.full(world.shape[:-1], 0.25)], -1)
    state = _state(grid)
    state.update(tsdf=np.where(occ, sdf, 0.0).astype(np.float32),
                 weight=np.where(occ, np.ones_like(sdf), 0.0).astype(np.float32),
                 color=np.where(occ[..., None], color, 0.0).astype(np.float32))
    return state


def _plane() -> dict:
    """tests/test_voxel_block_grid.py's integrated plane at 1 m (integrated
    by the port), with a random color image, as numpy arrays."""
    grid = PV.create(capacity=512, voxel_size=0.01, block_resolution=8, sdf_truncation_distance=0.04, device="cpu")
    depth = torch.full((H, W), 1000, dtype=torch.int32)
    color = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32))
    k = torch.as_tensor(INTRINSICS)
    grid = grid.activate(grid.compute_unique_block_coordinates(depth, k, stride=2))
    return _state(grid.integrate(depth, k, color=color))


@pytest.fixture(scope="module")
def volumes():
    """Each volume in both packages, from the same arrays."""
    out = {}
    for name, state in (("sphere", _sphere()), ("plane", _plane())):
        jv = JV(**{key: jnp.asarray(v) if isinstance(v, np.ndarray) else v for key, v in state.items()})
        out[name] = (jv, voxel_block_grid_from_numpy(state, device="cpu"))
    return out


def _probe_points(name, rng, n=3000):
    if name == "sphere":  # a shell around the surface, some far outside
        d = rng.normal(size=(n, 3))
        pts = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.12, 0.45, (n, 1))
    else:  # a slab around z = 1 m inside the frame's frustum
        pts = np.stack([rng.uniform(-0.07, 0.07, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.9, 1.1, n)], 1)
    return pts.astype(np.float32)


@pytest.mark.parametrize("name", ["sphere", "plane"])
def test_sample_tsdf_and_color_match_jax(volumes, name, rng):
    jv, pv = volumes[name]
    pts = _probe_points(name, rng)
    jval, jvalid = map(np.asarray, jv.sample_tsdf(jnp.asarray(pts)))
    pval, pvalid = pv.sample_tsdf(torch.as_tensor(pts))
    np.testing.assert_array_equal(pvalid.numpy(), jvalid)
    assert jvalid.sum() > 500 and (~jvalid).sum() > 50
    np.testing.assert_allclose(pval.numpy()[jvalid], jval[jvalid], atol=1e-5)
    jc = np.asarray(jv.sample_color(jnp.asarray(pts)))
    np.testing.assert_allclose(pv.sample_color(torch.as_tensor(pts)).numpy(), jc, atol=1e-5)
    assert jc.max() > 0.1


def test_extract_voxel_values_at_matches_jax(volumes, rng):
    jv, pv = volumes["sphere"]
    coords = rng.integers(-40, 40, size=(500, 3)).astype(np.int32)
    want = [np.asarray(x) for x in jv.extract_voxel_values_at(jnp.asarray(coords))]
    got = [x.numpy() for x in pv.extract_voxel_values_at(torch.as_tensor(coords))]
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].sum() > 100 and (~want[2]).sum() > 50
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["sphere", "plane"])
def test_ray_cast_matches_jax(volumes, name):
    jv, pv = volumes[name]
    extr = SPHERE_EXTRINSICS if name == "sphere" else None
    kw = dict(width=W, height=H, depth_min=0.1, with_normals=True, with_color=True)
    want = jv.ray_cast(jnp.asarray(INTRINSICS), None if extr is None else jnp.asarray(extr), **kw)
    got = pv.ray_cast(torch.as_tensor(INTRINSICS), None if extr is None else torch.as_tensor(extr), **kw)
    mask = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    assert mask.sum() > 300
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=1e-5)
    np.testing.assert_allclose(got["points"].numpy()[mask], np.asarray(want["points"])[mask], atol=1e-5)
    np.testing.assert_allclose(got["normals"].numpy(), np.asarray(want["normals"]), atol=1e-4)
    np.testing.assert_allclose(got["colors"].numpy(), np.asarray(want["colors"]), atol=1e-5)
    if name == "sphere":  # the JAX test's gates, on the port: the near pole at 0.4 m
        assert abs(float(got["depth"][H // 2, W // 2]) - 0.4) < 0.01
    else:
        np.testing.assert_allclose(got["depth"].numpy()[mask], 1.0, atol=0.01)


def test_marching_tetrahedra_matches_jax(volumes):
    jv, pv = volumes["sphere"]
    jsoup, jn = jv.extract_triangle_soup(max_triangles=150_000, method="tetrahedra")
    psoup, pn = pv.extract_triangle_soup(max_triangles=150_000, method="tetrahedra")
    n = int(jn)
    assert int(pn) == n and 0 < n < 150_000
    # the same triangles in the same (ascending slot) order, so equal up to order too
    np.testing.assert_allclose(psoup.numpy()[:n], np.asarray(jsoup)[:n], atol=1e-6)
    assert (psoup.numpy()[n:] == 0).all()
    _, cubes = pv.extract_triangle_soup(max_triangles=150_000)
    assert int(cubes) < n / 2  # the tetrahedra's soup is the denser one
    # a capacity below the count clamps it, as in the JAX package
    tsdf_p, valid_p = pv._stitched_volumes()
    origins = pv.block_coordinates().to(torch.float32) * pv.block_side()
    small, count = p_tetrahedra(tsdf_p, valid_p, origins, pv.voxel_size, 1000)
    jt, jv_ = jv._stitched_volumes()
    jsmall, jcount = j_tetrahedra(jt, jv_, jnp.asarray(origins.numpy()), pv.voxel_size, 1000)
    assert int(count) == int(jcount) == 1000
    np.testing.assert_allclose(small.numpy(), np.asarray(jsmall), atol=1e-6)
