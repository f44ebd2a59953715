"""PyTorch port vs JAX package: the leaf ops (point-to-plane distances,
intrinsics_to_ndc, the block-COO sparse suite, grid sampling and the mesh
utilities) on the JAX tests' own inputs (tests/test_block_sparse.py,
test_geometry_ops.py::TestSampling, test_rendering_and_extras.py::TestMeshUtils).
Counts and indices must be equal, values within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dynamicfuion_python_tpu.ops.linalg.block_sparse as JB
import dynamicfuion_python_tpu.ops.mesh_utils as JM
import dynamicfuion_python_tpu.ops.sampling as JS
import dynamicfuion_python_tpu_torch.ops.linalg as PL
import dynamicfuion_python_tpu_torch.ops.mesh_utils as PM
import dynamicfuion_python_tpu_torch.ops.sampling as PS
from dynamicfuion_python_tpu.ops.camera import intrinsics_to_ndc as j_ndc
from dynamicfuion_python_tpu.ops.distances import point_to_plane_distances as j_p2p
from dynamicfuion_python_tpu_torch.ops.camera import intrinsics_to_ndc as p_ndc
from dynamicfuion_python_tpu_torch.ops.distances import point_to_plane_distances as p_p2p

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _random_block_coo(rng, rows, cols, nb, b, inactive=0):
    """tests/test_block_sparse.py's generator: unique coordinates, then
    ``inactive`` entries at (-1, -1)."""
    all_rc = [(i, j) for i in range(rows) for j in range(cols)]
    sel = rng.choice(len(all_rc), size=nb, replace=False)
    coords = np.asarray([all_rc[s] for s in sel], np.int32)
    blocks = rng.normal(size=(nb, b, b)).astype(np.float32)
    if inactive:
        coords = np.concatenate([coords, np.full((inactive, 2), -1, np.int32)])
        blocks = np.concatenate([blocks, rng.normal(size=(inactive, b, b)).astype(np.float32)])
    return blocks, coords


def _both(fn_name, *args, **kwargs):
    """(JAX result, port result) of one block-sparse function on numpy args."""
    j = getattr(JB, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kwargs)
    p = getattr(PL, fn_name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args], **kwargs)
    return j, p


def test_point_to_plane_distances():
    rng = np.random.default_rng(0)
    a, b, n = (rng.normal(size=(7, 5, 3)).astype(np.float32) for _ in range(3))
    _close(p_p2p(*map(torch.as_tensor, (a, b, n))), j_p2p(*map(jnp.asarray, (a, b, n))))


@pytest.mark.parametrize("size", [(480, 640), (640, 480), (64, 64)])
def test_intrinsics_to_ndc(size):
    k = np.asarray([[525.0, 0, 319.5], [0, 530.0, 241.25], [0, 0, 1]], np.float32)
    got = p_ndc(torch.as_tensor(k), size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_ndc(jnp.asarray(k), size)))


def test_block_sparse_to_dense():
    blocks, coords = _random_block_coo(np.random.default_rng(3), 4, 5, 9, 3, inactive=2)
    j, p = _both("block_sparse_to_dense", blocks, coords, (4, 5))
    assert p.shape == (12, 15)
    _close(p, j)


def test_block_sums():
    rng = np.random.default_rng(3)
    blocks = rng.normal(size=(12, 3, 3)).astype(np.float32)
    ids = np.asarray([0, 1, 2, 0, 1, 3, -1, 2, 0, -1, 3, 1], np.int32)
    _close(*reversed(_both("block_sums", blocks, ids, 4)))


def test_diagonal_blocks_and_precondition():
    rng = np.random.default_rng(3)
    blocks, coords = _random_block_coo(rng, 5, 5, 12, 2, inactive=3)
    _close(*reversed(_both("get_diagonal_blocks", blocks, coords, 5)))
    diag = rng.normal(size=(6, 4, 4)).astype(np.float32)
    _close(*reversed(_both("precondition_diagonal_blocks", diag, 0.75)))


def test_transpose_blocks():
    blocks, coords = _random_block_coo(np.random.default_rng(3), 4, 6, 10, 3)
    (jb, jc), (pb, pc) = _both("transpose_blocks", blocks, coords)
    _close(pb, jb, atol=0)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("upper", [True, False])
def test_zero_out_triangular_blocks(upper):
    blocks, coords = _random_block_coo(np.random.default_rng(3), 5, 5, 15, 2)
    _close(*reversed(_both("zero_out_triangular_blocks", blocks, coords, upper=upper)), atol=0)


def test_kronecker_product():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(2, 5)).astype(np.float32)
    _close(*reversed(_both("kronecker_product", a, b)))


@pytest.mark.parametrize("vector", [False, True])
def test_matmul_block_sparse_dense(vector):
    rng = np.random.default_rng(3)
    blocks, coords = _random_block_coo(rng, 6, 4, 11, 3, inactive=2)
    x = rng.normal(size=(12,) if vector else (12, 7)).astype(np.float32)
    j, p = _both("matmul_block_sparse_dense", blocks, coords, x, 6)
    assert p.shape == ((18,) if vector else (18, 7))
    _close(p, j)


@pytest.mark.parametrize("restricted", [False, True])
def test_matmul_block_sparse(restricted):
    rng = np.random.default_rng(3)
    if restricted:  # only the requested output blocks are produced
        a_blocks, a_coords = _random_block_coo(rng, 4, 4, 8, 2)
        b_blocks, b_coords = _random_block_coo(rng, 4, 4, 8, 2)
        out_coords = np.asarray([(0, 0), (1, 2), (3, 3)], np.int32)
    else:  # the "breadboard" covers the whole output grid
        a_blocks, a_coords = _random_block_coo(rng, 5, 6, 14, 3, inactive=2)
        b_blocks, b_coords = _random_block_coo(rng, 6, 4, 12, 3, inactive=1)
        out_coords = np.asarray([(i, j) for i in range(5) for j in range(4)], np.int32)
    j, p = _both("matmul_block_sparse", a_blocks, a_coords, b_blocks, b_coords, out_coords)
    assert p.shape == (len(out_coords),) + a_blocks.shape[1:]
    _close(p, j)


def _sampling_case(name):
    """TestSampling's inputs (its rng fixture is default_rng(0), one per test)."""
    rng = np.random.default_rng(0)
    if name == "mean_grid_downsample":
        return rng.uniform(0, 1, size=(200, 3)).astype(np.float32), 0.25
    if name == "median_grid_subsample":
        return rng.uniform(0, 1, size=(100, 3)).astype(np.float32), 0.5
    if name == "fast_mean_radius_downsample":
        centers = np.array([[0, 0, 0], [5, 0, 0], [0, 5, 0], [0, 0, 5], [5, 5, 0], [5, 5, 5]], np.float32)
        pts = np.concatenate([c + rng.normal(0, 0.01, size=(30, 3)) for c in centers]).astype(np.float32)
        return pts, 0.5
    return rng.uniform(0, 1, size=(120, 3)).astype(np.float32), 0.2


@pytest.mark.parametrize("name", ["mean_grid_downsample", "median_grid_subsample",
                                  "fast_mean_radius_downsample", "fast_median_radius_subsample"])
def test_sampling_matches_jax(name):
    pts, size = _sampling_case(name)
    j_out, j_count = getattr(JS, name)(jnp.asarray(pts), size)
    p_out, p_count = getattr(PS, name)(torch.as_tensor(pts), size)
    assert int(p_count) == int(j_count) > 0
    if p_out.dtype == torch.int32:  # indices: equal, -1 past the count
        np.testing.assert_array_equal(p_out.numpy(), np.asarray(j_out))
    else:  # means in the same (ascending cell id) order, NaN past the count
        np.testing.assert_array_equal(np.isnan(p_out.numpy()), np.isnan(np.asarray(j_out)))
        _close(p_out[: int(p_count)], np.asarray(j_out)[: int(j_count)])


@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_grid_sampling_with_mask_and_origin(offset):
    """The chained form the radius variants use: a validity mask, a pinned
    origin and a half-cell grid offset."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) < 0.7
    origin = pts.min(0) - 0.01
    for fn in ("mean_grid_downsample", "median_grid_subsample"):
        j_out, j_count = getattr(JS, fn)(jnp.asarray(pts), 0.3, offset, jnp.asarray(valid), jnp.asarray(origin))
        p_out, p_count = getattr(PS, fn)(torch.as_tensor(pts), 0.3, offset, torch.as_tensor(valid),
                                         torch.as_tensor(origin))
        assert int(p_count) == int(j_count)
        if fn == "median_grid_subsample":
            np.testing.assert_array_equal(p_out.numpy(), np.asarray(j_out))
        else:
            _close(p_out[: int(p_count)], np.asarray(j_out)[: int(j_count)])


def test_mesh_utils_join_and_adjacency():
    v = np.zeros((3, 3), np.float32)
    t = np.asarray([[0, 1, 2]], np.int32)
    for a, b in zip(PM.join_triangle_meshes([(v, t), (v, t)]), JM.join_triangle_meshes([(v, t), (v, t)])):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    tris = rng.integers(0, 12, size=(20, 3)).astype(np.int32)
    adj = PM.mesh_to_adjacency_array(tris, 12, max_degree=6)
    np.testing.assert_array_equal(adj, JM.mesh_to_adjacency_array(tris, 12, max_degree=6))
    edges = PM.adjacency_array_to_edges(adj)
    np.testing.assert_array_equal(edges, JM.adjacency_array_to_edges(adj))
    edges_padded = np.concatenate([edges, [[-1, -1], [3, -1]]]).astype(np.int32)
    np.testing.assert_array_equal(PM.edges_to_adjacency_matrix(edges_padded, 12),
                                  JM.edges_to_adjacency_matrix(edges_padded, 12))


def test_mesh_utils_radius_search_averaging():
    pts = np.asarray([[0, 0, 0], [0.01, 0, 0], [1, 0, 0], [1.02, 0, 0]], np.float32)
    pts = np.concatenate([pts, np.random.default_rng(1).uniform(0, 2, size=(60, 3)).astype(np.float32)])
    np.testing.assert_array_equal(PM.radius_search_averaging(pts, 0.1), JM.radius_search_averaging(pts, 0.1))


def test_mesh_utils_regular_graph():
    h = w = 16
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([(u - 8) / 100, (v - 8) / 100, np.ones_like(u)], -1)
    pts[3:5, 2:9, 2] = 0.0  # a hole: invalid pixels and lattice nodes
    kwargs = dict(edge_threshold=0.08, max_point_to_node_distance=0.06, max_depth=2.0)
    for a, b in zip(PM.construct_regular_graph(pts, 4, 4, **kwargs), JM.construct_regular_graph(pts, 4, 4, **kwargs)):
        np.testing.assert_array_equal(a, b)
