"""The port's graph generator against the JAX package on the CPU: geodesic
edges, geodesic anchors, node/edge cleanup, anchor renumbering, clusters and
``GraphWarpField``, the depth frame's graph (``build_graph_for_frame``), the
``create_graph_data`` generator and its blobs, the legacy image ops
(``image_proc_extras``) and ``write_ply_mesh``. Integer arrays must be
equal, float arrays within 1e-6."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.ops import graph_construction as JGC
from dynamicfuion_python_tpu_torch.ops import graph_construction as PGC


def _same(got, want, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind, (got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], atol=atol, rtol=0)


def _strip(n=20, offset=(0.0, 0.1, 0.0)):
    """Two parallel rows of vertices joined into a triangle strip."""
    row = np.stack([np.arange(n) * 0.1, np.zeros(n), np.ones(n)], -1).astype(np.float32)
    verts = np.concatenate([row, row + np.asarray(offset, np.float32)])
    tris = []
    for i in range(n - 1):
        tris += [[i, n + i, i + 1], [i + 1, n + i, n + i + 1]]
    return verts, np.asarray(tris, np.int32)


def _slit(n=12):
    """Two rows 2 cm apart joined only at the far end (degenerate triangles
    carry the in-row adjacency)."""
    row0 = np.stack([np.arange(n) * 0.1, np.zeros(n), np.ones(n)], -1)
    verts = np.concatenate([row0, row0 + [0, 0.02, 0]]).astype(np.float32)
    tris = []
    for i in range(n - 1):
        tris += [[i, i + 1, i], [n + i, n + i + 1, n + i]]
    tris.append([n - 1, 2 * n - 1, n - 1])
    return verts, np.asarray(tris, np.int32)


def _depth_mesh(h=48, w=64, seed=0):
    """A bumpy patch with a hole: the mesh, erosion mask and sampled nodes."""
    rng = np.random.default_rng(seed)
    f = 60.0
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 1.0 + 0.05 * np.sin(u / 7.0) + 0.002 * rng.standard_normal((h, w)).astype(np.float32)
    z[:4] = 0
    z[20:26, 30:36] = 0
    pts = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z], -1).astype(np.float32)
    verts, _, faces = JGC.mesh_from_depth_image(pts, 0.1)
    erosion = JGC.vertex_erosion_mask(verts, faces, 2, 4)
    _, node_idx = JGC.sample_nodes(verts, erosion, 0.08)
    return verts, faces, node_idx, erosion


EDGE_CASES = {
    "strip_enforced": (lambda: (*_strip(), np.asarray([0, 5, 10, 15], np.int32)), 2, 0.3, True, False),
    "strip_max_influence": (lambda: (*_strip(), np.asarray([0, 15], np.int32)), 2, 0.3, False, False),
    "slit": (lambda: (*_slit(), np.asarray([0, 12], np.int32)), 1, 0.3, True, False),
    "depth_mesh": (lambda: _depth_mesh()[:3], 8, 0.08, False, False),
    "depth_mesh_enforced": (lambda: _depth_mesh()[:3], 4, 0.08, True, False),
    "depth_mesh_vertex_mask": (lambda: _depth_mesh()[:3], 8, 0.08, False, True),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edges_shortest_path_match_jax(case):
    make, k, coverage, enforce, use_mask = EDGE_CASES[case]
    verts, faces, node_idx = make()
    mask = _depth_mesh()[3] if use_mask else None
    want = JGC.compute_edges_shortest_path(verts, faces, node_idx, k, coverage, enforce, mask)
    got = PGC.compute_edges_shortest_path(verts, faces, node_idx, k, coverage, enforce, mask)
    for g, w in zip(got, want):
        _same(g, w)
    if case == "strip_enforced":  # the JAX test's own gates
        assert got[0][0, 0] == 1 and got[0][0, 1] == 2 and abs(got[2][0, 0] - 0.5) < 1e-4
    elif case == "strip_max_influence":
        assert got[0][0, 0] == -1
    elif case == "slit":
        assert got[2][0, 0] > 2.0


def test_anchors_cleanup_and_renumbering_match_jax():
    n2v = np.asarray([[0.0, 0.5, np.inf], [1.0, 0.1, np.inf], [2.0, 3.0, np.inf]], np.float32)
    for g, w in zip(PGC.compute_anchors_shortest_path(n2v, 0.5, 2), JGC.compute_anchors_shortest_path(n2v, 0.5, 2)):
        _same(g, w)
    verts, faces, node_idx = _depth_mesh()[:3]
    _, _, _, big = JGC.compute_edges_shortest_path(verts, faces, node_idx, 8, 0.08)
    for k in (2, 4):
        for g, w in zip(PGC.compute_anchors_shortest_path(big, 0.08, k), JGC.compute_anchors_shortest_path(big, 0.08, k)):
            _same(g, w)
    edges = np.array([[1, 2], [0, 2], [0, 1], [-1, -1], [3, -1]], np.int32)
    for g, w in zip(PGC.node_and_edge_cleanup(edges, 2), JGC.node_and_edge_cleanup(edges, 2)):
        _same(g, w)
    mapping = np.array([0, -1, 1, 2], np.int32)
    anchors = np.random.default_rng(1).integers(-1, 4, size=(5, 7, 4)).astype(np.int32)
    _same(PGC.update_pixel_anchors(mapping, anchors), JGC.update_pixel_anchors(mapping, anchors))


def test_clusters_and_graph_warp_field_match_jax():
    from dynamicfuion_python_tpu.models import warp_field as JWF
    from dynamicfuion_python_tpu_torch.models import warp_field as PWF

    rng = np.random.default_rng(2)
    edges = rng.integers(-1, 30, size=(30, 3)).astype(np.int32)
    edges[rng.random((30, 3)) < 0.6] = -1
    _same(PWF.compute_clusters(edges), JWF.compute_clusters(edges))
    nodes = rng.normal(size=(30, 3)).astype(np.float32)
    want = JWF.GraphWarpField.from_graph(nodes, edges)
    got = PWF.GraphWarpField.from_graph(nodes, edges, device="cpu")
    for name in ("node_positions", "edges", "edge_weights", "clusters", "node_coverage_weights_squared"):
        _same(getattr(got, name).numpy(), getattr(want, name))
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (30, 3, 3)) * 2.0
    trans = rng.normal(size=(30, 3)).astype(np.float32)
    got2 = got.apply_transformations(torch.as_tensor(rot.copy()), torch.as_tensor(trans))
    want2 = want.apply_transformations(rot, trans)
    _same(got2.get_warped_nodes().numpy(), want2.get_warped_nodes())
    _same(got2.reset_rotations().node_rotations.numpy(), want2.reset_rotations().node_rotations)
    clone = got2.clone()
    clone.node_translations.add_(1.0)
    _same(got2.node_translations.numpy(), trans)


def _frame_depth(h=60, w=80):
    depth = np.zeros((h, w), np.uint16)
    v, u = np.mgrid[0:h, 0:w]
    depth[10:-10, 10:-10] = (1000 + 2 * u + v)[10:-10, 10:-10]
    intr = np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], np.float32)
    return depth, intr


@pytest.mark.parametrize("coverage, erosion", [(0.2, 1), (0.05, 4)])
def test_process_frame_matches_jax(coverage, erosion):
    from dynamicfuion_python_tpu.apps import create_graph_data as JA
    from dynamicfuion_python_tpu_torch.apps import create_graph_data as PA

    depth, intr = _frame_depth()
    flow = np.random.default_rng(3).normal(size=depth.shape + (3,)).astype(np.float32)
    mask = (np.arange(depth.shape[1]) < 60)[None].repeat(depth.shape[0], 0).astype(np.uint16)
    want = JA.process_frame(depth, intr, coverage, mask=mask, scene_flow=flow, erosion_iterations=erosion)
    got = PA.process_frame(depth, intr, coverage, mask=mask, scene_flow=flow, erosion_iterations=erosion)
    assert len(got[0]) >= 2
    for g, w in zip(got, want):
        _same(g, w)


def test_create_graph_data_main_writes_the_jax_blobs(tmp_path):
    """The generator CLI on a synthetic sequence (PNG frames written without
    Pillow): every blob byte-equal to the JAX generator's, and the labels
    JSON lists the pairs with graphs."""
    import json

    from dynamicfuion_python_tpu.apps import create_graph_data as JA
    from dynamicfuion_python_tpu_torch.apps import create_graph_data as PA
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_sequence

    port_seq = write_sequence(tmp_path / "port" / "shift", (64, 96), "shift", 3, [(0, 1), (0, 2), (1, 2)])
    jax_seq = write_sequence(tmp_path / "jax" / "shift", (64, 96), "shift", 3, [(0, 1), (0, 2), (1, 2)])
    assert PA.main([str(port_seq), "--node-coverage", "0.08", "--frames", "0", "--labels", str(tmp_path / "port" / "train.json")]) == 0
    assert JA.main([str(jax_seq), "--node-coverage", "0.08", "--frames", "0"]) == 0
    blobs = sorted(p.relative_to(jax_seq) for p in jax_seq.rglob("*_geodesic_*.bin"))
    assert len(blobs) == 6
    for rel in blobs:
        assert (port_seq / rel).read_bytes() == (jax_seq / rel).read_bytes(), rel
    labels = json.loads((tmp_path / "port" / "train.json").read_text())
    assert [Path(e["optical_flow"]).name for e in labels] == ["shift_000000_000001.oflow", "shift_000000_000002.oflow"]
    assert all((tmp_path / "port" / e["pixel_anchors"]).is_file() for e in labels)


def test_image_proc_extras_match_jax():
    import jax.numpy as jnp

    from dynamicfuion_python_tpu.ops import image_proc_extras as JE
    from dynamicfuion_python_tpu_torch.ops import image_proc_extras as PE

    rng = np.random.default_rng(4)
    depth = rng.integers(800, 1200, size=(20, 24)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.3] = 0
    depth[5:9, 5:9] = 0
    for r in (1, 2):
        _same(PE.filter_depth(torch.as_tensor(depth.astype(np.int32)), r).numpy(),
              JE.filter_depth(jnp.asarray(depth.astype(np.int32)), r))
    pts = rng.normal(size=(20, 24, 3)).astype(np.float32) * 0.05
    pts[:10] += 1.0
    sf = rng.normal(size=(20, 24, 3)).astype(np.float32)
    mask = rng.random((20, 24)) > 0.5
    _same(PE.warp_3d(torch.as_tensor(pts), torch.as_tensor(sf), torch.as_tensor(mask)).numpy(),
          JE.warp_3d(jnp.asarray(pts), jnp.asarray(sf), jnp.asarray(mask)))
    z = depth.astype(np.float32)
    _same(PE.compute_boundary_mask(torch.as_tensor(z), 100.0).numpy(), JE.compute_boundary_mask(jnp.asarray(z), 100.0))
    _same(PE.compute_boundary_mask_points(torch.as_tensor(pts), 0.1).numpy(),
          JE.compute_boundary_mask_points(jnp.asarray(pts), 0.1))
    flows = [rng.normal(size=(20, 24, 2)).astype(np.float32) * 3 for _ in range(3)]
    _same(PE.compute_augmented_flow_from_rotation(*[torch.as_tensor(f) for f in flows]).numpy(),
          JE.compute_augmented_flow_from_rotation(*[jnp.asarray(f) for f in flows]), atol=1e-5)


def test_write_ply_mesh_matches_jax(tmp_path):
    from dynamicfuion_python_tpu.utils.telemetry import write_ply_mesh as jax_write
    from dynamicfuion_python_tpu_torch.utils.telemetry import read_ply, write_ply_mesh

    rng = np.random.default_rng(5)
    verts = rng.normal(size=(17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, size=(9, 3)).astype(np.int32)
    write_ply_mesh(tmp_path / "port.ply", torch.as_tensor(verts), faces)
    jax_write(tmp_path / "jax.ply", verts, faces)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got_v, got_f = read_ply(tmp_path / "port.ply")
    _same(got_v, verts)
    _same(got_f, faces)

