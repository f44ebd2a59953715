"""The port's entry points against the JAX package, on the CPU: NTIO files
and fusion checkpoints in both directions, and ``run_fusion`` with
telemetry, checkpoint + resume, streamed metrics and the CLI, on the 64x96
bending plane with rigid odometry on (``test_torch_entry_point.py`` holds the
fusion loop itself and the graph modes)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.apps import fusion_pipeline as JF
from dynamicfuion_python_tpu.data.frame_sequence import SyntheticBendingPlaneSequence
from dynamicfuion_python_tpu.models.voxel_block_grid import VoxelBlockGrid as JV
from dynamicfuion_python_tpu.models.warp_field import HierarchicalGraphWarpField as JH
from dynamicfuion_python_tpu.ops import voxel_block_hash as jvbh
from dynamicfuion_python_tpu.settings import Parameters as JParams
from dynamicfuion_python_tpu.utils import tensor_io as jio
from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply
from dynamicfuion_python_tpu.utils.telemetry import read_ply as j_read_ply
from dynamicfuion_python_tpu_torch.apps import fusion_pipeline as PF
from dynamicfuion_python_tpu_torch.settings import Parameters as PParams
from dynamicfuion_python_tpu_torch.utils import tensor_io as pio
from dynamicfuion_python_tpu_torch.utils.config import apply_overrides as p_apply

# test_torch_entry_point.py's scene and overrides
OVERRIDES = [
    "tsdf.voxel_size=0.01",
    "tsdf.sdf_truncation_distance=0.04",
    "tsdf.initial_block_count=512",
    "graph.node_coverage=0.12",
    "graph.layer_count=2",
    "graph.erosion_num_iterations=1",
    "alignment.max_iteration_count=2",
    "alignment.arap_term_weight=20.0",
    "fusion.far_clip_distance=2.0",
    "fusion.extraction_max_triangles=60000",
    "fusion.mesh_capacity_hint=65536",
    "telemetry.print_runtime=false",
]


def _seq(frames: int):
    return SyntheticBendingPlaneSequence(frame_count=frames, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)


# -- NTIO files --------------------------------------------------------------


def _native_or_skip():
    from dynamicfuion_python_tpu import native

    if not native.build_library():
        pytest.skip("libntio (the JAX package's C++ codec) cannot be built here")
    return native


def _arrays(mode: str, rng) -> dict:
    arrays = {
        "a": rng.normal(size=(17, 5)).astype(np.float32),
        "b": rng.integers(0, 100, size=(3, 4, 2)).astype(np.int32),
        "scalar": np.asarray(4.5, np.float64),
        "flags": rng.random(12) > 0.5,
    }
    if mode == "ntcz":  # >= 1 MiB blobs, several 4 MiB chunks
        arrays["big"] = rng.integers(0, 10, size=(5_000_000,)).astype(np.int16)
        arrays["big_f"] = rng.normal(size=(300_000,)).astype(np.float32)
    return arrays


@pytest.mark.parametrize("mode", ["raw", "zlib", "ntcz"])
def test_ntio_files_both_directions(mode, tmp_path, rng):
    if mode == "ntcz":
        _native_or_skip()
    arrays = _arrays(mode, rng)
    compress = mode != "raw"
    jio.write_tensors(tmp_path / "jax.ntio", arrays, compress=compress)
    pio.write_tensors(tmp_path / "port.ntio", arrays, compress=compress)
    assert (tmp_path / "port.ntio").read_bytes() == (tmp_path / "jax.ntio").read_bytes()
    for back in (pio.read_tensors(tmp_path / "jax.ntio"), jio.read_tensors(tmp_path / "port.ntio")):
        assert list(back) == list(arrays)
        for k, v in arrays.items():
            # the format stores a 0-d array as 1-d (np.ascontiguousarray)
            assert back[k].dtype == v.dtype and back[k].shape == np.atleast_1d(v).shape
            np.testing.assert_array_equal(back[k], v)
    pio.write_tensor(tmp_path / "one.ntio", torch.as_tensor(arrays["a"]), compress=compress)
    np.testing.assert_array_equal(jio.read_tensor(tmp_path / "one.ntio"), arrays["a"])


@pytest.mark.parametrize("size,chunk", [(0, 1 << 22), (3_000_000, 1 << 22), (9_000_001, 1 << 22), (1_000_000, 65536)])
def test_ntcz_bytes_equal_the_native_codec(size, chunk, rng):
    native = _native_or_skip()
    data = rng.integers(0, 50, size=size, dtype=np.uint8).tobytes()
    packed = pio.ntcz_compress(data, chunk_size=chunk)
    assert packed == native.compress(data, chunk_size=chunk)
    assert pio.ntcz_decompress(packed) == data
    if data:  # the native reader takes a raw size of 0 for a bad header
        assert native.decompress(packed) == data


def _jax_checkpoint_state():
    grid = JV.create(capacity=1024, block_resolution=8, voxel_size=0.01)
    keys = jvbh.pack_block_keys(jnp.asarray([[0, 0, 10], [1, 2, 10], [-3, 4, 12]], jnp.int32))
    grid = grid.activate(jnp.full((8,), jvbh.EMPTY_KEY, jnp.int32).at[:3].set(keys))
    rng = np.random.default_rng(3)
    grid = grid.replace(
        tsdf=jnp.asarray(rng.uniform(-1, 1, grid.tsdf.shape).astype(np.float32)),
        weight=jnp.asarray(rng.integers(0, 5, grid.weight.shape).astype(np.float32)),
    )
    xs, ys = np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8))
    nodes = np.stack([xs.ravel(), ys.ravel(), np.ones(64)], -1).astype(np.float32)
    field = JH.build(nodes, node_coverage=0.15, layer_count=2)
    field = field.translate_nodes(jnp.asarray(rng.normal(scale=0.01, size=(64, 3)).astype(np.float32)))
    return grid, field


def _assert_same_state(p_grid, p_field, j_grid, j_field):
    for name in ("slot_keys", "sorted_keys", "slot_of_sorted", "tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(p_grid, name).cpu().numpy(), np.asarray(getattr(j_grid, name)))
    for name in ("voxel_size", "block_resolution", "sdf_truncation_distance", "depth_scale", "depth_max"):
        assert getattr(p_grid, name) == getattr(j_grid, name)
    for name in ("node_positions", "node_rotations", "node_translations", "node_coverage_weights_squared",
                 "virtual_node_indices", "edges", "edge_layer_indices"):
        np.testing.assert_array_equal(getattr(p_field, name).cpu().numpy(), np.asarray(getattr(j_field, name)))
    for name in ("node_coverage", "anchor_count", "minimum_valid_anchor_count", "threshold_nodes_by_distance",
                 "layer_node_counts", "layer_decimation_radii"):
        assert getattr(p_field, name) == getattr(j_field, name)
    assert p_field.coverage_method.name == j_field.coverage_method.name


def test_fusion_checkpoints_both_directions(tmp_path):
    _native_or_skip()  # the volume's blobs are NTCZ
    grid, field = _jax_checkpoint_state()
    mesh_state = {"v_cap": 4096, "t_cap": 65536, "count_host": [100, 200]}
    jio.save_fusion_checkpoint(tmp_path / "jax", grid, field, frame_index=7, mesh_state=mesh_state)
    p_grid, p_field, frame, p_mesh, camera = pio.load_fusion_checkpoint(tmp_path / "jax", device="cpu")
    assert (frame, p_mesh, camera) == (7, mesh_state, None)
    _assert_same_state(p_grid, p_field, grid, field)

    pio.save_fusion_checkpoint(tmp_path / "port", p_grid, p_field, frame_index=7, mesh_state=mesh_state)
    for name in ("volume.ntio", "warp_field.ntio", "state.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    j_grid, j_field, frame, j_mesh = jio.load_fusion_checkpoint(tmp_path / "port")
    assert (frame, j_mesh) == (7, mesh_state)
    _assert_same_state(p_grid, p_field, j_grid, j_field)
    _, found = j_grid.find_block_slots(jvbh.pack_block_keys(jnp.asarray([[1, 2, 10]], jnp.int32)))
    assert bool(found[0])


# -- run_fusion, telemetry, resume, CLI --------------------------------------


def test_run_fusion_telemetry_matches_jax(tmp_path):
    seq = _seq(3)
    overrides = OVERRIDES + ["telemetry.record_gn_point_clouds=true"]
    j_params = j_apply(JParams(), overrides + [f"telemetry.output_directory={tmp_path / 'jax'}"])
    p_params = p_apply(PParams(), overrides + [f"telemetry.output_directory={tmp_path / 'port'}"])
    JF.run_fusion(seq, j_params, run_name="run")
    result = PF.run_fusion(seq, p_params, run_name="run", device="cpu")
    jm = json.loads((tmp_path / "jax" / "run" / "metrics.json").read_text())
    pm = json.loads((tmp_path / "port" / "run" / "metrics.json").read_text())
    assert set(pm) == set(jm) and pm["frame_count"] == jm["frame_count"] == 3
    # the port adds its rasterizer's overflow counters to every fitted frame
    extra = {"dropped_large_faces", "dropped_bin_entries"}
    for jf, pf in zip(jm["frames"], pm["frames"]):
        assert set(pf) - extra == set(jf) and (set(pf) == set(jf) or set(pf) - set(jf) == extra)
    assert pm["frames"][0]["nodes"] == jm["frames"][0]["nodes"]
    names = sorted(p.name for p in (tmp_path / "port" / "run").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "run").iterdir())
    for ply in (tmp_path / "port" / "run").glob("*.ply"):
        verts, faces = j_read_ply(ply)
        assert len(verts) > 0 and len(faces) == len(verts) // 3
    gn = np.load(tmp_path / "port" / "run" / "000002_gn_iterations.npz")
    assert gn["node_translations"].shape == (2, result.warp_field.num_nodes, 3)
    assert len(result.canonical_mesh) > 500


def test_checkpoint_resume(tmp_path):
    seq = _seq(3)
    params = p_apply(PParams(), OVERRIDES + [f"telemetry.output_directory={tmp_path}"])
    ckpt = tmp_path / "fusion_ckpt"
    full = PF.run_fusion(seq, params, run_name="a", checkpoint_dir=str(ckpt), checkpoint_every=2, device="cpu")
    # resume from the frame-1 checkpoint and process only frame 2, which
    # runs odometry against the checkpoint's previous depth
    resumed = PF.run_fusion(seq, params, run_name="b", checkpoint_dir=str(ckpt), resume=True, device="cpu")
    assert resumed.summary["frame_count"] == 1
    assert resumed.summary["frames"][0]["rigid_rmse"] > 0
    np.testing.assert_allclose(
        resumed.warp_field.node_translations.numpy(), full.warp_field.node_translations.numpy(), atol=1e-4
    )


def test_cli_runs_on_the_cpu(tmp_path):
    result = PF.main([
        "--sequence", "synthetic", "--frames", "3", "--size", "64x96", "--device", "cpu",
        *OVERRIDES, f"telemetry.output_directory={tmp_path}",
    ])
    assert result.summary["frame_count"] == 3
    assert result.volume.device.type == "cpu"
    (run,) = list(tmp_path.iterdir())
    assert (run / "metrics.json").exists() and len(list(run.glob("*_warped_mesh.ply"))) == 2


def test_streaming_metrics_reach_metrics_json(tmp_path):
    """With fusion.sync_frame_metrics=false process_frame hands back tensors;
    the recorder turns them into plain JSON values once, at the end."""
    params = p_apply(PParams(), OVERRIDES + [
        "fusion.sync_frame_metrics=false", f"telemetry.output_directory={tmp_path}",
    ])
    result = PF.run_fusion(_seq(2), params, run_name="s", device="cpu")
    frame = json.loads((tmp_path / "s" / "metrics.json").read_text())["frames"][1]
    assert isinstance(frame["rigid_rmse"], float) and isinstance(frame["active_blocks"], int)
    assert len(frame["data_loss"]) == 2 and all(isinstance(x, float) for x in frame["data_loss"])
    assert frame["valid_solve"] == [True, True]
    assert result.summary["frames"][1] == frame
