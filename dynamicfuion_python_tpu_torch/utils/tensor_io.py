"""Compressed binary files of tensors, voxel grids, warp fields and fusion
checkpoints (port of ``dynamicfuion_python_tpu/utils/tensor_io.py``, same
file format, so each package reads the other's files).

NTIO format: magic ``NTIO``, version byte, u16 tensor count, then per tensor:
u16 name length + name, u16 dtype-string length + numpy dtype string, u8
ndim + i64 shape, u8 compression mode, i64 payload size + payload. Modes:
0 raw, 1 zlib (level 6), 2 NTCZ for blobs of 1 MiB and more.

NTCZ is the chunked-zlib format of the JAX package's native codec
(``native/ntio.cpp``): header ``u32 magic 'NTCZ' | u32 chunk_size | u32
n_chunks | u32 0 | u64 raw_size``, then ``u64 compressed_size[n_chunks]``,
then the chunks' zlib streams back to back. Each chunk is compressed
independently (zlib at the same level gives the native codec's bytes), on a
thread pool: zlib releases the interpreter lock.

Arrays cross between tensors and numpy through ``utils/state_conversion.py``;
readers put their tensors on ``device`` (the CUDA card unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.models.warp_field import HierarchicalGraphWarpField
from dynamicfuion_python_tpu_torch.ops import voxel_block_hash as vbh
from dynamicfuion_python_tpu_torch.utils.state_conversion import (
    voxel_block_grid_from_numpy,
    voxel_block_grid_to_numpy,
    warp_field_from_numpy,
    warp_field_to_numpy,
)

_MAGIC = b"NTIO"
_VERSION = 1
_NTCZ_THRESHOLD = 1 << 20  # below this, plain zlib is cheap enough
_NTCZ_MAGIC = 0x4E54435A  # 'NTCZ' as a little-endian u32
_NTCZ_HEADER = struct.Struct("<IIIIQ")
_ZLIB_LEVEL = 6


def _chunk_map(fn, items: list) -> list:
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 4)) as pool:
        return list(pool.map(fn, items))


def ntcz_compress(data: bytes, chunk_size: int = 1 << 22) -> bytes:
    """``data`` as an NTCZ blob: the bytes the native codec writes at zlib
    level 6 for the same chunk size."""
    view = memoryview(data)
    n_chunks = max(1, -(-len(view) // chunk_size))
    chunks = _chunk_map(
        lambda c: zlib.compress(view[c * chunk_size : (c + 1) * chunk_size], _ZLIB_LEVEL), list(range(n_chunks))
    )
    header = _NTCZ_HEADER.pack(_NTCZ_MAGIC, chunk_size, n_chunks, 0, len(view))
    sizes = struct.pack(f"<{n_chunks}Q", *(len(c) for c in chunks))
    return b"".join([header, sizes, *chunks])


def ntcz_decompress(blob: bytes) -> bytes:
    """The raw bytes of an NTCZ blob; raises on a malformed one."""
    if len(blob) < _NTCZ_HEADER.size:
        raise ValueError("truncated NTCZ blob")
    magic, chunk_size, n_chunks, _, raw_size = _NTCZ_HEADER.unpack_from(blob, 0)
    if magic != _NTCZ_MAGIC:
        raise ValueError("not an NTCZ blob")
    sizes = struct.unpack_from(f"<{n_chunks}Q", blob, _NTCZ_HEADER.size)
    offsets = np.concatenate([[0], np.cumsum(sizes)]) + _NTCZ_HEADER.size + 8 * n_chunks
    if offsets[-1] > len(blob):
        raise ValueError("truncated NTCZ blob")
    view = memoryview(blob)
    parts = _chunk_map(
        lambda c: zlib.decompress(view[int(offsets[c]) : int(offsets[c + 1])]), list(range(n_chunks))
    )
    for c, part in enumerate(parts):
        want = min(chunk_size, raw_size - c * chunk_size)
        if len(part) != want:
            raise ValueError(f"NTCZ chunk {c} holds {len(part)} bytes, expected {want}")
    return b"".join(parts)


def _write_blob(f, name: str, array: np.ndarray, compress: bool):
    arr = np.ascontiguousarray(array)
    raw = arr.tobytes()
    mode, payload = 0, raw
    if compress:
        if len(raw) >= _NTCZ_THRESHOLD:
            mode, payload = 2, ntcz_compress(raw)
        else:
            mode, payload = 1, zlib.compress(raw, _ZLIB_LEVEL)
    name_b = name.encode()
    dtype_b = arr.dtype.str.encode()
    f.write(struct.pack("<H", len(name_b)))
    f.write(name_b)
    f.write(struct.pack("<H", len(dtype_b)))
    f.write(dtype_b)
    f.write(struct.pack("<B", arr.ndim))
    f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
    f.write(struct.pack("<B", mode))
    f.write(struct.pack("<q", len(payload)))
    f.write(payload)


def _read_blob(f):
    (name_len,) = struct.unpack("<H", f.read(2))
    name = f.read(name_len).decode()
    (dtype_len,) = struct.unpack("<H", f.read(2))
    dtype = np.dtype(f.read(dtype_len).decode())
    (ndim,) = struct.unpack("<B", f.read(1))
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
    (mode,) = struct.unpack("<B", f.read(1))
    (size,) = struct.unpack("<q", f.read(8))
    payload = f.read(size)
    if len(payload) != size:
        raise ValueError(f"truncated NTIO blob {name!r}")
    if mode == 0:
        raw = payload
    elif mode == 1:
        raw = zlib.decompress(payload)
    elif mode == 2:
        raw = ntcz_decompress(payload)
    else:
        raise ValueError(f"unknown compression mode {mode}")
    return name, np.frombuffer(raw, dtype).reshape(shape).copy()


def write_tensors(path: str | Path, tensors: dict, compress: bool = True) -> None:
    """Write named arrays (numpy arrays or tensors on any device)."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<BH", _VERSION, len(tensors)))
        for name, arr in tensors.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            _write_blob(f, name, np.asarray(arr), compress)


def read_tensors(path: str | Path) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path} is not an NTIO tensor file")
        version, count = struct.unpack("<BH", f.read(3))
        if version != _VERSION:
            raise ValueError(f"unsupported NTIO version {version}")
        return dict(_read_blob(f) for _ in range(count))


def write_tensor(path, array, compress: bool = True):
    """Single-tensor file (the tensor is named ``tensor``)."""
    write_tensors(path, {"tensor": array}, compress)


def read_tensor(path) -> np.ndarray:
    return read_tensors(path)["tensor"]


# -- voxel grid / warp field / pipeline state --------------------------------

_GRID_META = ("voxel_size", "block_resolution", "sdf_truncation_distance", "depth_scale", "depth_max")
_FIELD_META = ("node_coverage", "anchor_count", "minimum_valid_anchor_count", "threshold_nodes_by_distance")
_FIELD_ARRAYS = ("node_positions", "node_rotations", "node_translations", "node_coverage_weights_squared")
_HIERARCHY_ARRAYS = ("virtual_node_indices", "edges", "edge_layer_indices")


def _meta_blob(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), np.uint8)


def write_voxel_block_grid(path, grid, compress: bool = True):
    state = voxel_block_grid_to_numpy(grid)
    tensors = {"__meta__": _meta_blob({k: state[k] for k in _GRID_META})}
    tensors.update({k: state[k] for k in ("slot_keys", "tsdf", "weight", "color")})
    write_tensors(path, tensors, compress)


def read_voxel_block_grid(path, device: str | torch.device | None = None):
    data = read_tensors(path)
    state = json.loads(bytes(data.pop("__meta__")).decode())
    state.update(data)
    sorted_keys, slot_of_sorted = vbh.build_sorted_index(torch.as_tensor(data["slot_keys"]))
    state["sorted_keys"] = sorted_keys.numpy()
    state["slot_of_sorted"] = slot_of_sorted.numpy()
    return voxel_block_grid_from_numpy(state, device)


def write_warp_field(path, field, compress: bool = True):
    state = warp_field_to_numpy(field)
    meta = {k: state[k] for k in _FIELD_META}
    meta["coverage_method"] = state["coverage_method"]
    meta["hierarchical"] = isinstance(field, HierarchicalGraphWarpField)
    arrays = {k: state[k] for k in _FIELD_ARRAYS}
    if meta["hierarchical"]:
        meta["layer_node_counts"] = [int(x) for x in state["layer_node_counts"]]
        meta["layer_decimation_radii"] = [float(x) for x in state["layer_decimation_radii"]]
        arrays.update({k: state[k] for k in _HIERARCHY_ARRAYS})
    write_tensors(path, {"__meta__": _meta_blob(meta), **arrays}, compress)


def read_warp_field(path, device: str | torch.device | None = None):
    data = read_tensors(path)
    state = json.loads(bytes(data.pop("__meta__")).decode())
    del state["hierarchical"]  # a hierarchical field's file holds its edges
    state.update(data)
    return warp_field_from_numpy(state, device)


def save_fusion_checkpoint(
    directory, volume, warp_field, frame_index: int, mesh_state: dict | None = None,
    camera_state: dict | None = None,
):
    """A mid-sequence resume point: the TSDF volume, the warp field, the
    index of the last frame fused and ``mesh_state`` (the pipeline's mesh
    capacity buckets and one-frame-lagged extraction counts, so a resumed
    run keeps the uninterrupted run's shapes). ``camera_state`` (the
    pipeline's camera pose, previous depth image and frame counter) goes to
    ``camera.ntio`` and ``state.json``'s ``frames_processed``: the JAX
    package writes neither and ignores both when it loads."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    write_voxel_block_grid(d / "volume.ntio", volume)
    write_warp_field(d / "warp_field.ntio", warp_field)
    state = {"frame_index": frame_index}
    if mesh_state is not None:
        state["mesh_state"] = mesh_state
    camera_file = d / "camera.ntio"
    if camera_state is not None:
        state["frames_processed"] = int(camera_state["frames_processed"])
        arrays = {"extrinsics": camera_state["extrinsics"]}
        if camera_state.get("previous_depth") is not None:
            arrays["previous_depth"] = camera_state["previous_depth"]
        write_tensors(camera_file, arrays)
    elif camera_file.exists():
        camera_file.unlink()
    (d / "state.json").write_text(json.dumps(state))


def load_fusion_checkpoint(directory, device: str | torch.device | None = None):
    """(volume, warp field, frame index, mesh_state or None, camera_state or
    None) of a checkpoint written by either package."""
    d = Path(directory)
    volume = read_voxel_block_grid(d / "volume.ntio", device)
    field = read_warp_field(d / "warp_field.ntio", volume.device)
    state = json.loads((d / "state.json").read_text())
    camera_state = None
    if (d / "camera.ntio").exists() and "frames_processed" in state:
        camera_state = read_tensors(d / "camera.ntio")
        camera_state["frames_processed"] = state["frames_processed"]
    return volume, field, state["frame_index"], state.get("mesh_state"), camera_state
