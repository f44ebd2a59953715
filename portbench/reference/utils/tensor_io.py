"""Reading the fusion checkpoints that the port writes (a copy of the
reading half of the port's ``utils/tensor_io.py`` and
``utils/state_conversion.py``; the same NTIO file format).

NTIO format: magic ``NTIO``, version byte, u16 tensor count, then per tensor:
u16 name length + name, u16 dtype-string length + numpy dtype string, u8
ndim + i64 shape, u8 compression mode, i64 payload size + payload. Modes:
0 raw, 1 zlib (level 6), 2 NTCZ for blobs of 1 MiB and more.

NTCZ is chunked zlib: header ``u32 magic 'NTCZ' | u32 chunk_size | u32
n_chunks | u32 0 | u64 raw_size``, then ``u64 compressed_size[n_chunks]``,
then the chunks' zlib streams back to back, each decompressed on a thread
pool (zlib releases the interpreter lock).

Readers put their tensors on ``device`` (the CUDA card unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench.reference.models.voxel_block_grid import VoxelBlockGrid
from portbench.reference.models.warp_field import (
    HierarchicalGraphWarpField,
    NodeCoverageMethod,
    WarpField,
)
from portbench.reference.ops import voxel_block_hash as vbh
from portbench.reference.utils.device import resolve_device

_MAGIC = b"NTIO"
_VERSION = 1
_NTCZ_MAGIC = 0x4E54435A  # 'NTCZ' as a little-endian u32
_NTCZ_HEADER = struct.Struct("<IIIIQ")
_INT_FIELDS = {"virtual_node_indices", "edges", "slot_keys", "sorted_keys", "slot_of_sorted"}


def _chunk_map(fn, items: list) -> list:
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 4)) as pool:
        return list(pool.map(fn, items))


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


def read_tensors(path: str | Path) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path} is not an NTIO tensor file")
        version, count = struct.unpack("<BH", f.read(3))
        if version != _VERSION:
            raise ValueError(f"unsupported NTIO version {version}")
        return dict(_read_blob(f) for _ in range(count))


def _from_numpy(cls, state: dict, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in state:
            continue
        value = state[f.name]
        if f.name == "coverage_method":
            kwargs[f.name] = NodeCoverageMethod[getattr(value, "name", value)]
        elif f.name in ("layer_node_counts",):
            kwargs[f.name] = tuple(int(x) for x in np.asarray(value).reshape(-1))
        elif f.name in ("layer_decimation_radii",):
            kwargs[f.name] = tuple(float(x) for x in np.asarray(value).reshape(-1))
        elif isinstance(value, np.ndarray) and value.ndim > 0:
            dtype = torch.int32 if f.name in _INT_FIELDS else None
            if f.name == "edge_layer_indices":
                dtype = torch.int8
            kwargs[f.name] = torch.as_tensor(np.array(value), dtype=dtype, device=device)
        else:
            kwargs[f.name] = type(f.default)(np.asarray(value).item()) if f.default is not dataclasses.MISSING else value
    return cls(**kwargs)


def warp_field_from_numpy(state: dict, device: str | torch.device | None = None) -> WarpField:
    """A warp field on ``device`` from its arrays + static fields: a
    ``HierarchicalGraphWarpField`` when the state has its ``edges``, else a
    flat ``WarpField``."""
    cls = HierarchicalGraphWarpField if "edges" in state else WarpField
    return _from_numpy(cls, state, resolve_device(device))


def voxel_block_grid_from_numpy(state: dict, device: str | torch.device | None = None) -> VoxelBlockGrid:
    """A ``VoxelBlockGrid`` on ``device`` from its arrays + static fields."""
    return _from_numpy(VoxelBlockGrid, state, resolve_device(device))


def read_voxel_block_grid(path, device: str | torch.device | None = None):
    data = read_tensors(path)
    state = json.loads(bytes(data.pop("__meta__")).decode())
    state.update(data)
    sorted_keys, slot_of_sorted = vbh.build_sorted_index(torch.as_tensor(data["slot_keys"]))
    state["sorted_keys"] = sorted_keys.numpy()
    state["slot_of_sorted"] = slot_of_sorted.numpy()
    return voxel_block_grid_from_numpy(state, device)


def read_warp_field(path, device: str | torch.device | None = None):
    data = read_tensors(path)
    state = json.loads(bytes(data.pop("__meta__")).decode())
    del state["hierarchical"]  # a hierarchical field's file holds its edges
    state.update(data)
    return warp_field_from_numpy(state, device)


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
