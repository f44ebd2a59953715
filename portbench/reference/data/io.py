"""Binary IO for DeepDeform graph-data blobs and flow files (port of
``dynamicfuion_python_tpu/data/io.py``; numpy only).

All formats are little-endian and length-prefixed, byte-compatible with the
JAX package's files:
  - nodes / node deformations: u32 N + f32[N, 3];
  - edges: u32 N, u32 K + i32[N, K]; edge weights: u32 N, u32 K + f32[N, K];
  - clusters: u32 N, u32 1 + i32[N, 1];
  - int / float images: u32 zdim, u32 ydim, u32 xdim + {i32, f32}[x, y, z];
  - ``.oflow`` / ``.sflow``: u32 width, height, channels + f32[C, H, W];
  - Middlebury ``.flo``: b"PIEH", i32 width, height + f32[H, W, 2].
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def _read_exact(f, count: int, path) -> bytes:
    """Read exactly ``count`` bytes or raise a descriptive error."""
    data = f.read(count)
    if len(data) != count:
        raise ValueError(
            f"truncated or corrupt blob {path!s}: expected {count} payload bytes, got {len(data)}"
        )
    return data


def load_flow_binary(path: str | Path) -> np.ndarray:
    """-> f32[C, H, W] (C=2 optical flow, C=3 scene flow)."""
    with open(path, "rb") as f:
        width, height, channels = struct.unpack("III", _read_exact(f, 12, path))
        data = np.frombuffer(_read_exact(f, width * height * channels * 4, path), np.float32)
    return data.reshape(channels, height, width).copy()


def save_flow_binary(path: str | Path, flow: np.ndarray) -> None:
    if flow.ndim != 3:
        raise ValueError(f"flow must be [C, H, W], got shape {flow.shape}")
    with open(path, "wb") as f:
        f.write(struct.pack("III", flow.shape[2], flow.shape[1], flow.shape[0]))
        f.write(flow.astype("<f4").tobytes())


def save_graph_nodes(path: str | Path, nodes: np.ndarray) -> None:
    nodes = np.ascontiguousarray(nodes, dtype="<f4")
    if nodes.ndim != 2 or nodes.shape[1] != 3:
        raise ValueError(f"nodes must be [N, 3], got shape {nodes.shape}")
    with open(path, "wb") as f:
        f.write(struct.pack("I", nodes.shape[0]))
        f.write(nodes.tobytes())


def load_graph_nodes(path: str | Path) -> np.ndarray:
    with open(path, "rb") as f:
        (n,) = struct.unpack("I", _read_exact(f, 4, path))
        data = np.frombuffer(_read_exact(f, n * 12, path), "<f4")
    return data.reshape(n, 3).copy()


# node deformations share the nodes blob layout
save_graph_node_deformations = save_graph_nodes
load_graph_node_deformations = load_graph_nodes


def _save_2d(path: str | Path, array: np.ndarray, dtype: str) -> None:
    array = np.ascontiguousarray(array, dtype=dtype)
    if array.ndim != 2:
        raise ValueError(f"expected a 2-d array, got shape {array.shape}")
    with open(path, "wb") as f:
        f.write(struct.pack("II", array.shape[0], array.shape[1]))
        f.write(array.tobytes())


def _load_2d(path: str | Path, dtype: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, k = struct.unpack("II", _read_exact(f, 8, path))
        data = np.frombuffer(_read_exact(f, n * k * 4, path), dtype)
    return data.reshape(n, k).copy()


def save_graph_edges(path: str | Path, edges: np.ndarray) -> None:
    _save_2d(path, edges, "<i4")


def load_graph_edges(path: str | Path) -> np.ndarray:
    return _load_2d(path, "<i4")


def save_graph_edges_weights(path: str | Path, weights: np.ndarray) -> None:
    _save_2d(path, weights, "<f4")


def load_graph_edges_weights(path: str | Path) -> np.ndarray:
    return _load_2d(path, "<f4")


def save_graph_clusters(path: str | Path, clusters: np.ndarray) -> None:
    _save_2d(path, clusters.reshape(-1, 1), "<i4")


def load_graph_clusters(path: str | Path) -> np.ndarray:
    return _load_2d(path, "<i4")


def _save_image(path: str | Path, image: np.ndarray, dtype: str) -> None:
    image = np.ascontiguousarray(image, dtype=dtype)
    if image.ndim != 3:
        raise ValueError(f"expected a 3-d image, got shape {image.shape}")
    with open(path, "wb") as f:
        f.write(struct.pack("III", image.shape[2], image.shape[1], image.shape[0]))
        f.write(image.tobytes())


def _load_image(path: str | Path, dtype: str) -> np.ndarray:
    with open(path, "rb") as f:
        zdim, ydim, xdim = struct.unpack("III", _read_exact(f, 12, path))
        data = np.frombuffer(_read_exact(f, xdim * ydim * zdim * 4, path), dtype)
    return data.reshape(xdim, ydim, zdim).copy()


def save_int_image(path: str | Path, image: np.ndarray) -> None:
    _save_image(path, image, "<i4")


def load_int_image(path: str | Path) -> np.ndarray:
    return _load_image(path, "<i4")


def save_float_image(path: str | Path, image: np.ndarray) -> None:
    _save_image(path, image, "<f4")


def load_float_image(path: str | Path) -> np.ndarray:
    return _load_image(path, "<f4")
