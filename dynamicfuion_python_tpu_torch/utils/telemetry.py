"""Run telemetry: mesh recording (PLY), per-GN-iteration states, per-frame
metrics (port of ``dynamicfuion_python_tpu/utils/telemetry.py``).

A run writes into ``<telemetry.output_directory>/<run name>/``: canonical and
warped triangle soups per frame, optional per-iteration GN states,
neural-prior correspondence sets and renders of the warped mesh (8-bit RGB
color and 16-bit depth PNGs, written by :func:`write_png` with ``zlib``
alone: Pillow is not needed), and ``metrics.json`` at the end.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch


def _np(value) -> np.ndarray:
    """A numpy array of a tensor on any device, or of anything array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _materialize_metrics(frames: list) -> list:
    """Recorded frame metrics with every tensor or numpy value turned into
    plain Python scalars / lists."""

    def to_py(v):
        if isinstance(v, (list, tuple)):
            return [to_py(x) for x in v]
        if isinstance(v, dict):
            return {k: to_py(x) for k, x in v.items()}
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, (np.ndarray, torch.Tensor)):
            arr = _np(v)
            return arr.item() if arr.ndim == 0 else arr.tolist()
        return v

    return [to_py(entry) for entry in frames]


def write_ply_mesh(path: str | Path, vertices, faces) -> None:
    """Write an indexed mesh, vertices f32[V, 3] and faces i32[F, 3], as a
    binary-little-endian PLY."""
    _write_ply(path, _np(vertices).astype(np.float32), _np(faces).astype(np.int32))


def write_ply_triangle_soup(path: str | Path, triangles) -> None:
    """Write a triangle soup f32[T, 3, 3] as a binary-little-endian PLY."""
    tris = _np(triangles).astype(np.float32)
    faces = np.arange(3 * len(tris), dtype=np.int32).reshape(-1, 3)
    _write_ply(path, tris.reshape(-1, 3), faces)


def _write_ply(path, verts, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        face_block = np.empty((len(faces), 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(-1, 12)
        f.write(face_block.tobytes())


def write_png(path: str | Path, image, compress_level: int = 6) -> None:
    """Write uint8 [H, W, 3] (RGB), uint8 [H, W] or uint16 [H, W] (grey) as a
    PNG: one IDAT chunk, every row with filter 0, zlib at ``compress_level``
    (1 fastest .. 9 smallest; 6, zlib's and Pillow's default)."""
    a = np.asarray(image)
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        bit_depth, color_type = 8, 2
    elif a.dtype in (np.uint8, np.uint16) and a.ndim == 2:
        bit_depth, color_type = 8 * a.dtype.itemsize, 0
    else:
        raise ValueError(f"write_png takes uint8 [H, W, 3] or uint8 / uint16 [H, W], got {a.dtype}{list(a.shape)}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))

    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw, compress_level))
                + chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # grey, RGB, grey + alpha, RGBA


def _unfilter(filtered: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of
    the bytes ``filtered`` uint8[H, stride]; ``bpp`` bytes per pixel.

    A byte depends on its left, upper and upper-left neighbors, so the
    bytes of one anti-diagonal (row + pixel column constant) are
    independent: the loop runs over the H + W - 1 anti-diagonals, each step
    vectorized over rows and the bytes of a pixel."""
    h, stride = filtered.shape
    if not filters.any():
        return filtered
    if filters.max() > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} does not exist")
    wpix = stride // bpp
    f = filtered.reshape(h, wpix, bpp).astype(np.int32)
    out = np.zeros((h + 1, wpix + 1, bpp), np.int32)  # a zero row above and a zero column left
    rows_all = np.arange(h)
    for diag in range(h + wpix - 1):
        r = rows_all[max(0, diag - wpix + 1) : min(h, diag + 1)]
        p = diag - r
        a = out[r + 1, p]  # left
        b = out[r, p + 1]  # up
        c = out[r, p]  # upper left
        kind = filters[r][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, p + 1] = (f[r, p] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str | Path) -> np.ndarray:
    """Read a non-interlaced 8- or 16-bit PNG: grey -> [H, W], RGB ->
    [H, W, 3], grey + alpha -> [H, W, 2], RGBA -> [H, W, 4], as uint8 or
    uint16; every row filter. Raises on palette images, bit depths below 8
    and interlacing."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0] != zlib.crc32(tag + payload):
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, bit_depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS or bit_depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: color type {color_type}, bit depth {bit_depth}, interlace {interlace} is not read here "
            "(8- or 16-bit grey, grey + alpha, RGB or RGBA, not interlaced)"
        )
    channels = _PNG_CHANNELS[color_type]
    dtype = np.dtype(">u2") if bit_depth == 16 else np.dtype(np.uint8)
    bpp = channels * dtype.itemsize
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    raw = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    image = np.ascontiguousarray(raw).view(dtype).astype(dtype.newbyteorder("="))
    return image.reshape(h, w, channels) if channels > 1 else image.reshape(h, w)


def read_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal reader for the files this module writes."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode()
    n_verts = int(header.split("element vertex ")[1].split("\n")[0])
    n_faces = int(header.split("element face ")[1].split("\n")[0])
    verts = np.frombuffer(data, "<f4", count=n_verts * 3, offset=header_end).reshape(-1, 3)
    face_bytes = np.frombuffer(
        data, np.uint8, count=n_faces * 13, offset=header_end + n_verts * 12
    ).reshape(-1, 13)
    faces = face_bytes[:, 1:].copy().view("<i4").reshape(-1, 3)
    return verts.copy(), faces


class TelemetryRecorder:
    """Per-run output directory with toggled recorders."""

    def __init__(self, config, run_name: str | None = None):
        self.config = config
        stamp = run_name or time.strftime("%y-%m-%d-%H-%M-%S")
        self.run_dir = Path(config.output_directory) / stamp
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.frame_metrics: list[dict] = []
        self._start_time = time.perf_counter()

    def record_meshes(self, frame_index: int, canonical=None, warped=None):
        if canonical is not None and self.config.record_canonical_meshes:
            write_ply_triangle_soup(self.run_dir / f"{frame_index:06d}_canonical_mesh.ply", canonical)
        if warped is not None and self.config.record_warped_meshes:
            write_ply_triangle_soup(self.run_dir / f"{frame_index:06d}_warped_mesh.ply", warped)

    def record_gn_iterations(
        self,
        frame_index: int,
        data_losses,
        arap_losses,
        node_translations_per_iteration=None,
        node_positions=None,
    ):
        """Per-GN-iteration losses + node translations and the node positions
        they apply to."""
        if not self.config.record_gn_point_clouds:
            return
        arrays = {
            "data_losses": np.asarray([float(x) for x in data_losses], np.float32),
            "arap_losses": np.asarray([float(x) for x in arap_losses], np.float32),
        }
        if node_translations_per_iteration is not None:
            arrays["node_translations"] = _np(node_translations_per_iteration).astype(np.float32)
        if node_positions is not None:
            arrays["node_positions"] = _np(node_positions).astype(np.float32)
        np.savez_compressed(self.run_dir / f"{frame_index:06d}_gn_iterations.npz", **arrays)

    def record_correspondences(
        self,
        frame_index: int,
        source_points=None,
        target_matches=None,
        correspondence_mask=None,
        mask_prediction=None,
    ):
        """Correspondence sets + mask predictions of the neural tracking
        prior."""
        if not self.config.record_correspondences:
            return
        arrays = {}
        if source_points is not None:
            arrays["source_points"] = _np(source_points).astype(np.float32)
        if target_matches is not None:
            arrays["target_matches"] = _np(target_matches).astype(np.float32)
        if correspondence_mask is not None:
            arrays["correspondence_mask"] = _np(correspondence_mask).astype(bool)
        if mask_prediction is not None:
            arrays["mask_prediction"] = _np(mask_prediction).astype(np.float32)
        if arrays:
            np.savez_compressed(self.run_dir / f"{frame_index:06d}_correspondences.npz", **arrays)

    def record_rendered_warped_mesh(self, frame_index: int, color, depth):
        """The rendered warped mesh: color f32[H, W, 3] in [0, 1] as an 8-bit
        RGB PNG, depth f32[H, W] in meters as a 16-bit PNG in millimeters."""
        if not self.config.record_rendered_warped_mesh:
            return
        rgb = np.clip(_np(color) * 255.0, 0, 255).astype(np.uint8)
        write_png(self.run_dir / f"{frame_index:06d}_rendered_color.png", rgb)
        d16 = np.clip(_np(depth) * 1000.0, 0, 65535).astype(np.uint16)
        write_png(self.run_dir / f"{frame_index:06d}_rendered_depth.png", d16)

    def record_frame(self, frame_index: int, **metrics):
        self.frame_metrics.append({"frame": frame_index, **metrics})
        if self.config.print_frame_info:
            print(f"[frame {frame_index}] {metrics}")

    def finish(self) -> dict:
        total = time.perf_counter() - self._start_time
        fps = len(self.frame_metrics) / total if total > 0 else 0.0
        # frames recorded with fusion.sync_frame_metrics=false hold device
        # tensors: they cross to the host here, once
        self.frame_metrics = _materialize_metrics(self.frame_metrics)
        summary = {
            "total_runtime_s": total,
            "frames_per_second": fps,
            "frame_count": len(self.frame_metrics),
            "frames": self.frame_metrics,
        }
        if self.config.record_frame_metrics:
            (self.run_dir / "metrics.json").write_text(json.dumps(summary, indent=1))
        if self.config.print_runtime:
            print(f"total runtime: {total:.2f} s for {len(self.frame_metrics)} frames ({fps:.2f} frames/s)")
        return summary
