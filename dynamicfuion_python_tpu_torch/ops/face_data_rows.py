"""The face data term's rows on the card: one CUDA kernel
(``csrc/face_data_rows.cu``) in place of the fitter's plain PyTorch pair
tables, stage 1 with its autograd backward, chain rule and row assembly.

:func:`face_data_rows_cuda` takes a Gauss-Newton iteration's inputs after
the covered-pixel compaction and returns what
``models/fitter.py::_face_rows_plain`` returns on the same inputs, bit for
bit: the rows [P * 12, 42] that ``segment_sum`` adds, their segments, and
the pixels' weights and residuals. The fitter launches it for CUDA tensors
and runs the plain functions for CPU tensors. Each launch is counted as
``face_rows.launches`` in ``utils/trace.py``'s counters.

:func:`face_data_rows_work` counts the bytes the kernel's function needs on
given inputs, for its bound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.utils import trace

SLOTS = 12  # node slots of a face: 3 vertices x 4 anchors
COLUMNS = 42  # 36 lumped H products, then 6 g entries

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,  # idx, n_ok
    ctypes.c_void_p, ctypes.c_void_p,  # pix_face, mask
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ref_points, cap, width, row0
    ctypes.c_void_p,  # intrinsics
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tris, slot map, face nodes, weights
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos, rot, trans
    ctypes.c_void_p, ctypes.c_void_p,  # vertices, normals
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # nodes, tukey, cutoff, 1 / cutoff, lump
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # rows, seg, residuals, weights
    ctypes.c_void_p,  # stream
]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev: torch.device, shape=None) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the vertices on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {list(shape)}, got {list(t.shape)}")


def face_data_rows_cuda(
    pos_v, rot_v, trans_v, vertices, normals, triangles, anchor_weights, face_nodes, slot_of_vertex_anchor,
    frag_faces, reference_points, reference_mask, intrinsics, num_nodes: int,
    idx=None, n_ok=None, row0: int = 0, tukey_cutoff: float | None = None, lump: bool = True,
):
    """The rows of the face data term on card tensors.

    ``frag_faces`` int32[H, W] and ``reference_mask`` bool[H, W] are the
    (slab's) face ids and mask, ``reference_points`` f32[H, W, 3]; with the
    compaction, ``idx`` int64[P] are the compacted pixel ids and ``n_ok`` an
    int64 scalar tensor, the count of the kept ones (pixels from ``n_ok`` on
    are masked); without, P = H W and every pixel is a row group.
    ``row0`` is the slab's first row in the frame. ``tukey_cutoff`` None
    leaves every kept pixel at weight 1.

    Returns (rows f32[P * 12, 42], seg int64[P * 12], weight f32[P],
    residuals f32[P]), each masked as the plain version masks it.
    """
    dev = vertices.device
    if dev.type != "cuda":
        raise ValueError(f"face_data_rows_cuda takes card tensors, got {dev}")
    n_nodes, n_faces, n_verts = pos_v.shape[0], triangles.shape[0], vertices.shape[0]
    h, w = reference_mask.shape
    for name, t, dtype, shape in (
        ("pos_v", pos_v, torch.float32, (n_nodes, 3)),
        ("rot_v", rot_v, torch.float32, (n_nodes, 3, 3)),
        ("trans_v", trans_v, torch.float32, (n_nodes, 3)),
        ("vertices", vertices, torch.float32, (n_verts, 3)),
        ("normals", normals, torch.float32, (n_verts, 3)),
        ("triangles", triangles, torch.int32, (n_faces, 3)),
        ("anchor_weights", anchor_weights, torch.float32, (n_verts, 4)),
        ("face_nodes", face_nodes, torch.int32, (n_faces, SLOTS)),
        ("slot_of_vertex_anchor", slot_of_vertex_anchor, torch.int64, (n_faces, 3, 4)),
        ("frag_faces", frag_faces, torch.int32, (h, w)),
        ("reference_points", reference_points, torch.float32, (h, w, 3)),
        ("reference_mask", reference_mask, torch.bool, (h, w)),
        ("intrinsics", intrinsics, torch.float32, (3, 3)),
    ):
        _check(name, t, dtype, dev, shape)
    if n_nodes == 0 or n_faces == 0 or n_verts == 0:
        raise ValueError("the field, the mesh and its faces must not be empty")
    if (idx is None) != (n_ok is None):
        raise ValueError("idx and n_ok come together")
    if idx is not None:
        _check("idx", idx, torch.int64, dev)
        _check("n_ok", n_ok, torch.int64, dev, ())
        if idx.ndim != 1:
            raise ValueError("idx must be 1-D")
        cap = idx.shape[0]
    else:
        cap = h * w
    rows = torch.empty((cap * SLOTS, COLUMNS), dtype=torch.float32, device=dev)
    seg = torch.empty((cap * SLOTS,), dtype=torch.int64, device=dev)
    residuals = torch.empty((cap,), dtype=torch.float32, device=dev)
    weight = torch.empty((cap,), dtype=torch.float32, device=dev)
    if cap == 0:
        return rows, seg, weight, residuals
    tukey = tukey_cutoff is not None
    cutoff = np.float32(tukey_cutoff if tukey else 1.0)
    # ``r / c`` with a Python float c is ``r * (1 / c)`` on the card, 1 / c in f32
    inverse = np.float32(1.0) / cutoff
    status = native.entry_point("face_data_rows", _ARGTYPES)(
        None if idx is None else idx.data_ptr(), None if n_ok is None else n_ok.data_ptr(),
        frag_faces.data_ptr(), reference_mask.data_ptr(),
        reference_points.data_ptr(), cap, w, int(row0),
        intrinsics.data_ptr(),
        triangles.data_ptr(), slot_of_vertex_anchor.data_ptr(), face_nodes.data_ptr(), anchor_weights.data_ptr(),
        pos_v.data_ptr(), rot_v.data_ptr(), trans_v.data_ptr(),
        vertices.data_ptr(), normals.data_ptr(),
        int(num_nodes), int(tukey), float(cutoff), float(inverse), int(bool(lump)),
        rows.data_ptr(), seg.data_ptr(), residuals.data_ptr(), weight.data_ptr(),
        native.stream_handle(dev),
    )
    native.check(status, "face_data_rows")
    trace.count("face_rows.launches")
    return rows, seg, weight, residuals


def face_data_rows_work(triangles, face_nodes, slot_of_vertex_anchor, frag_faces, reference_mask,
                        idx=None, n_ok=None) -> dict[str, int]:
    """The bytes the kernel's function needs on these inputs, for its bound:
    each input it reads counted once and each output written once.

    Per pixel row group: its compacted id (8 B, with the compaction), its
    face id (4 B; with the compaction only for the kept pixels, the others
    take face 0), its mask byte (without), its reference point (12 B), and
    the outputs: 12 rows of 42 f32 (2,016 B), 12 int64 segments, residual
    and weight. Per distinct face read: 3 vertex ids, 12 slot ids (int64)
    and 12 node ids (156 B); per distinct vertex of those faces: position,
    normal and 4 anchor weights (40 B); per distinct node a pair reads:
    position, rotation, translation (60 B); the intrinsics and ``n_ok``.
    """
    h, w = frag_faces.shape
    pix_face = frag_faces.reshape(-1).long()
    if idx is not None:
        p = idx.shape[0]
        ok = torch.arange(p, device=idx.device) < n_ok
        face = torch.where(ok, pix_face[idx], 0)
        kept = int(ok.sum())
        per_pixel = 8 + 12
        fixed = 36 + 8 + kept * 4
    else:
        p = h * w
        face = pix_face.clamp(min=0)
        per_pixel = 4 + 1 + 12
        fixed = 36
    faces = torch.unique(face)
    verts = torch.unique(triangles[faces].long())
    slots = slot_of_vertex_anchor[faces].reshape(faces.shape[0], SLOTS).clamp(min=0)
    nodes = torch.unique(torch.gather(face_nodes[faces].long(), 1, slots).clamp(min=0))
    out = p * (SLOTS * COLUMNS * 4 + SLOTS * 8 + 4 + 4)
    return {
        "pixels": p,
        "faces": int(faces.numel()),
        "vertices": int(verts.numel()),
        "nodes": int(nodes.numel()),
        "bytes": fixed + p * per_pixel + int(faces.numel()) * 156 + int(verts.numel()) * 40
        + int(nodes.numel()) * 60 + out,
    }
