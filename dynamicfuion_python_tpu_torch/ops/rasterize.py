"""Triangle rasterization: the naive oracle and the two-phase binned
rasterizer whose second phase is kernel B1.

Port of ``dynamicfuion_python_tpu/ops/rasterize.py`` (``Fragments``,
``extract_face_vertices``, ``rasterize_naive``, ``rasterize_binned``) with
phase 2 of ``rasterize_binned`` replacing the Pallas TPU kernel
``rasterize_tiles_pallas`` (``ops/pallas/rasterize_tiles.py``).

Rasterization happens in pixel space: face vertices arrive as (u, v, z) with
u, v in pixels and z the camera-space depth, and pixel centers sit at integer
coordinates. Every path keeps, per pixel, the nearest fragment; on equal
depth the lower face id wins (the rule of the JAX fitter's
``rasterize_splat``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.ops.mesh_expand import expand_project_faces

BG_DEPTH = 3.0e38
_INT_MAX = 2**31 - 1


class Fragments(NamedTuple):
    """Per-pixel fragment buffers, K nearest along z (ascending)."""

    face_indices: torch.Tensor  # int32[H, W, K], -1 = empty
    depths: torch.Tensor  # f32[H, W, K], BG_DEPTH = empty
    barycentrics: torch.Tensor  # f32[H, W, K, 3]
    distances: torch.Tensor  # f32[H, W, K] signed squared px distance (neg inside)


def extract_face_vertices(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    intrinsics: torch.Tensor,
    image_size: tuple[int, int],
    near: float = 0.05,
    far: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space mesh -> per-face pixel-space vertex triples + clip mask
    (faces with any vertex outside (near, far) are invalid). Runs kernel B2
    on the card (see ``ops/mesh_expand.py``)."""
    del image_size  # kept for the JAX package's signature
    fv, valid, _ = expand_project_faces(vertices, triangles, intrinsics, near, far)
    return fv, valid


# ---------------------------------------------------------------------------
# per-pixel / per-face math (plain PyTorch; the CUDA kernel repeats it
# operation by operation)
# ---------------------------------------------------------------------------


def _edge_fn(px, py, ax, ay, bx, by):
    """Signed area x2 of (a, b, p): > 0 when p is left of a->b."""
    return (px - ax) * (by - ay) - (py - ay) * (bx - ax)


def _point_segment_d2(px, py, ax, ay, bx, by):
    dx, dy = bx - ax, by - ay
    len2 = dx * dx + dy * dy
    t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / torch.clamp(len2, min=1e-12), 0.0, 1.0)
    ex, ey = ax + t * dx - px, ay + t * dy - py
    return ex * ex + ey * ey


def _fragment_math(
    px, py, cols, blur_radius: float, perspective_correct: bool,
    clip_barycentrics: bool, cull_back_faces: bool,
):
    """Evaluate faces at pixels (broadcasting). ``cols`` = the 9 face columns
    (ax, ay, az, bx, by, bz, cx, cy, cz). Returns (hit, depth, (b0, b1, b2),
    signed_d2)."""
    ax, ay, az, bx, by, bz, cx, cy, cz = cols
    area = _edge_fn(cx, cy, ax, ay, bx, by)
    e0 = _edge_fn(px, py, bx, by, cx, cy)
    e1 = _edge_fn(px, py, cx, cy, ax, ay)
    e2 = _edge_fn(px, py, ax, ay, bx, by)
    if cull_back_faces:
        orientation_ok = area > 0
    else:
        orientation_ok = torch.abs(area) > 1e-12
    safe_area = torch.where(torch.abs(area) > 1e-12, area, 1e-12)
    w0 = e0 / safe_area
    w1 = e1 / safe_area
    w2 = e2 / safe_area
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    d2 = torch.minimum(
        torch.minimum(
            _point_segment_d2(px, py, ax, ay, bx, by),
            _point_segment_d2(px, py, bx, by, cx, cy),
        ),
        _point_segment_d2(px, py, cx, cy, ax, ay),
    )
    signed_d2 = torch.where(inside, -d2, d2)
    hit = orientation_ok & (inside | (d2 <= blur_radius * blur_radius))
    if perspective_correct:
        pa = w0 * (1.0 / torch.clamp(az, min=1e-9))
        pb = w1 * (1.0 / torch.clamp(bz, min=1e-9))
        pc = w2 * (1.0 / torch.clamp(cz, min=1e-9))
        denom = torch.clamp(pa + pb + pc, min=1e-12)
        w0, w1, w2 = pa / denom, pb / denom, pc / denom
    if clip_barycentrics:
        c0 = torch.clamp(w0, 0.0, 1.0)
        c1 = torch.clamp(w1, 0.0, 1.0)
        c2 = torch.clamp(w2, 0.0, 1.0)
        denom = torch.clamp(c0 + c1 + c2, min=1e-12)
        w0, w1, w2 = c0 / denom, c1 / denom, c2 / denom
    depth = w0 * az + w1 * bz + w2 * cz
    hit = hit & (depth > 0)
    return hit, depth, (w0, w1, w2), signed_d2


def _nearest(hit, depth, bary, signed_d2, face_ids):
    """Per row, the hit with the smallest (depth, face id) along the last
    axis. ``face_ids`` broadcasts against ``hit``. Returns (face int32,
    depth, bary [..., 3], signed_d2) with the empty convention applied."""
    d = torch.where(hit, depth, BG_DEPTH)
    dmin = torch.amin(d, dim=-1)
    ids = torch.broadcast_to(face_ids, hit.shape)
    cand = hit & (d == dmin[..., None])
    fid = torch.where(cand, ids, _INT_MAX)
    best = torch.amin(fid, dim=-1)
    pos = torch.argmax((cand & (fid == best[..., None])).to(torch.int8), dim=-1, keepdim=True)
    empty = dmin >= BG_DEPTH

    def take(a):
        return torch.gather(torch.broadcast_to(a, hit.shape), -1, pos)[..., 0]

    b = torch.stack([take(x) for x in bary], dim=-1)
    return (
        torch.where(empty, -1, best).to(torch.int32),
        dmin,
        torch.where(empty[..., None], 0.0, b),
        torch.where(empty, 0.0, take(signed_d2)),
    )


# ---------------------------------------------------------------------------
# naive rasterizer (oracle)
# ---------------------------------------------------------------------------


def rasterize_naive(
    face_vertices: torch.Tensor,
    valid_faces: torch.Tensor,
    image_size: tuple[int, int],
    faces_per_pixel: int = 1,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
    row_chunk: int = 16,
) -> Fragments:
    """Brute-force all-pixels x all-faces rasterization (correctness oracle),
    nearest fragment per pixel."""
    if faces_per_pixel != 1:
        raise NotImplementedError("K > 1 fragments are not ported yet (ROADMAP A10)")
    h, w = image_size
    dev = face_vertices.device
    f = face_vertices.shape[0]
    fv = torch.where(valid_faces[:, None, None], face_vertices, -1e9).reshape(f, 9)
    cols = tuple(fv[None, :, q] for q in range(9))
    face_ids = torch.arange(f, dtype=torch.int64, device=dev)[None]
    outs = []
    for r0 in range(0, h, row_chunk):
        rows = torch.arange(r0, min(h, r0 + row_chunk), device=dev)
        px = torch.arange(w, device=dev, dtype=torch.float32).repeat(rows.shape[0])[:, None]
        py = rows.to(torch.float32).repeat_interleave(w)[:, None]
        hit, depth, bary, d2 = _fragment_math(
            px, py, cols, blur_radius, perspective_correct, clip_barycentrics, cull_back_faces
        )
        outs.append(_nearest(hit, depth, bary, d2, face_ids))
    face, depth, bary, dist = (torch.cat([o[i] for o in outs]) for i in range(4))
    return Fragments(
        face_indices=face.reshape(h, w, 1),
        depths=depth.reshape(h, w, 1),
        barycentrics=bary.reshape(h, w, 1, 3),
        distances=dist.reshape(h, w, 1),
    )


# ---------------------------------------------------------------------------
# kernel B1: per-tile nearest fragment
# ---------------------------------------------------------------------------

_TILE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int,  # faces, num_faces
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table, num_tiles, bin_capacity
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tile_size, tiles_w, H, W
    ctypes.c_float, ctypes.c_float,  # |blur radius|, blur radius^2
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # perspective, clip, cull
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
    ctypes.c_void_p,  # stream
]
_OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_void_p]  # tile_size, int* blocks per SM

# FP32 adds/subtracts/multiplies/divides the rasterizer's function needs.
# Per (pixel, face) test: the pixel relative to the 3 corners (6), 3 edge
# functions on those and the face's edge vectors (3 x 3), 3 barycentric
# divisions (3), 3 point-segment distances (3 x 11: dot 3, divide 1, offset
# 4, squared length 3). Once per bin entry: 3 edge vectors (6), the area (3),
# 3 squared edge lengths (9), 3 perspective reciprocals (3). Comparisons,
# min/max and the work of hits only are not counted: the count is a lower one
RASTER_OPS_PER_TEST = 51
RASTER_OPS_PER_ENTRY = 21


def _tiles_w(image_size, tile_size: int, table: torch.Tensor) -> int:
    h, w = image_size
    th, tw = -(-h // tile_size), -(-w // tile_size)
    if table.ndim != 2 or table.shape[0] != th * tw:
        raise ValueError(f"table must be [{th} x {tw} tiles, K], got {list(table.shape)}")
    return tw


def _detile(arr: torch.Tensor, th: int, tw: int, tile_size: int, extra: tuple = ()):
    """Tile-major [T, tile_size^2, ...] -> image rows [th * ts, tw * ts, ...]."""
    arr = arr.reshape(th, tw, tile_size, tile_size, *extra)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(extra)))
    return arr.permute(*perm).reshape(th * tile_size, tw * tile_size, *extra)


def rasterize_tiles_plain(
    faces: torch.Tensor,
    table: torch.Tensor,
    image_size: tuple[int, int],
    tile_size: int,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
):
    """Per pixel, the nearest fragment of the faces listed in its tile's bin.

    faces f32[F, 9] (u, v, z per corner); table int32[T, K] face ids (-1 =
    empty, bins filled from the front) for the row-major grid of
    ``tile_size``^2 tiles covering ``image_size`` = (H, W). Returns face
    int32[H, W] (-1 = empty), depth f32[H, W] (BG_DEPTH = empty), bary
    f32[H, W, 3] and signed squared distance f32[H, W] (negative inside).
    """
    h, w = image_size
    tw = _tiles_w(image_size, tile_size, table)
    t_count, k = table.shape
    th = t_count // tw
    dev = faces.device
    p = tile_size * tile_size
    lin = torch.arange(p, device=dev)
    chunk = max(1, (1 << 21) // max(1, p * k))
    out = []
    for s in range(0, t_count, chunk):
        tiles = torch.arange(s, min(t_count, s + chunk), device=dev)
        px = ((tiles % tw) * tile_size)[:, None] + (lin % tile_size)[None]
        py = ((tiles // tw) * tile_size)[:, None] + (lin // tile_size)[None]
        ids = table[s : s + chunk].long()
        present = ids >= 0
        fv = faces[ids.clamp(min=0)]  # [tc, K, 9]
        cols = tuple(fv[:, None, :, q] for q in range(9))
        hit, depth, bary, d2 = _fragment_math(
            px.to(torch.float32)[..., None], py.to(torch.float32)[..., None], cols,
            blur_radius, perspective_correct, clip_barycentrics, cull_back_faces,
        )
        hit = hit & present[:, None, :]
        out.append(_nearest(hit, depth, bary, d2, ids[:, None, :]))
    face, depth, bary, dist = (torch.cat([o[i] for o in out]) for i in range(4))
    return (
        _detile(face, th, tw, tile_size)[:h, :w].contiguous(),
        _detile(depth, th, tw, tile_size)[:h, :w].contiguous(),
        _detile(bary, th, tw, tile_size, (3,))[:h, :w].contiguous(),
        _detile(dist, th, tw, tile_size)[:h, :w].contiguous(),
    )


def rasterize_tiles_cuda(
    faces: torch.Tensor,
    table: torch.Tensor,
    image_size: tuple[int, int],
    tile_size: int,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
):
    """Kernel B1 (``csrc/rasterize_tiles.cu``) on card tensors; same contract
    as :func:`rasterize_tiles_plain`."""
    dev = faces.device
    if faces.dtype != torch.float32 or faces.ndim != 2 or faces.shape[1] != 9:
        raise ValueError(f"faces must be f32[F, 9], got {faces.dtype}{list(faces.shape)}")
    if table.dtype != torch.int32 or table.ndim != 2:
        raise ValueError(f"table must be int32[T, K], got {table.dtype}{list(table.shape)}")
    if table.device != dev:
        raise ValueError(f"table is on {table.device}, faces on {dev}")
    if not (faces.is_contiguous() and table.is_contiguous()):
        raise ValueError("faces and table must be contiguous")
    if not 1 <= tile_size <= 32:
        raise ValueError("tile_size must be in [1, 32]")
    tw = _tiles_w(image_size, tile_size, table)
    h, w = image_size
    t_count, k = table.shape
    face_out = torch.empty((h, w), dtype=torch.int32, device=dev)
    depth_out = torch.empty((h, w), dtype=torch.float32, device=dev)
    bary_out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    dist_out = torch.empty((h, w), dtype=torch.float32, device=dev)
    status = native.entry_point("rasterize_tiles", _TILE_ARGTYPES)(
        faces.data_ptr(), faces.shape[0],
        table.data_ptr(), t_count, k,
        tile_size, tw, h, w,
        abs(blur_radius),
        blur_radius * blur_radius,  # ctypes rounds to f32 as the plain compare does
        int(perspective_correct), int(clip_barycentrics), int(cull_back_faces),
        face_out.data_ptr(), depth_out.data_ptr(), bary_out.data_ptr(), dist_out.data_ptr(),
        native.stream_handle(dev),
    )
    native.check(status, "rasterize_tiles")
    native.launch_counts["rasterize_tiles"] += 1
    return face_out, depth_out, bary_out, dist_out


def rasterize_tiles_grid(num_tiles: int, tile_size: int = 16) -> tuple[int, int]:
    """(blocks, threads per block) of kernel B1's launch: one block per tile,
    128 threads for tiles up to 16 px, 256 above (``csrc/rasterize_tiles.cu``)."""
    return num_tiles, 128 if tile_size <= 16 else 256


def rasterize_tiles_occupancy(tile_size: int = 16) -> int:
    """Resident blocks per SM of kernel B1 at ``tile_size`` (one block per
    tile), as the CUDA runtime reports it for the current card."""
    blocks = ctypes.c_int(0)
    status = native.entry_point("rasterize_tiles", _OCCUPANCY_ARGTYPES, "rasterize_tiles_occupancy")(
        tile_size, ctypes.byref(blocks)
    )
    native.check(status, "rasterize_tiles_occupancy")
    return blocks.value


def rasterize_tiles(
    faces: torch.Tensor, table: torch.Tensor, image_size: tuple[int, int], tile_size: int, **kwargs
):
    """Kernel B1 for CUDA tensors, its plain version for CPU tensors."""
    if faces.device.type == "cuda":
        return rasterize_tiles_cuda(faces, table, image_size, tile_size, **kwargs)
    if faces.device.type == "cpu":
        return rasterize_tiles_plain(faces, table, image_size, tile_size, **kwargs)
    raise ValueError(f"unsupported device {faces.device}")


def rasterize_tiles_work(
    faces: torch.Tensor,
    table: torch.Tensor,
    image_size: tuple[int, int],
    tile_size: int,
    blur_radius: float = 0.0,
) -> dict[str, int]:
    """The work B1's function needs on these inputs, for its bound.

    ``tests``: over all bin entries, the tile's pixels (inside the image)
    that lie in the face's box widened by ``blur_radius`` (in float64): only
    those can be a hit. ``tile_tests``: every pixel of the tile per entry,
    the count the kernel's first version was held to. ``operations`` =
    tests x RASTER_OPS_PER_TEST + entries x RASTER_OPS_PER_ENTRY. ``bytes``
    reads what the function needs once: the bin entries and the -1 that
    ends each bin that is not full (4 B each), the 9 floats of each distinct
    face listed (36 B), and writes every output byte once.
    """
    h, w = image_size
    tw = _tiles_w(image_size, tile_size, table)
    dev = table.device
    ids = table.long()
    present = ids >= 0
    fv = faces.to(torch.float64)[ids.clamp(min=0)]  # [T, K, 9]
    tiles = torch.arange(table.shape[0], device=dev)
    x0 = (tiles % tw) * tile_size
    y0 = (tiles // tw) * tile_size
    x1 = torch.clamp(x0 + tile_size, max=w) - 1
    y1 = torch.clamp(y0 + tile_size, max=h) - 1
    r = abs(blur_radius)

    def span(coords, p0, p1):
        # integer pixels p in [p0, p1] with min(coords) - r <= p <= max(coords) + r
        lo = torch.maximum(torch.ceil(coords.amin(-1) - r), p0[:, None].to(torch.float64))
        hi = torch.minimum(torch.floor(coords.amax(-1) + r), p1[:, None].to(torch.float64))
        return torch.clamp(hi - lo + 1, min=0)

    in_box = span(fv[..., 0::3], x0, x1) * span(fv[..., 1::3], y0, y1)
    tile_px = (x1 - x0 + 1) * (y1 - y0 + 1)
    per_bin = present.sum(1)
    entries = int(per_bin.sum())
    tests = int(torch.where(present, in_box, 0.0).sum())
    tile_tests = int((per_bin * tile_px).sum())
    ends = int((per_bin < table.shape[1]).sum())
    distinct_faces = int(torch.unique(ids[present]).numel())
    return {
        "entries": entries,
        "tests": tests,
        "tile_tests": tile_tests,
        "distinct_faces": distinct_faces,
        "operations": tests * RASTER_OPS_PER_TEST + entries * RASTER_OPS_PER_ENTRY,
        "bytes": (entries + ends) * 4 + distinct_faces * 36 + h * w * (4 + 4 + 12 + 4),
    }


# ---------------------------------------------------------------------------
# binned rasterizer
# ---------------------------------------------------------------------------


class BinTable(NamedTuple):
    """Phase 1 output: per-tile face lists + overflow counts."""

    table: torch.Tensor  # int32[T, max_faces_per_bin], -1 = empty
    tiles_h: int
    tiles_w: int
    dropped_large_faces: torch.Tensor
    dropped_bin_entries: torch.Tensor


def bin_faces(
    face_vertices: torch.Tensor,
    valid_faces: torch.Tensor,
    image_size: tuple[int, int],
    blur_radius: float = 0.0,
    tile_size: int = 16,
    max_faces_per_bin: int = 256,
    small_span: int = 4,
    max_large_faces: int = 512,
) -> BinTable:
    """Phase 1: bin face AABBs to tiles (stable sort + ``searchsorted``).

    Faces whose AABB spans at most 2x2 tiles are listed in their four corner
    tiles; up to ``small_span`` tiles per axis, a capped medium path adds the
    non-corner tiles; larger faces go through a capped large path over their
    whole AABB. Each bin keeps its first ``max_faces_per_bin`` entries in
    (tier, face id) order.
    """
    h, w = image_size
    dev = face_vertices.device
    f = face_vertices.shape[0]
    th = (h + tile_size - 1) // tile_size
    tw = (w + tile_size - 1) // tile_size
    num_tiles = th * tw
    margin = blur_radius

    fv9 = face_vertices.reshape(f, 9)
    us = (fv9[:, 0], fv9[:, 3], fv9[:, 6])
    vs = (fv9[:, 1], fv9[:, 4], fv9[:, 7])
    u_min = torch.minimum(torch.minimum(us[0], us[1]), us[2])
    u_max = torch.maximum(torch.maximum(us[0], us[1]), us[2])
    v_min = torch.minimum(torch.minimum(vs[0], vs[1]), vs[2])
    v_max = torch.maximum(torch.maximum(vs[0], vs[1]), vs[2])
    u0 = torch.clamp((u_min - margin) / tile_size, 0, tw - 1).to(torch.int64)
    u1 = torch.clamp((u_max + margin) / tile_size, 0, tw - 1).to(torch.int64)
    v0 = torch.clamp((v_min - margin) / tile_size, 0, th - 1).to(torch.int64)
    v1 = torch.clamp((v_max + margin) / tile_size, 0, th - 1).to(torch.int64)
    on_screen = (
        valid_faces
        & (u_max >= -margin)
        & (u_min < w + margin)
        & (v_max >= -margin)
        & (v_min < h + margin)
    )
    span_x = u1 - u0 + 1
    span_y = v1 - v0 + 1
    small2 = on_screen & (span_x <= 2) & (span_y <= 2)
    medium = on_screen & ~small2 & (span_x <= small_span) & (span_y <= small_span)
    large = on_screen & ~small2 & ~medium

    # corner pairs (small + medium faces)
    not_large = small2 | medium
    face_ids = torch.arange(f, device=dev)
    tiles_c, ok_c = [], []
    for cu, cv, distinct in ((u0, v0, ""), (u1, v0, "u"), (u0, v1, "v"), (u1, v1, "uv")):
        ok = not_large
        if "u" in distinct:
            ok = ok & (u1 > u0)
        if "v" in distinct:
            ok = ok & (v1 > v0)
        tiles_c.append(cv * tw + cu)
        ok_c.append(ok)

    # medium pairs: capped face set x small_span^2 offsets, corners excluded
    max_medium_faces = max_large_faces * 16
    med_ids, _ = compact_mask_indices(medium, max_medium_faces, fill_value=f)
    has_med = med_ids < f
    safe_med = torch.where(has_med, med_ids, 0)
    offs = torch.arange(small_span, device=dev)
    dx = offs.repeat(small_span)
    dy = offs.repeat_interleave(small_span)
    mu0, mu1, mv0, mv1 = u0[safe_med], u1[safe_med], v0[safe_med], v1[safe_med]
    tx = mu0[:, None] + dx[None]
    ty = mv0[:, None] + dy[None]
    is_corner = ((tx == mu0[:, None]) | (tx == mu1[:, None])) & (
        (ty == mv0[:, None]) | (ty == mv1[:, None])
    )
    ok_m = has_med[:, None] & (tx <= mu1[:, None]) & (ty <= mv1[:, None]) & ~is_corner
    tile_m = (ty * tw + tx).reshape(-1)
    face_m = safe_med[:, None].expand(-1, small_span * small_span).reshape(-1)

    # large pairs: capped face set x all tiles, masked to each AABB
    large_ids, _ = compact_mask_indices(large, max_large_faces, fill_value=f)
    has_large = large_ids < f
    safe_large = torch.where(has_large, large_ids, 0)
    all_tiles = torch.arange(num_tiles, device=dev)
    ttx = all_tiles % tw
    tty = all_tiles // tw
    in_box = (
        has_large[:, None]
        & (ttx[None] >= u0[safe_large][:, None])
        & (ttx[None] <= u1[safe_large][:, None])
        & (tty[None] >= v0[safe_large][:, None])
        & (tty[None] <= v1[safe_large][:, None])
    )
    tile_l = all_tiles[None].expand(in_box.shape).reshape(-1)
    face_l = safe_large[:, None].expand(in_box.shape).reshape(-1)

    tile_all = torch.cat(tiles_c + [tile_m, tile_l])
    face_all = torch.cat([face_ids] * 4 + [face_m, face_l])
    ok_all = torch.cat(ok_c + [ok_m.reshape(-1), in_box.reshape(-1)])

    # stable sort by tile (invalid pairs last), the face payload gathered after
    sort_key = torch.where(ok_all, tile_all, num_tiles)
    sorted_tiles, order = torch.sort(sort_key, stable=True)
    sorted_faces = face_all[order]
    starts = torch.searchsorted(
        sorted_tiles, torch.arange(num_tiles + 1, device=dev), side="left"
    )
    take = starts[:num_tiles, None] + torch.arange(max_faces_per_bin, device=dev)[None]
    within = take < starts[1:, None]
    table = torch.where(
        within, sorted_faces[torch.clamp(take, max=sorted_faces.shape[0] - 1)], -1
    ).to(torch.int32)

    dropped_large = (
        large.sum() - (has_large & large[safe_large]).sum()
        + medium.sum() - (has_med & medium[safe_med]).sum()
    )
    dropped_bins = torch.clamp(starts[1:] - starts[:-1] - max_faces_per_bin, min=0).sum()
    return BinTable(table.contiguous(), th, tw, dropped_large, dropped_bins)


def rasterize_binned(
    face_vertices: torch.Tensor,
    valid_faces: torch.Tensor,
    image_size: tuple[int, int],
    faces_per_pixel: int = 1,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
    tile_size: int = 16,
    max_faces_per_bin: int = 256,
    small_span: int = 4,
    max_large_faces: int = 512,
    return_overflow: bool = False,
):
    """Two-phase tiled rasterization: phase 1 (:func:`bin_faces`) in plain
    PyTorch, phase 2 through kernel B1 (:func:`rasterize_tiles`).

    With ``return_overflow`` the result is ``(Fragments, overflow)`` where
    ``overflow`` = {"dropped_large_faces", "dropped_bin_entries"} (tensors);
    non-zero counts mean a static capacity was exceeded.
    """
    if faces_per_pixel != 1:
        raise NotImplementedError("K > 1 fragments are not ported yet (ROADMAP A10)")
    f = face_vertices.shape[0]
    bins = bin_faces(
        face_vertices, valid_faces, image_size, blur_radius, tile_size,
        max_faces_per_bin, small_span, max_large_faces,
    )
    # bins list only on-screen faces, which are valid ones: the kernel reads
    # the faces as they are, with no masked copy
    face, depth, bary, dist = rasterize_tiles(
        face_vertices.reshape(f, 9).contiguous(), bins.table, image_size, tile_size,
        blur_radius=blur_radius,
        perspective_correct=perspective_correct,
        clip_barycentrics=clip_barycentrics,
        cull_back_faces=cull_back_faces,
    )
    frag = Fragments(
        face_indices=face[..., None],
        depths=depth[..., None],
        barycentrics=bary[:, :, None, :],
        distances=dist[..., None],
    )
    if not return_overflow:
        return frag
    return frag, {
        "dropped_large_faces": bins.dropped_large_faces,
        "dropped_bin_entries": bins.dropped_bin_entries,
    }
