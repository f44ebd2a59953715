"""Triangle rasterization: the naive oracle, the two-phase binned
rasterizer whose second phase is kernel B1, and the splat rasterizer.

Port of ``dynamicfuion_python_tpu/ops/rasterize.py``, with phase 2 of
``rasterize_binned`` at K = 1 replacing the Pallas TPU kernel
``rasterize_tiles_pallas`` (``ops/pallas/rasterize_tiles.py``). K > 1
fragments never reached that kernel in the JAX package (XLA's per-tile
top-k); here they are plain PyTorch on every device, as is the splat path.

Rasterization happens in pixel space: face vertices arrive as (u, v, z) with
u, v in pixels and z the camera-space depth, and pixel centers sit at integer
coordinates. Each path keeps, per pixel, the K nearest fragments in
ascending depth. Ties on equal depth: at K = 1 the lower face id wins on
every path (the rule of the JAX fitter's ``rasterize_splat``); at K > 1 the
naive and binned paths keep the JAX package's ``top_k`` order (the lower
face id, the earlier bin entry), and the splat path the lower face id.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.ops.mesh_expand import expand_project_faces
from dynamicfuion_python_tpu_torch.utils import trace

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


def project_face_soup(
    face_soup: torch.Tensor,
    intrinsics: torch.Tensor,
    near: float = 0.05,
    far: float = 10.0,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space triangle soup f32[F, 3, 3] -> pixel-space face vertices
    + clip mask (the clip rule of :func:`extract_face_vertices`), with no
    index gather."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x, y, z = face_soup[..., 0], face_soup[..., 1], face_soup[..., 2]
    ok = torch.all((z > near) & (z < far), dim=-1)
    if valid is not None:
        ok = ok & valid
    safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    return torch.stack([x / safe_z * fx + cx, y / safe_z * fy + cy, z], dim=-1), ok


def pixel_to_ndc(face_vertices_pix: torch.Tensor, image_size) -> torch.Tensor:
    """Pixel-space (u, v, z) -> PyTorch3D-style NDC (+x left, +y up, the
    short side spans [-1, 1])."""
    h, w = image_size
    s = min(h, w)
    u, v, z = (face_vertices_pix[..., i] for i in range(3))
    return torch.stack([-(2.0 * u - w) / s, -(2.0 * v - h) / s, z], dim=-1)


def ndc_to_pixel(face_vertices_ndc: torch.Tensor, image_size) -> torch.Tensor:
    h, w = image_size
    s = min(h, w)
    x, y, z = (face_vertices_ndc[..., i] for i in range(3))
    return torch.stack([(w - s * x) / 2.0, (h - s * y) / 2.0, z], dim=-1)


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
    clip_barycentrics: bool, cull_back_faces: bool, divide_by_depth: bool = False,
):
    """Evaluate faces at pixels (broadcasting). ``cols`` = the 9 face columns
    (ax, ay, az, bx, by, bz, cx, cy, cz). Returns (hit, depth, (b0, b1, b2),
    signed_d2). The perspective correction multiplies by each corner's
    1 / z, as the JAX package's tiled and naive paths do; with
    ``divide_by_depth`` it divides by z, as its splat path does (the two
    round differently)."""
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
        corners = ((w0, az), (w1, bz), (w2, cz))
        if divide_by_depth:
            pa, pb, pc = (wi / torch.clamp(z, min=1e-9) for wi, z in corners)
        else:
            pa, pb, pc = (wi * (1.0 / torch.clamp(z, min=1e-9)) for wi, z in corners)
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


def _top_k_fragments(hit, depth, bary, signed_d2, face_ids, k: int):
    """Per row, the K nearest hits along the last axis, ascending; equal
    depths keep their order along the axis (the order ``jax.lax.top_k``
    gives), by a stable sort. ``face_ids`` broadcasts against ``hit``;
    ``bary`` is a 3-tuple. Returns (face int32, depth, bary [..., K, 3],
    signed_d2) with the empty convention applied."""
    key = torch.where(hit, depth, BG_DEPTH)
    k = min(k, key.shape[-1])
    depths, idx = torch.sort(key, dim=-1, stable=True)
    depths, idx = depths[..., :k], idx[..., :k]

    def take(a):
        return torch.gather(torch.broadcast_to(a, key.shape), -1, idx)

    empty = depths >= BG_DEPTH
    faces = torch.where(empty, -1, take(face_ids)).to(torch.int32)
    sel_bary = torch.stack([take(b) for b in bary], dim=-1)
    return (
        faces,
        depths,
        torch.where(empty[..., None], 0.0, sel_bary),
        torch.where(empty, 0.0, take(signed_d2)),
    )


def _pad_k(frag: Fragments, k: int) -> Fragments:
    """Pad the fragment axis with empty fragments up to ``k``."""
    have = frag.face_indices.shape[-1]
    if have == k:
        return frag
    h, w = frag.face_indices.shape[:2]
    dev = frag.depths.device
    pad = k - have
    return Fragments(
        face_indices=torch.cat(
            [frag.face_indices, torch.full((h, w, pad), -1, dtype=torch.int32, device=dev)], -1
        ),
        depths=torch.cat([frag.depths, torch.full((h, w, pad), BG_DEPTH, device=dev)], -1),
        barycentrics=torch.cat([frag.barycentrics, torch.zeros((h, w, pad, 3), device=dev)], -2),
        distances=torch.cat([frag.distances, torch.zeros((h, w, pad), device=dev)], -1),
    )


def _merge_fragments(a: Fragments, b: Fragments, k: int) -> Fragments:
    """Merge two K-fragment buffers per pixel, keeping the K nearest; on
    equal depth ``a``'s fragments come first, then each buffer's order."""
    depths, idx = torch.sort(torch.cat([a.depths, b.depths], -1), dim=-1, stable=True)
    depths, idx = depths[..., :k], idx[..., :k]

    def take(x, y):
        return torch.gather(torch.cat([x, y], -1), -1, idx)

    bary = torch.cat([a.barycentrics, b.barycentrics], -2)
    return Fragments(
        face_indices=take(a.face_indices, b.face_indices),
        depths=depths,
        barycentrics=torch.gather(bary, -2, idx[..., None].expand(*idx.shape, 3)),
        distances=take(a.distances, b.distances),
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
    the K nearest fragments per pixel."""
    h, w = image_size
    dev = face_vertices.device
    f = face_vertices.shape[0]
    k = min(faces_per_pixel, f)
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
        if faces_per_pixel == 1:
            face, depth, bary, d2 = _nearest(hit, depth, bary, d2, face_ids)
            outs.append((face[:, None], depth[:, None], bary[:, None], d2[:, None]))
        else:
            outs.append(_top_k_fragments(hit, depth, bary, d2, face_ids, k))
    face, depth, bary, dist = (torch.cat([o[i] for o in outs]) for i in range(4))
    frag = Fragments(
        face_indices=face.reshape(h, w, k),
        depths=depth.reshape(h, w, k),
        barycentrics=bary.reshape(h, w, k, 3),
        distances=dist.reshape(h, w, k),
    )
    return _pad_k(frag, faces_per_pixel)


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


def rasterize_tiles_top_k(
    faces: torch.Tensor,
    table: torch.Tensor,
    image_size: tuple[int, int],
    tile_size: int,
    faces_per_pixel: int,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
) -> Fragments:
    """Phase 2 of the binned rasterizer at K > 1, plain PyTorch on every
    device (the JAX package's per-tile top-k, which never reached its TPU
    kernel): per pixel, the ``faces_per_pixel`` nearest fragments among its
    tile's bin, equal depths in bin order. Tiles go in chunks that keep the
    [tiles, pixels, bin] intermediates at 2^21 entries each."""
    h, w = image_size
    tw = _tiles_w(image_size, tile_size, table)
    t_count, cap = table.shape
    th = t_count // tw
    k = min(faces_per_pixel, cap)
    dev = faces.device
    p = tile_size * tile_size
    lin = torch.arange(p, device=dev)
    chunk = max(1, (1 << 21) // max(1, p * cap))
    out = []
    for s in range(0, t_count, chunk):
        tiles = torch.arange(s, min(t_count, s + chunk), device=dev)
        px = ((tiles % tw) * tile_size)[:, None] + (lin % tile_size)[None]
        py = ((tiles // tw) * tile_size)[:, None] + (lin // tile_size)[None]
        ids = table[s : s + chunk].long()
        fv = faces[ids.clamp(min=0)]  # [tc, K, 9]
        cols = tuple(fv[:, None, :, q] for q in range(9))
        hit, depth, bary, d2 = _fragment_math(
            px.to(torch.float32)[..., None], py.to(torch.float32)[..., None], cols,
            blur_radius, perspective_correct, clip_barycentrics, cull_back_faces,
        )
        hit = hit & (ids >= 0)[:, None, :]
        out.append(_top_k_fragments(hit, depth, bary, d2, ids[:, None, :], k))
    face, depth, bary, dist = (torch.cat([o[i] for o in out]) for i in range(4))
    return _pad_k(Fragments(
        face_indices=_detile(face, th, tw, tile_size, (k,))[:h, :w].contiguous(),
        depths=_detile(depth, th, tw, tile_size, (k,))[:h, :w].contiguous(),
        barycentrics=_detile(bary, th, tw, tile_size, (k, 3))[:h, :w].contiguous(),
        distances=_detile(dist, th, tw, tile_size, (k,))[:h, :w].contiguous(),
    ), faces_per_pixel)


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
    trace.count("b1.launches")
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
    PyTorch, phase 2 through kernel B1 (:func:`rasterize_tiles`) at K = 1 and
    through :func:`rasterize_tiles_top_k` above.

    With ``return_overflow`` the result is ``(Fragments, overflow)`` where
    ``overflow`` = {"dropped_large_faces", "dropped_bin_entries"} (tensors);
    non-zero counts mean a static capacity was exceeded.
    """
    f = face_vertices.shape[0]
    bins = bin_faces(
        face_vertices, valid_faces, image_size, blur_radius, tile_size,
        max_faces_per_bin, small_span, max_large_faces,
    )
    # bins list only on-screen faces, which are valid ones: phase 2 reads
    # the faces as they are, with no masked copy
    faces9 = face_vertices.reshape(f, 9).contiguous()
    options = dict(
        blur_radius=blur_radius,
        perspective_correct=perspective_correct,
        clip_barycentrics=clip_barycentrics,
        cull_back_faces=cull_back_faces,
    )
    if faces_per_pixel == 1:
        face, depth, bary, dist = rasterize_tiles(faces9, bins.table, image_size, tile_size, **options)
        frag = Fragments(
            face_indices=face[..., None],
            depths=depth[..., None],
            barycentrics=bary[:, :, None, :],
            distances=dist[..., None],
        )
    else:
        frag = rasterize_tiles_top_k(faces9, bins.table, image_size, tile_size, faces_per_pixel, **options)
    if not return_overflow:
        return frag
    return frag, {
        "dropped_large_faces": bins.dropped_large_faces,
        "dropped_bin_entries": bins.dropped_bin_entries,
    }


# ---------------------------------------------------------------------------
# splat rasterizer (faces a few pixels across)
# ---------------------------------------------------------------------------
#
# Each face is evaluated directly at the few pixel centers inside its box
# (widened by the blur radius), in tiers of 1, 2x2, 4x4 and 8x8 candidate
# pixels; the (pixel, depth, face) entries of all tiers, plus one sentinel
# per pixel, sort lexicographically, and pixel p's K nearest fragments sit
# right after its sentinel. Faces wider than 8 px (+2 blur) go through
# rasterize_naive on a capped subset and merge by depth. The JAX package's
# three-key sort becomes two stable sorts here: by face id, then by one
# int64 key (pixel << 32 | depth bits + 2^31), so equal depths resolve to
# the lower face id.


def _eval_columns(
    px, py, cols, blur_radius: float, perspective_correct: bool,
    clip_barycentrics: bool, cull_back_faces: bool,
):
    """Fragment math on flat columns, as the JAX splat path rounds it: px /
    py f32[N] pixel centers, cols the 9-tuple (ax, ay, az, ..., cz) of f32[N].
    Returns (hit bool[N], depth f32[N], bary f32[N, 3], signed_d2 f32[N])."""
    hit, depth, bary, d2 = _fragment_math(
        px, py, cols, blur_radius, perspective_correct, clip_barycentrics, cull_back_faces,
        divide_by_depth=True,
    )
    return hit, depth, torch.stack(bary, dim=-1), d2


def _compact_indices(mask: torch.Tensor, cap: int):
    """Indices of the first ``cap`` true entries (ascending), with no host
    sync. Returns (idx int64[min(cap, n)], 0 where absent; has; dropped =
    max(count - cap, 0)), as the JAX helper's slice of its sort."""
    n = mask.shape[0]
    idx, count = compact_mask_indices(mask, min(cap, n), fill_value=n)
    has = idx < n
    return torch.where(has, idx, 0), has, torch.clamp(count - cap, min=0)


_INT32_MIN = -(2**31)


def rasterize_splat(
    face_vertices: torch.Tensor,
    valid_faces: torch.Tensor,
    image_size: tuple[int, int],
    faces_per_pixel: int = 1,
    blur_radius: float = 0.0,
    perspective_correct: bool = True,
    clip_barycentrics: bool = False,
    cull_back_faces: bool = False,
    quad_cap: int | None = None,
    hex_cap: int | None = None,
    oct_cap: int | None = None,
    max_large_faces: int = 512,
    return_overflow: bool = False,
):
    """Splat-path rasterization (see the note above), same contract as
    :func:`rasterize_naive`.

    ``quad_cap`` / ``hex_cap`` / ``oct_cap`` bound the 2x2-, 4x4- and
    8x8-candidate tiers (defaults F/4, F/16, F/64, floored at 4096 / 4096 /
    2048); ``max_large_faces`` bounds the faces wider than 8 px (+2 blur)
    that go through :func:`rasterize_naive` (0: they are dropped). Overflow
    past the caps is reported as in the JAX package: tier drops under
    ``dropped_bin_entries``, large-face drops under ``dropped_large_faces``.
    The large-face pass runs only when such a face exists, which costs one
    host sync.
    """
    h, w = image_size
    hw = h * w
    dev = face_vertices.device
    f = face_vertices.shape[0]
    k = faces_per_pixel
    r = float(blur_radius)
    quad_cap = min(min(f, max(4096, f // 4)) if quad_cap is None else quad_cap, f)
    hex_cap = min(min(f, max(4096, f // 16)) if hex_cap is None else hex_cap, f)
    oct_cap = min(min(f, max(2048, f // 64)) if oct_cap is None else oct_cap, f)
    max_large_faces = min(max_large_faces, f)
    options = (blur_radius, perspective_correct, clip_barycentrics, cull_back_faces)

    fv9 = face_vertices.reshape(f, 9)
    cols_all = tuple(fv9[:, i] for i in range(9))

    def window_origin(cols):
        u_min = torch.minimum(torch.minimum(cols[0], cols[3]), cols[6])
        v_min = torch.minimum(torch.minimum(cols[1], cols[4]), cols[7])
        # the first integer pixel center at or right of / below the box
        return torch.ceil(u_min - r).to(torch.int64), torch.ceil(v_min - r).to(torch.int64), u_min, v_min

    cu0, cv0, u_min, v_min = window_origin(cols_all)
    u_max = torch.maximum(torch.maximum(cols_all[0], cols_all[3]), cols_all[6])
    v_max = torch.maximum(torch.maximum(cols_all[1], cols_all[4]), cols_all[7])
    on_screen = valid_faces & (u_max >= -r) & (u_min < w - 1 + r) & (v_max >= -r) & (v_min < h - 1 + r)
    span_u = u_max - u_min + 2 * r
    span_v = v_max - v_min + 2 * r
    tier1 = on_screen & (span_u < 1) & (span_v < 1)
    tier2 = on_screen & ~tier1 & (span_u < 2) & (span_v < 2)
    tier4 = on_screen & ~tier1 & ~tier2 & (span_u < 4) & (span_v < 4)
    tier8 = on_screen & ~tier1 & ~tier2 & ~tier4 & (span_u < 8) & (span_v < 8)
    large = on_screen & ~tier1 & ~tier2 & ~tier4 & ~tier8
    face_ids = torch.arange(f, device=dev)

    def emit(cols, ids, cu, cv, active, n_cand):
        """The faces at an s x s window of pixel centers (n_cand = s^2): flat
        (pixel, depth bits, face id) columns, pixel hw + 1 where no hit."""
        s = int(round(n_cand**0.5))
        du = torch.arange(n_cand, device=dev)
        pu = cu[:, None] + (du % s)[None, :]
        pv = cv[:, None] + (du // s)[None, :]
        okp = active[:, None] & (pu >= 0) & (pu < w) & (pv >= 0) & (pv < h)
        hit, depth, _, _ = _eval_columns(
            pu.to(torch.float32), pv.to(torch.float32), tuple(c[:, None] for c in cols), *options
        )
        ok = okp & hit
        pix = torch.where(ok, pv * w + pu, hw + 1)
        dbits = torch.where(ok, torch.clamp(depth, min=0.0), 0.0).view(torch.int32)
        fid = torch.broadcast_to(ids[:, None], pix.shape)
        return pix.reshape(-1), dbits.reshape(-1), fid.reshape(-1)

    entries = [emit(cols_all, face_ids, cu0, cv0, tier1, 1)]

    # tiers 2 / 4 / 8 and the large faces: one compaction sort classifies all
    # four (key = class * F + face id; each class comes out contiguous and
    # ascending)
    n2, n4, n8, nl = (torch.sum(t) for t in (tier2, tier4, tier8, large))
    cls_key = torch.where(
        tier2, face_ids,
        torch.where(tier4, f + face_ids, torch.where(tier8, 2 * f + face_ids, torch.where(large, 3 * f + face_ids, 4 * f))),
    )
    cls_sorted = torch.sort(cls_key).values

    def tier_slice(start, cap, base):
        # a window of ``cap`` sorted entries from ``start``, clamped to the
        # array's end as jax.lax.dynamic_slice clamps it
        at = torch.clamp(start, max=f - cap) + torch.arange(cap, device=dev)
        ent = cls_sorted[at]
        has = (ent >= base) & (ent < base + f)
        return torch.where(has, ent - base, 0), has

    def tier_entries(idx, has, n_cand):
        cols = tuple(fv9[idx][:, i] for i in range(9))
        cu, cv, _, _ = window_origin(cols)
        return emit(cols, idx, cu, cv, has, n_cand)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    q_idx, q_has = tier_slice(zero, quad_cap, 0)
    x_idx, x_has = tier_slice(n2, hex_cap, f)
    o_idx, o_has = tier_slice(n2 + n4, oct_cap, 2 * f)
    entries += [tier_entries(q_idx, q_has, 4), tier_entries(x_idx, x_has, 16), tier_entries(o_idx, o_has, 64)]
    tier_drops = (
        torch.clamp(n2 - quad_cap, min=0) + torch.clamp(n4 - hex_cap, min=0) + torch.clamp(n8 - oct_cap, min=0)
    )

    # one sentinel per pixel (and a tail guard at pixel hw) with the least
    # depth key heads its pixel's segment
    sentinel_pix = torch.arange(hw + 1, device=dev)
    entries.append((
        sentinel_pix,
        torch.full((hw + 1,), _INT32_MIN, dtype=torch.int32, device=dev),
        torch.full((hw + 1,), -1, dtype=torch.int64, device=dev),
    ))
    pix_all, dbits_all, face_all = (torch.cat([e[i] for e in entries]) for i in range(3))
    by_face = torch.sort(face_all, stable=True).indices
    key = (pix_all[by_face] << 32) | (dbits_all[by_face].to(torch.int64) - _INT32_MIN)
    order = torch.sort(key, stable=True).indices
    sorted_face = face_all[by_face[order]]
    n_pairs = sorted_face.shape[0]
    # the sentinels' positions are ascending: one single-key sort finds them
    positions = torch.arange(n_pairs, device=dev)
    sent_pos = torch.sort(torch.where(sorted_face == -1, positions, n_pairs)).values[: hw + 1]
    take = sent_pos[:hw, None] + 1 + torch.arange(k, device=dev)[None]
    within = take < sent_pos[1:, None]
    sel_face = torch.where(within, sorted_face[torch.clamp(take, max=n_pairs - 1)], -1)  # [HW, K]

    # depth, barycentrics and distance re-evaluated at the winners
    win_rows = fv9[torch.clamp(sel_face, min=0).reshape(-1)]
    pix_lin = torch.arange(hw, device=dev)
    win_px = torch.repeat_interleave(pix_lin % w, k).to(torch.float32)
    win_py = torch.repeat_interleave(pix_lin // w, k).to(torch.float32)
    _, win_depth, win_bary, win_d2 = _eval_columns(
        win_px, win_py, tuple(win_rows[:, i] for i in range(9)), *options
    )
    have = sel_face.reshape(-1) >= 0
    frag = Fragments(
        face_indices=sel_face.to(torch.int32).reshape(h, w, k),
        depths=torch.where(have, torch.clamp(win_depth, min=0.0), BG_DEPTH).reshape(h, w, k),
        barycentrics=torch.where(have[:, None], win_bary, 0.0).reshape(h, w, k, 3),
        distances=torch.where(have, win_d2, 0.0).reshape(h, w, k),
    )

    if max_large_faces > 0:
        l_idx, l_has = tier_slice(n2 + n4 + n8, max_large_faces, 3 * f)
        large_drops = torch.clamp(nl - max_large_faces, min=0)
        if bool(nl > 0):
            lfrag = rasterize_naive(
                face_vertices[l_idx], l_has, image_size, faces_per_pixel=k,
                blur_radius=blur_radius, perspective_correct=perspective_correct,
                clip_barycentrics=clip_barycentrics, cull_back_faces=cull_back_faces,
            )
            lfaces = lfrag.face_indices.long()
            lfaces = torch.where(lfaces >= 0, l_idx[torch.clamp(lfaces, min=0)], -1).to(torch.int32)
            frag = _merge_fragments(frag, lfrag._replace(face_indices=lfaces), k)
    else:
        large_drops = nl
    if not return_overflow:
        return frag
    return frag, {"dropped_large_faces": large_drops, "dropped_bin_entries": tier_drops}
