"""Work of kernels B1 (per-tile nearest fragment, ``csrc/rasterize_tiles.cu``)
and B2 (face expansion and projection, ``csrc/mesh_expand.cu``), for
``raster.roofline_share``: inputs read once, outputs written once, FP32
operations of the arithmetic every call needs.

B1's count is the port's ``rasterize_tiles_work`` arithmetic (tested there
against a brute-force count): per bin entry, only the tile's pixels inside
the face's box can be a hit, each test costing RASTER_OPS_PER_TEST
operations, each entry RASTER_OPS_PER_ENTRY; bytes are the bin entries and
the -1 that ends each bin that is not full (4 B each), the 9 floats of each
distinct face listed, and the four per-pixel outputs (face id, depth, three
barycentrics, signed distance).
"""

from __future__ import annotations

import torch

from portbench.counts import PEAK_FP32_FLOPS, PEAK_HBM_BYTES_PER_S

# per pixel test: 3 edge functions (2 mul + 3 add/sub each: 15), the
# perspective-corrected barycentrics and depth (18), the squared distance
# to the 3 edges (4 each, squared length 3: 18); per bin entry: 3 edge
# vectors (6), the area (3), 3 squared edge lengths (9), 3 perspective
# reciprocals (3). Comparisons and min/max are not counted
RASTER_OPS_PER_TEST = 51
RASTER_OPS_PER_ENTRY = 21
# per face corner of B2: u and v each a divide, a multiply and an add
EXPAND_OPS_PER_CORNER = 6


def b1_work(faces: torch.Tensor, table: torch.Tensor, image_size, tile_size: int, blur_radius: float = 0.0) -> dict:
    """{"operations", "bytes"} of one B1 call: ``faces`` f32[F, 9] (u, v, z
    per corner), ``table`` int32[T, K] face ids per tile bin, -1 = empty."""
    h, w = image_size
    tw = -(-w // tile_size)
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
        lo = torch.maximum(torch.ceil(coords.amin(-1) - r), p0[:, None].to(torch.float64))
        hi = torch.minimum(torch.floor(coords.amax(-1) + r), p1[:, None].to(torch.float64))
        return torch.clamp(hi - lo + 1, min=0)

    in_box = span(fv[..., 0::3], x0, x1) * span(fv[..., 1::3], y0, y1)
    per_bin = present.sum(1)
    entries = int(per_bin.sum())
    tests = int(torch.where(present, in_box, 0.0).sum())
    ends = int((per_bin < table.shape[1]).sum())
    distinct_faces = int(torch.unique(ids[present]).numel())
    return {
        "operations": tests * RASTER_OPS_PER_TEST + entries * RASTER_OPS_PER_ENTRY,
        "bytes": (entries + ends) * 4 + distinct_faces * 36 + h * w * (4 + 4 + 12 + 4),
    }


def b2_work(num_vertices: int, num_faces: int) -> dict:
    """{"operations", "bytes"} of one B2 call: vertices f32[V, 3], triangles
    int32[F, 3] and the 3x3 intrinsics read; face vertices f32[F, 3, 3] and
    the valid flag (1 B) written."""
    return {
        "operations": num_faces * 3 * EXPAND_OPS_PER_CORNER,
        "bytes": num_vertices * 12 + num_faces * 12 + 36 + num_faces * (36 + 1),
    }


def bound_seconds(work: dict) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    operations at the FP32 peak, whichever is longer."""
    return max(work["bytes"] / PEAK_HBM_BYTES_PER_S, work["operations"] / PEAK_FP32_FLOPS)
