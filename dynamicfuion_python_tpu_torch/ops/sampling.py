"""Grid-based point downsampling with static-shape outputs (port of
``dynamicfuion_python_tpu/ops/sampling.py``).

Mean-grid downsampling (the average of the points of each occupied grid
cell), "median"-grid subsampling (the index of the point closest to its
cell's mean, the hierarchy's node-decimation primitive) and their two-pass
radius variants. Occupied cells are found by a stable sort of the cell ids
and head flags; per-cell sums are ``ops/segment_sum.py`` sums and per-cell minima
``scatter_reduce``. Outputs keep the JAX contract: padded to the input size
(``PAD_VALUE`` for points, -1 for indices) plus a valid count, cells in
ascending cell-id order.

The card and the CPU give the same counts and indices: the cell size
divides as a tensor (CUDA turns a division by a Python scalar into a
multiplication by its reciprocal, which floors differently at cell
borders), the per-cell sums accumulate in f64 (the card adds in another
order than the CPU), and squared distances are separate multiplies and
adds.
"""

from __future__ import annotations

import math

import torch

from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum

#: padding value of unused output slots
PAD_VALUE = float("nan")

#: sentinel cell id sorting masked-out points into one trailing segment
_INVALID_ID = torch.iinfo(torch.int32).max


def _cell_ids(points, cell_size: float, offset: float = 0.0, valid=None, origin=None) -> torch.Tensor:
    """Flat int32 grid-cell ids (collision-free within the extent).

    ``offset`` shifts the grid by that fraction of a cell on every axis;
    ``origin`` pins the grid origin (the radius variants pass the first
    pass's origin so the second grid is exactly the first shifted by half a
    cell). Points where ``valid`` is False all map to one sentinel id that
    sorts after every real cell. The quantization is floor((p - min) / size
    + offset) with a true division, in that order, as in the JAX package.
    """
    if origin is not None:
        mins = origin
    elif valid is None:
        mins = torch.amin(points, dim=0)
    else:
        mins = torch.amin(torch.where(valid[:, None], points, torch.inf), dim=0)
    size = torch.full((), cell_size, dtype=points.dtype, device=points.device)
    cells = torch.floor((points - mins) / size + offset).to(torch.int32)
    cells = torch.clamp(cells, min=0)
    if valid is not None:
        cells = torch.where(valid[:, None], cells, 0)
    extent = torch.amax(cells, dim=0) + 1
    ids = (cells[:, 0] * extent[1] + cells[:, 1]) * extent[2] + cells[:, 2]
    if valid is not None:
        ids = torch.where(valid, ids, _INVALID_ID)
    return ids


def _segment_layout(ids: torch.Tensor):
    """Stable sort of the ids -> (order, segment of each sorted element,
    segment count)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    heads = torch.ones_like(sorted_ids, dtype=torch.int32)
    heads[1:] = (sorted_ids[1:] != sorted_ids[:-1]).to(torch.int32)
    seg = torch.cumsum(heads, 0) - 1
    return order, seg, (seg[-1] + 1).to(torch.int32)


def _segment_means(sorted_points, seg, n: int) -> torch.Tensor:
    sums = segment_sum(sorted_points.double(), seg, n)
    nums = segment_sum(torch.ones((seg.shape[0],), dtype=torch.float64, device=sorted_points.device), seg, n)
    return (sums / torch.clamp(nums, min=1.0)[:, None]).to(sorted_points.dtype)


def mean_grid_downsample(points, cell_size: float, offset: float = 0.0, valid=None, origin=None):
    """Average points per occupied cell -> (f32[N, 3] padded with NaN beyond
    ``count``, count int32). ``valid`` masks input slots out entirely (for
    chaining over padded outputs)."""
    n = points.shape[0]
    if valid is not None:
        points = torch.where(valid[:, None], points, 0.0)
    order, seg, count = _segment_layout(_cell_ids(points, cell_size, offset, valid, origin))
    means = _segment_means(points[order], seg, n)
    if valid is not None:
        # masked slots share one sentinel segment that sorts last: drop it
        count = count - torch.any(~valid).to(count.dtype)
    ok = torch.arange(n, device=points.device) < count
    return torch.where(ok[:, None], means, PAD_VALUE), count


def median_grid_subsample(points, cell_size: float, offset: float = 0.0, valid=None, origin=None):
    """Per occupied cell, the index of the input point closest to the cell
    mean -> (int32[N] padded with -1, count). Of equally close points the
    first in sorted (stable) order wins."""
    n = points.shape[0]
    dev = points.device
    if valid is not None:
        points = torch.where(valid[:, None], points, 0.0)
    order, seg, count = _segment_layout(_cell_ids(points, cell_size, offset, valid, origin))
    if valid is not None:
        count = count - torch.any(~valid).to(count.dtype)
    sorted_points = points[order]
    means = _segment_means(sorted_points, seg, n)
    d = sorted_points - means[seg]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    seg64 = seg.long()
    best = torch.full((n,), torch.inf, dtype=d2.dtype, device=dev).scatter_reduce(0, seg64, d2, "amin")
    pos = torch.arange(n, device=dev)
    is_best = d2 <= best[seg64] + 0.0
    first_best = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg64, torch.where(is_best, pos, n), "amin"
    )
    indices = torch.where(pos < count, order[torch.clamp(first_best, max=n - 1)], -1)
    return indices.to(torch.int32), count


def _radius_cell(radius: float) -> float:
    """Two-pass grid cell size for a separation radius: 2 sqrt(2 r^2)."""
    return 2.0 * math.sqrt(2.0) * radius


def fast_mean_radius_downsample(points, radius: float):
    """Average-downsample so results are about ``radius`` apart: two
    mean-grid passes at cell size 2 sqrt(2) radius, the second offset by half
    a cell on the first pass's origin -> (f32[N, 3] NaN-padded, count)."""
    n = points.shape[0]
    origin = torch.amin(points, dim=0)
    stage1, count1 = mean_grid_downsample(points, _radius_cell(radius), origin=origin)
    valid1 = torch.arange(n, device=points.device) < count1
    return mean_grid_downsample(
        torch.where(valid1[:, None], stage1, 0.0), _radius_cell(radius), offset=0.5, valid=valid1, origin=origin
    )


def fast_median_radius_subsample(points, radius: float):
    """Index-returning variant of :func:`fast_mean_radius_downsample`: each
    sample is an input point (closest to its cell's mean, both passes) ->
    (int32[N] indices into ``points`` padded with -1, count)."""
    n = points.shape[0]
    origin = torch.amin(points, dim=0)
    idx1, count1 = median_grid_subsample(points, _radius_cell(radius), origin=origin)
    valid1 = torch.arange(n, device=points.device) < count1
    stage1 = torch.where(valid1[:, None], points[torch.clamp(idx1, min=0).long()], 0.0)
    idx2, count2 = median_grid_subsample(stage1, _radius_cell(radius), offset=0.5, valid=valid1, origin=origin)
    final = torch.where(idx2 >= 0, idx1[torch.clamp(idx2, min=0).long()], -1)
    return final.to(torch.int32), count2
