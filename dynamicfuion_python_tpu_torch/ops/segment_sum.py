"""Segment sums that repeat bit for bit (the counterpart of
``jax.ops.segment_sum`` and of the JAX fitter's ``_segment_sum_mxu`` and
``_assemble_hg_onehot``).

``segment_sum(values [R, ...], seg int[R], num_segments, acc=None)`` returns
``[num_segments, ...]``, the sum of the rows of each segment. Rows whose
segment lies outside ``[0, num_segments)`` are dropped, and non-finite
values in them never reach a kept segment. ``acc`` adds the sums onto
running sums. The result is differentiable; its backward is a gather.

Every floating-point accumulation of the package goes through here:

- On a CPU tensor it is ``index_add_`` into one extra row that is cut off.
  That adds the rows in index order, so sums chained over ranks
  (``parallel/spmd.py``) equal one process's bit for bit.
- On a CUDA tensor it uses no floating-point atomics: the order of the
  additions is fixed by the shapes alone, so the same inputs give the same
  bits on every run. Up to ``ONEHOT_MAX_SEGMENTS`` segments it is a chunked
  one-hot product ``onehot(seg)^T @ values`` (:func:`segment_sum_onehot`,
  the JAX package's design; cuBLAS with TF32 off repeats bit for bit on one
  card and one stream). Above that it is a stable sort by segment, then
  sums of fixed-size pieces of each segment's rows, level by level
  (:func:`segment_sum_sorted`).

Both card forms are plain functions that also run on CPU tensors.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: the card sums up to this many segments as a one-hot product, more with
#: the sorted form (PERF.md: the product's work grows with the segment
#: count; the sorted form's is a sort and a few passes over the rows)
ONEHOT_MAX_SEGMENTS = 1024
#: rows per product of the one-hot form: one batch entry of a ``bmm``
_ONEHOT_ROWS = 1024
#: one-hot elements built at a time (128 MiB in f32)
_ONEHOT_ELEMENTS = 1 << 25
#: rows per piece of the sorted form
_PIECE = 32


def _kept(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (seg >= 0) & (seg < num_segments)


def _index_add_sum(values, seg, num_segments: int, acc=None) -> torch.Tensor:
    """``index_add_`` into ``num_segments + 1`` rows, the last one taking
    the dropped rows (the CPU's form: rows in index order)."""
    dest = torch.where(_kept(seg, num_segments), seg, num_segments)
    tail = values.new_zeros((1, *values.shape[1:]))
    out = values.new_zeros((num_segments + 1, *values.shape[1:])) if acc is None else torch.cat([acc, tail])
    out.index_add_(0, dest, values)
    return out[:num_segments]


@contextlib.contextmanager
def fp32_matmuls():
    """cuBLAS without TF32 inside the block, the caller's flag after it."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def segment_sum_onehot(values, seg, num_segments: int, acc=None) -> torch.Tensor:
    """Few segments, many rows: ``onehot(seg)^T @ values`` (TF32 off) as
    ``bmm`` over blocks of ``_ONEHOT_ROWS`` rows, the blocks' products then
    summed, a group of blocks at a time. Dropped rows are zeroed first: in a
    product NaN * 0 is NaN in every segment. A non-finite value in a kept
    row reaches every segment."""
    r, c = values.shape[0], math.prod(values.shape[1:])
    flat = values.reshape(r, c)
    keep = _kept(seg, num_segments)
    col = torch.where(keep, seg, 0).long()  # a dropped row's zeros land anywhere
    out = flat.new_zeros((num_segments, c)) if acc is None else acc.reshape(num_segments, c)
    group = max(1, _ONEHOT_ELEMENTS // (_ONEHOT_ROWS * max(num_segments, 1))) * _ONEHOT_ROWS
    with fp32_matmuls():
        for start in range(0, r, group):
            rows = torch.where(keep[start : start + group, None], flat[start : start + group], 0.0)
            cols = col[start : start + group]
            pad = -rows.shape[0] % _ONEHOT_ROWS
            if pad:
                rows = torch.cat([rows, rows.new_zeros((pad, c))])
                cols = torch.cat([cols, cols.new_zeros(pad)])
            blocks = rows.shape[0] // _ONEHOT_ROWS
            onehot = rows.new_zeros((blocks, _ONEHOT_ROWS, num_segments))
            onehot.scatter_(2, cols.reshape(blocks, _ONEHOT_ROWS, 1), 1.0)
            products = torch.bmm(onehot.transpose(1, 2), rows.reshape(blocks, _ONEHOT_ROWS, c))
            out = out + products.sum(dim=0)
    return out.reshape(num_segments, *values.shape[1:])


def _piece_sums(run, key, num_keys: int):
    """One level of the sorted form: the rows ``run`` [r, c], sorted by
    ``key`` (values in [0, num_keys)), summed in pieces of at most
    ``_PIECE`` consecutive rows of one key. Each row is copied to its own
    place in a zero-padded [p, _PIECE, c] layout (no two rows share one)
    and the layout summed over its middle axis; p = r // _PIECE + num_keys
    bounds the pieces from the shapes alone. Returns (piece sums [p, c],
    each piece's key [p] (sorted), each key's first piece and its piece
    count [num_keys])."""
    r, c = run.shape
    dev = run.device
    bounds = torch.searchsorted(key, torch.arange(num_keys + 1, device=dev))
    pieces = (bounds[1:] - bounds[:-1] + _PIECE - 1) // _PIECE
    ends = torch.cumsum(pieces, 0)
    first = ends - pieces
    offset = torch.arange(r, device=dev) - bounds[key]
    dest = (first[key] + offset // _PIECE) * _PIECE + offset % _PIECE
    p = r // _PIECE + num_keys
    sums = run.new_zeros((p * _PIECE, c)).index_copy_(0, dest, run).view(p, _PIECE, c).sum(dim=1)
    piece_key = torch.searchsorted(ends, torch.arange(p, device=dev), right=True).clamp(max=num_keys - 1)
    return sums, piece_key, first, pieces


def segment_sum_sorted(values, seg, num_segments: int, acc=None) -> torch.Tensor:
    """Many segments: the rows stably sorted by segment (dropped rows last,
    in a segment of their own), then summed in pieces of at most
    ``_PIECE`` rows of one segment, the pieces' sums again in pieces, and
    so on for ceil(log_PIECE R) levels, after which each segment has one
    piece left."""
    r, c = values.shape[0], math.prod(values.shape[1:])
    out = values.new_zeros((num_segments, c))
    if r:
        keys = num_segments + 1
        key, order = torch.sort(torch.where(_kept(seg, num_segments), seg.long(), num_segments), stable=True)
        run = values.reshape(r, c).index_select(0, order)
        levels = 1
        while _PIECE**levels < r:
            levels += 1
        for _ in range(levels):
            run, key, first, pieces = _piece_sums(run, key, keys)
        out = torch.where((pieces[:num_segments] > 0)[:, None], run[first[:num_segments]], 0.0)
    if acc is not None:
        out = acc.reshape(num_segments, c) + out
    return out.reshape(num_segments, *values.shape[1:])


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg, acc, num_segments, form):
        ctx.save_for_backward(seg)
        ctx.num_segments = num_segments
        ctx.has_acc = acc is not None
        return form(values, seg, num_segments, acc)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        n = ctx.num_segments
        rows = grad.index_select(0, seg.clamp(0, max(n - 1, 0)))
        rows = torch.where(_kept(seg, n).reshape(-1, *([1] * (grad.dim() - 1))), rows, 0.0)
        return rows, None, grad if ctx.has_acc else None, None, None


def segment_sum(values, seg, num_segments: int, acc=None) -> torch.Tensor:
    """Sum the rows of ``values`` [R, ...] by ``seg`` int[R] into
    ``num_segments`` rows (onto ``acc`` [num_segments, ...] if given);
    rows with a segment outside [0, num_segments) are dropped."""
    if not values.dtype.is_floating_point:
        return _index_add_sum(values, seg, num_segments, acc)  # integer sums are exact in any order
    if values.device.type == "cpu":
        form = _index_add_sum
    elif values.device.type == "cuda":
        form = segment_sum_onehot if num_segments <= ONEHOT_MAX_SEGMENTS else segment_sum_sorted
    else:
        raise RuntimeError(f"segment_sum: no form for device {values.device}")
    if torch.is_grad_enabled() and (values.requires_grad or (acc is not None and acc.requires_grad)):
        return _SegmentSum.apply(values, seg, acc, num_segments, form)
    return form(values, seg, num_segments, acc)
