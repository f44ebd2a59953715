"""Spatial parallelism of the fusion workload over a process group (port of
``dynamicfuion_python_tpu/parallel/spmd.py`` onto ``torch.distributed``).

The JAX package shards arrays over a device mesh and lets GSPMD insert the
collectives. Here each rank is a process and every collective is explicit:

  - pixel rows of the observed frame split into one contiguous slab per
    rank (:func:`shard_pixel_rows`); each rank computes the data term's
    rows for its own pixels and adds them onto the sums of the ranks before
    it (:func:`chained_segment_sum`); the odometry's sums meet in one
    ``all_reduce`` (:func:`all_reduce_sum`);
  - the TSDF block table splits by slot (:func:`shard_blocks`) for
    integration; each rank sends its updated blocks to the others
    (:func:`broadcast_slices`);
  - small replicated state (warp field, pose, canonical mesh) is broadcast
    from rank 0 (:func:`replicate`), so that every rank holds the same bits
    even where a rank's own work differs from the others' (its slab's rows
    summed onto the chain at its place).

Only ``all_reduce`` and ``broadcast`` are used: the two collectives the gloo
backend offers on CUDA tensors (two ranks on one card) as NCCL does (a card
per rank). The backend and the device are the caller's choice
(``parallel/distributed.py::initialize``); nothing here picks one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def fusion_group(n_ranks: int | None = None):
    """The process group over the first ``n_ranks`` ranks (all by default):
    the counterpart of the JAX ``fusion_mesh``. Needs an initialized
    default group (``parallel/distributed.py::initialize``); every rank
    must call it."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call parallel.distributed.initialize first")
    world = dist.get_world_size()
    n = n_ranks or world
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} ranks but the world has {world}")
    return dist.group.WORLD if n == world else dist.new_group(list(range(n)))


def _split(count: int, parts: int, index: int) -> tuple[int, int]:
    return count * index // parts, count * (index + 1) // parts


def row_range(height: int, group) -> tuple[int, int]:
    """This rank's contiguous rows [r0, r1) of a ``height``-row image (the
    ranks' shares differ by at most one row)."""
    return _split(height, group_size(group), group_rank(group))


def shard_pixel_rows(image: torch.Tensor, group) -> torch.Tensor:
    """This rank's row slab of an [H, ...] image; H must divide evenly (as a
    JAX row sharding requires), so that every slab has the same height."""
    world = group_size(group)
    if image.shape[0] % world:
        raise ValueError(f"{image.shape[0]} rows do not split evenly over {world} ranks")
    r0, r1 = row_range(image.shape[0], group)
    return image[r0:r1]


def shard_blocks(count: int, group) -> tuple[int, int]:
    """This rank's contiguous range [start, stop) of ``count`` block-table
    entries: a slot range when ``count`` is the table's capacity, and a slot
    range too when the entries are an ascending list of slots (the frame
    loop's active blocks, which it splits so that each rank integrates the
    same number of blocks). The key index stays replicated."""
    return _split(count, group_size(group), group_rank(group))


def _global_rank(group, rank: int) -> int:
    return rank if group is None or group == dist.group.WORLD else dist.get_global_rank(group, rank)


def _flat(tensors, dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(buffer: torch.Tensor, like) -> list[torch.Tensor]:
    out, start = [], 0
    for t in like:
        out.append(buffer[start : start + t.numel()].reshape(t.shape).to(t.dtype))
        start += t.numel()
    return out


def all_reduce_sum(tensors, group) -> list[torch.Tensor]:
    """The elementwise sums over the ranks of ``tensors`` (all on one
    device), in one ``all_reduce``: packed into one buffer (f64 if any
    tensor is f64 or an integer, else f32) and cast back."""
    tensors = list(tensors)
    wide = any(t.dtype == torch.float64 or not t.dtype.is_floating_point for t in tensors)
    buffer = _flat(tensors, torch.float64 if wide else torch.float32)
    dist.all_reduce(buffer, op=dist.ReduceOp.SUM, group=group)
    return _unflat(buffer, tensors)


def replicate(tensors, group, src: int = 0) -> list[torch.Tensor]:
    """Rank ``src``'s values of ``tensors`` on every rank, in one
    ``broadcast`` of their bytes."""
    tensors = [t.contiguous() for t in tensors]
    buffer = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    dist.broadcast(buffer, src=_global_rank(group, src), group=group)
    out, start = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        # a copy starts at offset 0, as a view to a wider dtype needs
        out.append(buffer[start : start + n].clone().view(t.dtype).reshape(t.shape))
        start += n
    return out


def chained_segment_sum(rows: torch.Tensor, seg: torch.Tensor, num_segments: int, group) -> torch.Tensor:
    """``segment_sum(rows, seg, num_segments)`` over every rank's rows,
    added in rank order: each rank adds its rows onto the running sums of
    the ranks before it and ``broadcast``s them on; every rank returns the
    sums of all rows. Where the ranks hold consecutive parts of one
    process's rows (row slabs of a frame), the sums equal that process's
    bit for bit on the CPU, whose ``index_add_`` adds rows in index order.
    On the card each rank's part is one fixed-order sum added onto the
    chain, so the result repeats bit for bit from run to run but rounds
    differently from one process's single sum. Partial sums added at the
    end round differently too, and the fit grows that rounding frame by
    frame until other voxels are integrated."""
    acc = rows.new_zeros((num_segments, *rows.shape[1:]))
    for r in range(group_size(group)):
        if r == group_rank(group):
            acc = segment_sum(rows, seg, num_segments, acc=acc).contiguous()
        dist.broadcast(acc, src=_global_rank(group, r), group=group)
    return acc


def broadcast_slices(buffer: torch.Tensor, group) -> torch.Tensor:
    """Each rank's own share of ``buffer``'s rows (:func:`shard_blocks`
    over its length) sent to every other rank: after the call every rank
    holds every rank's rows. One ``broadcast`` per rank, of its rows only."""
    world = group_size(group)
    for r in range(world):
        start, stop = _split(buffer.shape[0], world, r)
        if stop > start:
            part = buffer[start:stop].contiguous()
            dist.broadcast(part, src=_global_rank(group, r), group=group)
            buffer[start:stop] = part
    return buffer


def replicate_field(field, group):
    """The warp field with rank 0's node rotations and translations."""
    rot, trans = replicate([field.node_rotations, field.node_translations], group)
    return field.replace(node_rotations=rot, node_translations=trans)


def fit_step_on_slabs(
    field, canonical_vertices, canonical_triangles, slab_points, slab_mask, intrinsics, config, mode, group, device,
):
    """One Gauss-Newton step (``models/fitter.py::gauss_newton_step`` with
    ``group``) on this rank's row slab of the observed frame, on ``device``
    (the card unless the caller passes ``device="cpu"``). Returns the
    fitter's ``StepResult``."""
    from dynamicfuion_python_tpu_torch.models import fitter
    from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals

    dev = resolve_device(device)
    field = field.to(dev)
    verts = torch.as_tensor(canonical_vertices, dtype=torch.float32, device=dev)
    tris = torch.as_tensor(canonical_triangles, device=dev).to(torch.int32).contiguous()
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev).contiguous()
    with torch.no_grad():
        pre = fitter.precompute_face_associations(field, verts, tris)
        return fitter.gauss_newton_step(
            field, verts, tris, mesh_vertex_normals(verts, tris), pre,
            torch.as_tensor(slab_points, dtype=torch.float32, device=dev),
            torch.as_tensor(slab_mask, device=dev).to(torch.bool), intr,
            config, mode, fitter._max_wing_degree(field), group=group,
        )


def distributed_fit_step(
    field, canonical_vertices, canonical_triangles, reference_points, reference_mask, intrinsics,
    config, mode, group, device=None,
):
    """One Gauss-Newton step with the frame's pixel rows split over
    ``group``: every rank takes the whole (replicated) frame, assembles the
    data term over its own row slab, and the normal equations are summed by
    an ``all_reduce``; the ARAP term, the solve and the update run on every
    rank, rank 0's update is broadcast. Runs on ``device`` (the card unless
    the caller passes ``device="cpu"``). Returns (field, data_loss,
    arap_loss, valid_solve)."""
    dev = resolve_device(device)
    out = fit_step_on_slabs(
        field, canonical_vertices, canonical_triangles,
        shard_pixel_rows(torch.as_tensor(reference_points), group),
        shard_pixel_rows(torch.as_tensor(reference_mask), group),
        intrinsics, config, mode, group, dev,
    )
    return out.field, out.data_loss, out.arap_loss, out.valid_solve
