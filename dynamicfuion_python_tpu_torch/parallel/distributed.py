"""Multi-process entry points (port of
``dynamicfuion_python_tpu/parallel/distributed.py`` onto
``torch.distributed``).

Every process runs the same program. :func:`initialize` joins it into the
process group with an explicit rendezvous (``init_method``: a
``file://`` path shared by the ranks, or ``tcp://host:port``), world size,
rank and backend: ``"nccl"`` with a card per rank, ``"gloo"`` for ranks
sharing one card (CUDA tensors) or for the CPU. Each process feeds only the
pixel rows it owns (:func:`global_rows_from_local`) and the Gauss-Newton
step sums the ranks' normal equations (:func:`distributed_fit_step_global`).
:func:`run_ranks` spawns a world of processes on this host with a deadline.
"""

from __future__ import annotations

import datetime
import multiprocessing
import time

import torch
import torch.distributed as dist

from dynamicfuion_python_tpu_torch.parallel import spmd
from dynamicfuion_python_tpu_torch.utils.device import resolve_device

# torch threads per spawned rank: ranks share the host's cores
RANK_THREADS = 2


def initialize(
    init_method: str, world_size: int, rank: int, backend: str, device=None, timeout_s: float = 300.0
) -> torch.device:
    """Join this process into the process group and return its device:
    ``device`` (``"cpu"``, or a card; by default the card ``rank % cards``,
    and without a card this raises). Call once per process, before any
    collective."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


def global_rows_from_local(local_rows, group, device=None) -> torch.Tensor:
    """This rank's slab of a frame (rank r holds rows [r h, (r + 1) h)) on
    ``device``, checked against the other ranks' slabs: all must be h rows
    tall, as a JAX row-sharded global array requires."""
    dev = resolve_device(device)
    rows = torch.as_tensor(local_rows, device=dev)
    world, rank = spmd.group_size(group), spmd.group_rank(group)
    heights = torch.zeros(world, dtype=torch.float64, device=dev)
    heights[rank] = rows.shape[0]
    (heights,) = spmd.all_reduce_sum([heights], group)
    if not bool((heights == rows.shape[0]).all()):
        raise ValueError(f"the ranks' row slabs differ in height: {heights.tolist()}")
    return rows


def distributed_fit_step_global(
    field, canonical_vertices, canonical_triangles, local_reference_points, local_reference_mask, intrinsics,
    config, mode, group, device=None,
):
    """One Gauss-Newton step fed with this process's row slab of the
    observed frame (points and mask); the field, mesh and intrinsics are the
    same on every rank. On one process it is the single-process step bit for
    bit. Returns the fitter's ``StepResult``."""
    points = global_rows_from_local(local_reference_points, group, device)
    mask = global_rows_from_local(local_reference_mask, group, device)
    return spmd.fit_step_on_slabs(
        field, canonical_vertices, canonical_triangles, points, mask, intrinsics, config, mode, group, device
    )


def _rank_main(fn, rank: int, world_size: int, args: tuple) -> None:
    torch.set_num_threads(RANK_THREADS)
    try:
        fn(rank, world_size, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of ``RANK_THREADS`` torch threads each; ``fn`` must be
    importable by name. Raises if a rank fails, and kills every rank and
    raises ``TimeoutError`` once ``timeout_s`` has passed: a hung rank
    never stalls the caller."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, args)) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout_s} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed with exit codes {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
