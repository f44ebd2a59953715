"""Static-size stream compaction (port of
``dynamicfuion_python_tpu/ops/compaction.py``)."""

from __future__ import annotations

import torch


def compact_mask_indices(
    mask: torch.Tensor, size: int, fill_value: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``size`` True entries of a 1-D ``mask``
    (ascending), padded with ``fill_value`` (default ``mask.numel()``).

    Returns (indices int64[size], count): count is the TOTAL number of True
    entries, as in the JAX package (callers cap it against ``size``). Each
    True entry is scattered to its rank, so the count never crosses to the
    host.
    """
    n = mask.shape[0]
    fill = n if fill_value is None else fill_value
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    # entries that are False or past ``size`` go to the dump slot ``size``
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out[dest] = torch.arange(n, device=mask.device)
    total = rank[-1] + 1 if n else torch.zeros((), dtype=torch.int64, device=mask.device)
    return out[:size], total
