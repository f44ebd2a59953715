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
    entries, as in the JAX package (callers cap it against ``size``).
    """
    n = mask.shape[0]
    fill = n if fill_value is None else fill_value
    ids = torch.nonzero(mask).reshape(-1)[:size]
    total = torch.sum(mask.to(torch.int64))
    if ids.shape[0] < size:
        pad = torch.full((size - ids.shape[0],), fill, dtype=ids.dtype, device=ids.device)
        ids = torch.cat([ids, pad])
    return ids, total
