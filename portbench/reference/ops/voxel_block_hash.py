"""Static-capacity voxel-block table primitives (port of
``dynamicfuion_python_tpu/ops/voxel_block_hash.py``).

Block keys are 3D integer block coordinates packed into one int32 (10 bits +
bias per axis); a sorted key index (keys + slot permutation, empty slots =
INT32_MAX) gives lookup by ``searchsorted``.
"""

from __future__ import annotations

import torch

EMPTY_KEY = 2**31 - 1
_BIAS = 512  # blocks per axis span [-512, 511]


def pack_block_keys(coords: torch.Tensor) -> torch.Tensor:
    """int32[..., 3] block coords -> packed int32[...] keys (lexicographic)."""
    c = (coords + _BIAS).to(torch.int32)
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def unpack_block_keys(keys: torch.Tensor) -> torch.Tensor:
    """Packed keys -> int32[..., 3] block coords (EMPTY_KEY-safe at caller)."""
    x = (keys >> 20) & 0x3FF
    y = (keys >> 10) & 0x3FF
    z = keys & 0x3FF
    return torch.stack([x, y, z], dim=-1) - _BIAS


def build_sorted_index(slot_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of per-slot keys -> (sorted_keys, slot_of_sorted)."""
    sorted_keys, order = torch.sort(slot_keys, stable=True)
    return sorted_keys, order.to(torch.int32)


def lookup(
    sorted_keys: torch.Tensor, slot_of_sorted: torch.Tensor, query_keys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Storage slots for packed query keys -> (slots int32[...], found
    bool[...]); the slot is arbitrary but valid where not found."""
    pos = torch.searchsorted(sorted_keys, query_keys.contiguous())
    pos = torch.clamp(pos, max=sorted_keys.shape[0] - 1)
    found = sorted_keys[pos] == query_keys
    return slot_of_sorted[pos], found


def unique_keys_padded(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate packed keys -> (unique keys ascending and compacted to the
    front, count). Same length as the input; EMPTY_KEY entries are dropped
    and the tail is EMPTY_KEY."""
    n = keys.shape[0]
    sorted_k = torch.sort(keys).values
    heads = torch.ones_like(sorted_k, dtype=torch.bool)
    heads[1:] = sorted_k[1:] != sorted_k[:-1]
    heads = heads & (sorted_k != EMPTY_KEY)
    dest = torch.cumsum(heads.to(torch.int64), 0) - 1
    out = torch.full((n + 1,), EMPTY_KEY, dtype=keys.dtype, device=keys.device)
    # non-head entries go to the dump slot n, which is sliced off
    out[torch.where(heads, dest, n)] = sorted_k
    return out[:n], torch.sum(heads)
