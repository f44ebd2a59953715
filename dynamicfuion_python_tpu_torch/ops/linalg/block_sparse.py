"""General block-COO sparse linear algebra (port of
``dynamicfuion_python_tpu/ops/linalg/block_sparse.py``).

Matrices are a list of dense ``b x b`` blocks plus int block coordinates
(block-row, block-col), -1 marking an inactive entry. Sums over blocks are
``ops/segment_sum.py`` sums with the dropped entries in segment
``num_segments`` (the JAX package's ``segment_sum`` over
``num_segments + 1``); a block-sparse x block-sparse
product takes its output coordinate list explicitly (the reference's
"breadboard" structure). The fitter's arrowhead solver
(``ops/linalg/arrowhead.py``) stays the production path; these ops cover the
rest of the reference's block-sparse suite.
"""

from __future__ import annotations

import torch

from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum


def _active(coords: torch.Tensor) -> torch.Tensor:
    return (coords[:, 0] >= 0) & (coords[:, 1] >= 0)


def block_sparse_to_dense(blocks: torch.Tensor, coords: torch.Tensor, shape_blocks: tuple[int, int]) -> torch.Tensor:
    """COO-of-blocks f32[Nb, b, b] + int[Nb, 2] -> dense [rows * b, cols * b]
    (inactive entries ignored)."""
    rows, cols = shape_blocks
    b = blocks.shape[1]
    ok = _active(coords)
    seg = torch.where(ok, coords[:, 0].long() * cols + coords[:, 1].long(), rows * cols)
    out = segment_sum(torch.where(ok[:, None, None], blocks, 0.0), seg, rows * cols)
    return out.reshape(rows, cols, b, b).permute(0, 2, 1, 3).reshape(rows * b, cols * b)


def block_sums(blocks: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum blocks by id (-1 drops the block) -> [num_segments, b, b]."""
    ok = segment_ids >= 0
    seg = torch.where(ok, segment_ids, num_segments)
    return segment_sum(torch.where(ok[:, None, None], blocks, 0.0), seg, num_segments)


def get_diagonal_blocks(blocks: torch.Tensor, coords: torch.Tensor, num_diag: int) -> torch.Tensor:
    """The diagonal blocks, summed per block row, as dense [num_diag, b, b]."""
    on_diag = (coords[:, 0] == coords[:, 1]) & (coords[:, 0] >= 0)
    seg = torch.where(on_diag, coords[:, 0], num_diag)
    return segment_sum(torch.where(on_diag[:, None, None], blocks, 0.0), seg, num_diag)


def transpose_blocks(blocks: torch.Tensor, coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A^T in block-COO: each block transposed, coordinates swapped."""
    return blocks.transpose(-1, -2), coords.flip(1)


def zero_out_triangular_blocks(blocks: torch.Tensor, coords: torch.Tensor, upper: bool) -> torch.Tensor:
    """Zero the blocks strictly above (``upper``) or below the block diagonal."""
    keep = coords[:, 1] <= coords[:, 0] if upper else coords[:, 1] >= coords[:, 0]
    return torch.where(keep[:, None, None], blocks, 0.0)


def precondition_diagonal_blocks(diag_blocks: torch.Tensor, dampening_factor: float) -> torch.Tensor:
    """Add the LM dampening factor to every block's diagonal entries."""
    b = diag_blocks.shape[-1]
    return diag_blocks + dampening_factor * torch.eye(b, dtype=diag_blocks.dtype, device=diag_blocks.device)


def kronecker_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense Kronecker product [m * p, n * q]."""
    m, n = a.shape
    p, q = b.shape
    return (a[:, None, :, None] * b[None, :, None, :]).reshape(m * p, n * q)


def matmul_block_sparse_dense(
    blocks: torch.Tensor, coords: torch.Tensor, dense: torch.Tensor, num_block_rows: int
) -> torch.Tensor:
    """A @ X for block-COO A and dense X [Ncols * b, m] (or a vector
    [Ncols * b]) -> [num_block_rows * b, m] (or a vector)."""
    vector = dense.ndim == 1
    b = blocks.shape[1]
    x = dense.reshape(-1, b, 1 if vector else dense.shape[-1])
    ok = _active(coords)
    safe = torch.where(ok[:, None], coords, 0).long()
    products = torch.einsum("nab,nbm->nam", blocks, x[safe[:, 1]])
    products = torch.where(ok[:, None, None], products, 0.0)
    seg = torch.where(ok, safe[:, 0], num_block_rows)
    out = segment_sum(products, seg, num_block_rows).reshape(num_block_rows * b, -1)
    return out[:, 0] if vector else out


def matmul_block_sparse(
    a_blocks: torch.Tensor,
    a_coords: torch.Tensor,
    b_blocks: torch.Tensor,
    b_coords: torch.Tensor,
    out_coords: torch.Tensor,
) -> torch.Tensor:
    """(A @ B) at the requested output blocks ``out_coords`` int[No, 2], all
    operands block-COO -> [No, b, b].

    Every (i, k) x (k, j) pair of blocks with a matching inner index is
    formed by a cross join of the two lists (O(Na * Nb), for graph-scale
    inputs), matched against the output list by a packed key
    row * 2^16 + col (block grids below 2^15 rows and columns), and summed
    into its output block; pairs whose output is not requested drop out.
    """
    na, nb, no = a_blocks.shape[0], b_blocks.shape[0], out_coords.shape[0]
    a_coords = a_coords.to(torch.int32)
    b_coords = b_coords.to(torch.int32)
    out_coords = out_coords.to(torch.int32)
    pair_ok = (a_coords[:, 1:2] == b_coords[None, :, 0]) & _active(a_coords)[:, None] & _active(b_coords)[None, :]
    key_pair = (a_coords[:, 0:1] * 65536 + b_coords[None, :, 1]).reshape(-1)
    key_out = out_coords[:, 0] * 65536 + out_coords[:, 1]
    sorted_keys, order = torch.sort(key_out, stable=True)
    pos = torch.clamp(torch.searchsorted(sorted_keys, key_pair), 0, no - 1)
    slot = order[pos]
    ok = pair_ok.reshape(-1) & (sorted_keys[pos] == key_pair)
    products = torch.einsum("pab,qbc->pqac", a_blocks, b_blocks).reshape(na * nb, a_blocks.shape[1], b_blocks.shape[2])
    seg = torch.where(ok, slot, no)
    return segment_sum(torch.where(ok[:, None, None], products, 0.0), seg, no)
