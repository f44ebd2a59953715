"""Batched small-block linear algebra (6x6 per node).

Port of ``dynamicfuion_python_tpu/ops/linalg/block_ops.py``. A factorization
of a block that is not positive definite comes back as NaN, as
``jnp.linalg.cholesky`` returns it, instead of raising: callers test the
result for finiteness (the fitter's valid-solve guard).
"""

from __future__ import annotations

import torch


def matmul3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul [B,m,k] x [B,k,n] -> [B,m,n]."""
    return torch.bmm(a, b)


def factorize_blocks_cholesky(blocks: torch.Tensor) -> torch.Tensor:
    """Batched lower-Cholesky factors of SPD blocks [..., B, B]; NaN blocks
    where the factorization fails. The input is symmetrized first, as
    ``jnp.linalg.cholesky`` does, so round-off asymmetry factors the same."""
    blocks = (blocks + blocks.mT) / 2
    factor, info = torch.linalg.cholesky_ex(blocks)
    return torch.where((info != 0)[..., None, None] & _lower_mask(blocks), torch.nan, factor)


def _lower_mask(blocks: torch.Tensor) -> torch.Tensor:
    """Lower triangle incl. the diagonal: where a failed factor is NaN."""
    n = blocks.shape[-1]
    return torch.ones((n, n), dtype=torch.bool, device=blocks.device).tril()


def cholesky_solve(factors: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs given batched lower-Cholesky ``factors`` of A.

    ``factors``: [..., B, B] lower-triangular; ``rhs``: [..., B, K].
    """
    y = torch.linalg.solve_triangular(factors, rhs, upper=False)
    return torch.linalg.solve_triangular(factors.mT, y, upper=True)


def invert_spd_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD blocks [..., B, B] via Cholesky."""
    n = blocks.shape[-1]
    factors = factorize_blocks_cholesky(blocks)
    eye = torch.eye(n, dtype=blocks.dtype, device=blocks.device).expand(blocks.shape)
    return cholesky_solve(factors, eye)


def solve_block_diagonal_cholesky(
    diag_blocks: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve a block-diagonal SPD system: ``diag_blocks`` [N, B, B], ``rhs``
    [N, B] -> [N, B]."""
    factors = factorize_blocks_cholesky(diag_blocks)
    return cholesky_solve(factors, rhs[..., None])[..., 0]


def solve_block_diagonal_qr(
    diag_blocks: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve a block-diagonal system by batched QR (for blocks that are not
    SPD): ``diag_blocks`` [N, B, B], ``rhs`` [N, B] -> [N, B]."""
    q, r = torch.linalg.qr(diag_blocks)
    qtb = torch.einsum("nba,nb->na", q, rhs)
    return torch.linalg.solve_triangular(r, qtb[..., None], upper=True)[..., 0]
