"""Block-sparse arrowhead (Schur-complement) Cholesky solver.

Port of ``dynamicfuion_python_tpu/ops/linalg/arrowhead.py``. After the
hierarchical warp field's fine-to-coarse "virtual ordering" the Gauss-Newton
Hessian has arrowhead structure

    H = [ D   B  ]     D: block-diagonal (6x6) over the finest-layer nodes,
        [ B^T C  ]     B: sparse stem->corner wing, C: dense corner.

Algorithm: invert D blockwise, W = D^-1 B, Schur complement S = C - B^T W,
dense Cholesky solve of S, back-substitution. The wing is stored padded
row-wise (``wing_blocks`` [N0, K, 6, 6], ``wing_cols`` [N0, K], -1 = empty).
The one-hot contractions the TPU version uses for its scatters are
``ops/segment_sum.py`` sums here (``index_add_`` on the CPU, a
fixed-order one-hot product on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.ops.linalg.block_ops import (
    cholesky_solve,
    _lower_mask,
    invert_spd_blocks,
)
from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum
from dynamicfuion_python_tpu_torch.utils import trace

#: escalation steps of the corner damping (first try is undamped)
_MAX_ESCALATIONS = 4


class BlockSparseArrowheadMatrix(NamedTuple):
    """Arrowhead system in padded block-row layout.

    diag_blocks f32[N0, B, B]; wing_blocks f32[N0, K, B, B] (slot k of row i
    couples stem node i with corner node ``wing_cols[i, k]``); wing_cols
    int[N0, K] (-1 = empty); corner f32[Nc*B, Nc*B].
    """

    diag_blocks: torch.Tensor
    wing_blocks: torch.Tensor
    wing_cols: torch.Tensor
    corner: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.diag_blocks.shape[-1]

    @property
    def num_stem_blocks(self) -> int:
        return self.diag_blocks.shape[0]

    @property
    def num_corner_blocks(self) -> int:
        return self.corner.shape[0] // self.block_size


def _mask_wing(matrix: BlockSparseArrowheadMatrix) -> torch.Tensor:
    valid = (matrix.wing_cols >= 0).to(matrix.wing_blocks.dtype)
    return matrix.wing_blocks * valid[..., None, None]


def arrowhead_to_dense(matrix: BlockSparseArrowheadMatrix) -> torch.Tensor:
    """The full dense [(N0+Nc)*B]^2 matrix (tests / small systems)."""
    b = matrix.block_size
    n0 = matrix.num_stem_blocks
    nc = matrix.num_corner_blocks
    n = (n0 + nc) * b
    dense = torch.zeros((n, n), dtype=matrix.diag_blocks.dtype, device=matrix.corner.device)
    for i in range(n0):
        dense[i * b : (i + 1) * b, i * b : (i + 1) * b] = matrix.diag_blocks[i]
    wing = _mask_wing(matrix)
    cols = matrix.wing_cols.cpu()
    for i in range(n0):
        for k in range(wing.shape[1]):
            c = int(cols[i, k])
            if c < 0:
                continue
            r0, c0 = i * b, (n0 + c) * b
            dense[r0 : r0 + b, c0 : c0 + b] += wing[i, k]
            dense[c0 : c0 + b, r0 : r0 + b] += wing[i, k].T
    dense[n0 * b :, n0 * b :] += matrix.corner
    return dense


def _wing_t_times(
    wing: torch.Tensor, wing_cols: torch.Tensor, stem_vectors: torch.Tensor, nc: int
) -> torch.Tensor:
    """B^T v for stem block-vectors v [N0, B] -> [Nc, B]."""
    contrib = torch.einsum("nkba,nb->nka", wing, stem_vectors)
    flat = contrib.reshape(-1, contrib.shape[-1])
    # empty slots (-1) are dropped
    return segment_sum(flat, wing_cols.reshape(-1).long(), nc)


def _cholesky_with_escalating_damping(matrix: torch.Tensor):
    """Cholesky factor of ``matrix``, escalating diagonal damping mu through
    {1e-4, 1e-2, 1, 1e2} x mean|diag| while the factorization fails.

    Returns (factor, escalations, mu): escalations > 0 means the undamped
    factorization failed (the fitter's conditioning signal), and mu is the
    damping the factorized system carries. All candidates factor in one
    batched ``cholesky_ex``, so nothing waits for the device; when every
    candidate fails the factor is NaN, as in the JAX package.
    """
    eye = torch.eye(matrix.shape[0], dtype=matrix.dtype, device=matrix.device)
    scale = torch.mean(torch.abs(torch.diagonal(matrix))) + 1e-30
    mus = [torch.zeros_like(scale), 1e-4 * scale]
    for _ in range(_MAX_ESCALATIONS - 1):
        mus.append(mus[-1] * 100.0)
    mus = torch.stack(mus)
    candidates = matrix[None] + mus[:, None, None] * eye
    candidates = (candidates + candidates.mT) / 2
    factors, info = torch.linalg.cholesky_ex(candidates)
    ok = info == 0
    tries = torch.where(
        ok.any(), torch.argmax(ok.to(torch.int32)),
        trace.upload(_MAX_ESCALATIONS, ok.device, "arrowhead.escalations"),
    )
    # each index by the 0-d ``tries`` is a host read of it
    factor = torch.where(
        ok[trace.host_read(tries, "arrowhead.tries")] | ~_lower_mask(matrix),
        factors[trace.host_read(tries, "arrowhead.tries")],
        torch.nan,
    )
    return factor, tries.to(torch.int32), mus[trace.host_read(tries, "arrowhead.tries")]


def arrowhead_matvec(matrix: BlockSparseArrowheadMatrix, x: torch.Tensor) -> torch.Tensor:
    """H @ x for the arrowhead system."""
    b = matrix.block_size
    n0 = matrix.num_stem_blocks
    nc = matrix.num_corner_blocks
    wing = _mask_wing(matrix)
    xs = x[: n0 * b].reshape(n0, b)
    xc = x[n0 * b :]
    ys = torch.einsum("nab,nb->na", matrix.diag_blocks, xs)
    gathered = xc.reshape(nc, b)[matrix.wing_cols.clamp(min=0).long()]
    gathered = torch.where((matrix.wing_cols >= 0)[..., None], gathered, 0.0)
    ys = ys + torch.einsum("nkab,nkb->na", wing, gathered)
    yc = matrix.corner @ xc + _wing_t_times(wing, matrix.wing_cols, xs, nc).reshape(-1)
    return torch.cat([ys.reshape(-1), yc])


def solve_block_sparse_arrowhead(
    matrix: BlockSparseArrowheadMatrix, rhs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve H x = rhs for the arrowhead system.

    Returns ``(x, escalations, mu)``: a non-zero escalation count means the
    Schur complement only factorized with extra corner damping ``mu``, so
    callers can check the solve against ``H + mu * I_corner``.
    """
    b = matrix.block_size
    n0 = matrix.num_stem_blocks
    nc = matrix.num_corner_blocks
    wing = _mask_wing(matrix)
    cols = matrix.wing_cols

    rhs_stem = rhs[: n0 * b].reshape(n0, b)
    rhs_corner = rhs[n0 * b :]

    # 1. D^-1 blockwise
    diag_inv = invert_spd_blocks(matrix.diag_blocks)
    dinv_rhs = torch.einsum("nab,nb->na", diag_inv, rhs_stem)
    # 2. W = D^-1 B per wing slot
    w = torch.einsum("nab,nkbc->nkac", diag_inv, wing)
    # 3. S = C - B^T W over the wing-slot pairs of each stem row
    pair = torch.einsum("nkab,nlac->nklbc", wing, w)
    kk = wing.shape[1]
    j1 = cols[:, :, None].expand(n0, kk, kk)
    j2 = cols[:, None, :].expand(n0, kk, kk)
    pair_valid = (j1 >= 0) & (j2 >= 0)
    flat_pair = torch.where(pair_valid[..., None, None], pair, 0.0).reshape(-1, b * b)
    flat_idx = torch.where(
        pair_valid, j1.clamp(min=0) * nc + j2.clamp(min=0), nc * nc
    ).reshape(-1).long()
    schur_blocks = segment_sum(flat_pair, flat_idx, nc * nc).reshape(nc, nc, b, b)
    schur = matrix.corner - schur_blocks.permute(0, 2, 1, 3).reshape(nc * b, nc * b)

    # 4. corner solve S x_c = b_c - B^T D^-1 b_s
    corner_rhs = rhs_corner - _wing_t_times(wing, cols, dinv_rhs, nc).reshape(-1)
    schur_factor, escalations, mu = _cholesky_with_escalating_damping(schur)
    x_corner = cholesky_solve(schur_factor, corner_rhs[:, None])[:, 0]

    # 5. back-substitute x_s = D^-1 b_s - W x_c
    gathered = x_corner.reshape(nc, b)[cols.clamp(min=0).long()]
    gathered = torch.where((cols >= 0)[..., None], gathered, 0.0)
    x_stem = dinv_rhs - torch.einsum("nkab,nkb->na", w, gathered)
    return torch.cat([x_stem.reshape(-1), x_corner]), escalations, mu
