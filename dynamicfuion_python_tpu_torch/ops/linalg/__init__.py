"""Linear algebra: Rodrigues, batched 6x6 block Cholesky, and the
block-sparse arrowhead (Schur-complement) solver."""

from dynamicfuion_python_tpu_torch.ops.linalg.arrowhead import (
    BlockSparseArrowheadMatrix,
    arrowhead_matvec,
    arrowhead_to_dense,
    solve_block_sparse_arrowhead,
)
from dynamicfuion_python_tpu_torch.ops.linalg.block_ops import (
    cholesky_solve,
    factorize_blocks_cholesky,
    invert_spd_blocks,
    matmul3d,
    solve_block_diagonal_cholesky,
    solve_block_diagonal_qr,
)
from dynamicfuion_python_tpu_torch.ops.linalg.rodrigues import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    skew,
)

__all__ = [
    "BlockSparseArrowheadMatrix",
    "arrowhead_matvec",
    "arrowhead_to_dense",
    "axis_angle_to_matrix",
    "cholesky_solve",
    "factorize_blocks_cholesky",
    "invert_spd_blocks",
    "matmul3d",
    "matrix_to_axis_angle",
    "skew",
    "solve_block_diagonal_cholesky",
    "solve_block_diagonal_qr",
    "solve_block_sparse_arrowhead",
]
