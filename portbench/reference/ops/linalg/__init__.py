"""Linear algebra: Rodrigues, batched 6x6 block Cholesky, the general
block-COO sparse suite, and the block-sparse arrowhead (Schur-complement)
solver."""

from portbench.reference.ops.linalg.arrowhead import (
    BlockSparseArrowheadMatrix,
    arrowhead_matvec,
    arrowhead_to_dense,
    solve_block_sparse_arrowhead,
)
from portbench.reference.ops.linalg.block_ops import (
    cholesky_solve,
    factorize_blocks_cholesky,
    invert_spd_blocks,
    matmul3d,
    solve_block_diagonal_cholesky,
    solve_block_diagonal_qr,
)
from portbench.reference.ops.linalg.block_sparse import (
    block_sparse_to_dense,
    block_sums,
    get_diagonal_blocks,
    kronecker_product,
    matmul_block_sparse,
    matmul_block_sparse_dense,
    precondition_diagonal_blocks,
    transpose_blocks,
    zero_out_triangular_blocks,
)
from portbench.reference.ops.linalg.rodrigues import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    skew,
)

__all__ = [
    "BlockSparseArrowheadMatrix",
    "arrowhead_matvec",
    "arrowhead_to_dense",
    "axis_angle_to_matrix",
    "block_sparse_to_dense",
    "block_sums",
    "cholesky_solve",
    "factorize_blocks_cholesky",
    "get_diagonal_blocks",
    "invert_spd_blocks",
    "kronecker_product",
    "matmul3d",
    "matmul_block_sparse",
    "matmul_block_sparse_dense",
    "matrix_to_axis_angle",
    "precondition_diagonal_blocks",
    "skew",
    "solve_block_diagonal_cholesky",
    "solve_block_diagonal_qr",
    "solve_block_sparse_arrowhead",
    "transpose_blocks",
    "zero_out_triangular_blocks",
]
