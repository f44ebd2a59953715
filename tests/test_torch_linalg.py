"""PyTorch port vs JAX package: Rodrigues, 6x6 block ops and the arrowhead
(Schur-complement) solver, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfuion_python_tpu.ops import linalg as J
from dynamicfuion_python_tpu_torch.ops import linalg as P


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrowhead_system(rng, n0, nc, b=6, k=4, corner_shift=8.0):
    """The bench.py arrowhead system generator (SPD by construction)."""
    diag = rng.normal(size=(n0, b, b)).astype(np.float32)
    diag = diag @ diag.transpose(0, 2, 1) + 8 * np.eye(b, dtype=np.float32)
    wing = 0.3 * rng.normal(size=(n0, k, b, b)).astype(np.float32)
    cols = np.full((n0, k), -1, np.int32)
    for i in range(n0):
        d = rng.integers(1, k + 1)
        cols[i, :d] = rng.choice(nc, size=d, replace=False)
    wing[cols < 0] = 0
    corner = rng.normal(size=(nc * b, nc * b)).astype(np.float32)
    corner = corner @ corner.T + corner_shift * n0 / nc * np.eye(nc * b, dtype=np.float32)
    rhs = rng.normal(size=((n0 + nc) * b,)).astype(np.float32)
    return diag, wing, cols, corner, rhs


def _solve_both(diag, wing, cols, corner, rhs):
    jm = J.BlockSparseArrowheadMatrix(*(jnp.asarray(a) for a in (diag, wing, cols, corner)))
    jx, jesc, jmu = J.solve_block_sparse_arrowhead(jm, jnp.asarray(rhs), return_diagnostics=True)
    pm = P.BlockSparseArrowheadMatrix(*(_t(a) for a in (diag, wing, cols, corner)))
    px, pesc, pmu = P.solve_block_sparse_arrowhead(pm, _t(rhs))
    return (np.asarray(jx), int(jesc), float(jmu)), (px.numpy(), int(pesc), float(pmu)), jm, pm


class TestRodrigues:
    def test_axis_angle_to_matrix(self, rng):
        v = rng.normal(size=(64, 3)).astype(np.float32)
        v[:4] *= 1e-8  # Taylor branch
        np.testing.assert_allclose(
            P.axis_angle_to_matrix(_t(v)).numpy(), np.asarray(J.axis_angle_to_matrix(jnp.asarray(v))), atol=2e-6
        )

    def test_matrix_to_axis_angle_and_skew(self, rng):
        v = (0.5 * rng.normal(size=(64, 3))).astype(np.float32)
        r = np.asarray(J.axis_angle_to_matrix(jnp.asarray(v)))
        np.testing.assert_allclose(
            P.matrix_to_axis_angle(_t(r)).numpy(), np.asarray(J.matrix_to_axis_angle(jnp.asarray(r))), atol=2e-6
        )
        np.testing.assert_array_equal(P.skew(_t(v)).numpy(), np.asarray(J.skew(jnp.asarray(v))))


class TestBlockOps:
    def test_matmul3d(self, rng):
        a = rng.normal(size=(20, 6, 6)).astype(np.float32)
        b = rng.normal(size=(20, 6, 6)).astype(np.float32)
        np.testing.assert_allclose(
            P.matmul3d(_t(a), _t(b)).numpy(), np.asarray(J.matmul3d(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5
        )

    def test_invert_and_solve_block_diagonal(self, rng):
        m = rng.normal(size=(20, 6, 6)).astype(np.float32)
        blocks = m @ m.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
        rhs = rng.normal(size=(20, 6)).astype(np.float32)
        np.testing.assert_allclose(
            P.invert_spd_blocks(_t(blocks)).numpy(), np.asarray(J.invert_spd_blocks(jnp.asarray(blocks))), atol=2e-4
        )
        np.testing.assert_allclose(
            P.solve_block_diagonal_cholesky(_t(blocks), _t(rhs)).numpy(),
            np.asarray(J.solve_block_diagonal_cholesky(jnp.asarray(blocks), jnp.asarray(rhs))),
            atol=2e-4,
        )
        np.testing.assert_allclose(
            P.solve_block_diagonal_qr(_t(blocks), _t(rhs)).numpy(),
            np.asarray(J.solve_block_diagonal_qr(jnp.asarray(blocks), jnp.asarray(rhs))),
            atol=2e-4,
        )

    def test_indefinite_block_factors_to_nan(self):
        # JAX's cholesky returns NaN on a non-SPD block; the port must too
        blocks = np.stack([np.eye(6), -np.eye(6)]).astype(np.float32)
        got = P.factorize_blocks_cholesky(_t(blocks)).numpy()
        want = np.asarray(J.factorize_blocks_cholesky(jnp.asarray(blocks)))
        np.testing.assert_array_equal(got, want)


class TestArrowhead:
    @pytest.mark.parametrize("n0,nc", [(30, 8), (208, 42)])  # 208+42 -> the 1500x1500 bench system
    def test_solve_matches_jax(self, rng, n0, nc):
        system = _arrowhead_system(rng, n0, nc)
        (jx, jesc, jmu), (px, pesc, pmu), jm, pm = _solve_both(*system)
        assert jesc == pesc == 0 and jmu == pmu == 0.0
        np.testing.assert_allclose(px, jx, rtol=5e-3, atol=5e-3)
        dense = np.asarray(J.arrowhead_to_dense(jm))
        np.testing.assert_allclose(P.arrowhead_to_dense(pm).numpy(), dense, atol=1e-6)
        np.testing.assert_allclose(
            P.arrowhead_matvec(pm, _t(jx)).numpy(), np.asarray(J.arrowhead_matvec(jm, jnp.asarray(jx))), rtol=1e-4, atol=1e-4
        )

    def test_forced_indefinite_corner_escalates_like_jax(self, rng):
        # a corner with a strongly negative eigenvalue: the undamped Schur
        # complement is indefinite, and damping escalates to the same step
        diag, wing, cols, corner, rhs = _arrowhead_system(rng, 30, 8)
        m = corner.shape[0]
        corner = corner - 1.5 * float(np.abs(np.diag(corner)).mean()) * np.eye(m, dtype=np.float32)
        (jx, jesc, jmu), (px, pesc, pmu), _, _ = _solve_both(diag, wing, cols, corner, rhs)
        assert jesc > 0
        assert pesc == jesc
        np.testing.assert_allclose(pmu, jmu, rtol=1e-5)
        assert np.isfinite(jx).all() == np.isfinite(px).all()
        if np.isfinite(jx).all():
            np.testing.assert_allclose(px, jx, rtol=5e-3, atol=5e-3)
