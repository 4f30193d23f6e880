"""Determinism checks (SURVEY.md §5: the accelerator analogue of race
detection —
same inputs must give bitwise-identical results across runs)."""
import numpy as np

from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                            SimpleOptimizer, identity)
from admmsolver_tpu.parallel import BatchedSolver


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    M, N = 16, 40
    A = rng.randn(M, N)
    y = rng.randn(M)
    return Model([LeastSquares(1.0, A, y), L1Regularizer(0.1, N)],
                 [(1, 0, identity(N), identity(N))])


def test_single_instance_bitwise_repeatable():
    m = _problem()
    o1 = SimpleOptimizer(m)
    o1.solve(200)
    o2 = SimpleOptimizer(m)
    o2.solve(200)
    np.testing.assert_array_equal(np.asarray(o1.x[0]), np.asarray(o2.x[0]))
    np.testing.assert_array_equal(o1._primal_residual, o2._primal_residual)


def test_batched_bitwise_repeatable():
    m = _problem(1)
    rng = np.random.RandomState(2)
    ys = rng.randn(4, 16)
    bs = BatchedSolver(m)
    r1 = bs.solve({(0, "y"): ys}, niter=200)
    r2 = bs.solve({(0, "y"): ys}, niter=200)
    np.testing.assert_array_equal(np.asarray(r1.x[0]), np.asarray(r2.x[0]))
    np.testing.assert_array_equal(np.asarray(r1.mu), np.asarray(r2.mu))


def test_batched_lane_order_independent():
    """Permuting lanes permutes results (no cross-lane leakage; up to
    position-dependent GEMM-tiling roundoff ~1e-15)."""
    m = _problem(3)
    rng = np.random.RandomState(4)
    ys = rng.randn(6, 16)
    perm = np.array([3, 1, 5, 0, 4, 2])
    bs = BatchedSolver(m)
    r1 = bs.solve({(0, "y"): ys}, niter=150)
    r2 = bs.solve({(0, "y"): ys[perm]}, niter=150)
    np.testing.assert_allclose(np.asarray(r1.x[0])[perm],
                               np.asarray(r2.x[0]), atol=1e-12)
