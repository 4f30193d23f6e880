"""Mixed-precision phases and absolute-residual stopping."""
import numpy as np
import jax.numpy as jnp

from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                            SimpleOptimizer, identity)
from admmsolver_tpu.parallel import BatchedSolver


def _template(A, y, alpha=0.1):
    N = A.shape[1]
    return Model([LeastSquares(1.0, A, y), L1Regularizer(alpha, N)],
                 [(1, 0, identity(N), identity(N))])


def _setup(B=6, M=30, N=80, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 6, replace=False)] = rng.randn(6)
    ys = xt @ A.T
    return A, ys, xt


def test_f32_phase_stays_f32():
    A, ys, _ = _setup()
    bs = BatchedSolver(_template(A, ys[0]), dtype=jnp.float64)
    r = bs.solve({(0, "y"): ys}, niter=50, dtype=jnp.float32)
    assert r.x[0].dtype == jnp.float32
    assert r.h[0].dtype == jnp.float32
    assert np.isfinite(np.asarray(r.x[0])).all()


def test_atol_stop():
    """atol stops on absolute primal+dual residual (engine extension)."""
    A, ys, _ = _setup()
    bs = BatchedSolver(_template(A, ys[0]), dtype=jnp.float64)
    r = bs.solve({(0, "y"): ys}, niter=5000, atol=1e-8)
    assert np.asarray(r.converged).all()
    for b in range(ys.shape[0]):
        hist = np.asarray(r.primal_residual[b])
        hist = hist[np.isfinite(hist)]
        assert hist[-1] < 1e-8


def test_mixed_matches_pure_f64():
    A, ys, xt = _setup()
    bs = BatchedSolver(_template(A, ys[0]), dtype=jnp.float64)
    rm = bs.solve_mixed({(0, "y"): ys}, niter_low=500, niter=4000,
                        atol=1e-10)
    rf = bs.solve({(0, "y"): ys}, niter=5000, atol=1e-10)
    assert np.asarray(rm.converged).all()
    np.testing.assert_allclose(np.asarray(rm.x[0]), np.asarray(rf.x[0]),
                               atol=1e-8)
    # history concatenation bookkeeping
    assert rm.primal_residual.shape[1] == 500 + 4000


def test_atol_single_instance():
    A, ys, _ = _setup(B=1)
    opt = SimpleOptimizer(_template(A, ys[0]))
    opt.solve(5000, atol=1e-9)
    assert opt._primal_residual[-1] < 1e-9
    assert len(opt._primal_residual) < 5000


def test_f32_single_phase_accuracy():
    """An f32 phase alone reaches ~1e-5 recovery quality."""
    A, ys, xt = _setup()
    bs = BatchedSolver(_template(A, ys[0]))
    r = bs.solve({(0, "y"): ys}, niter=2000, dtype=jnp.float32, rtol=1e-6)
    err = np.abs(np.asarray(r.x[0], dtype=np.float64) - xt).max()
    assert err < 5e-2, err


def test_mixed_sdp_preserves_psd_and_quality():
    """The mixed-precision SDP recipe (solve_mixed):
    the f32 phase must hand off through the eigh/Jacobi PSD prox without
    losing feasibility, and the polished solution must match pure f64
    fit quality.  Guards the psd_project fast path under both dtypes.
    """
    from admmsolver_tpu.models.applications import sdp_model

    k, rest, B = 4, 6, 5
    shape = (k, k, rest)
    N = k * k * rest
    M = N // 2
    rng = np.random.RandomState(7)
    A = rng.randn(M, N)
    xt = np.zeros(shape)
    for r_ in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r_] = Q @ Q.T / k
    y = A @ xt.reshape(-1)
    ys = y[None, :] + 1e-4 * rng.randn(B, M)
    bs = BatchedSolver(sdp_model(A, y, shape, axis=2), dtype=jnp.float64)
    ov = {(0, "y"): jnp.asarray(ys)}
    rm = bs.solve_mixed(ov, niter_low=300, niter=100, rtol=0.0,
                        low_rtol=0.0, record_residuals=False)
    rf = bs.solve(ov, niter=400, rtol=0.0, record_residuals=False)
    for res in (rm, rf):
        X = np.asarray(res.x[1], np.float64).reshape(B, k, k, rest)
        assert np.isfinite(X).all()
        lam = np.linalg.eigvalsh(
            np.moveaxis(X, (1, 2), (-2, -1))).min()
        assert lam >= -1e-10, lam
    fit_m = np.median(np.abs(np.asarray(rm.x[0]) @ A.T - ys))
    fit_f = np.median(np.abs(np.asarray(rf.x[0]) @ A.T - ys))
    assert fit_m <= fit_f * 1.05 + 1e-12, (fit_m, fit_f)


def test_fused_mixed_matches_two_dispatch():
    """The one-jit mixed driver (fused=True) reproduces the two-dispatch
    phase loop exactly: same f32 phase, same promotion, same f64 polish."""
    A, ys, _ = _setup(seed=5)
    bs = BatchedSolver(_template(A, ys[0]), dtype=jnp.float64)
    kw = dict(niter_low=200, niter=300, rtol=1e-10, low_rtol=1e-5,
              mu0=0.5)
    two = bs.solve_mixed({(0, "y"): ys}, fused=False, **kw)
    one = bs.solve_mixed({(0, "y"): ys}, fused=True, **kw)
    np.testing.assert_array_equal(np.asarray(one.x[0]),
                                  np.asarray(two.x[0]))
    np.testing.assert_array_equal(np.asarray(one.mu), np.asarray(two.mu))
    np.testing.assert_array_equal(np.asarray(one.iterations),
                                  np.asarray(two.iterations))
    a, b = np.asarray(one.primal_residual), np.asarray(two.primal_residual)
    assert a.shape == b.shape
    both = np.isfinite(a) & np.isfinite(b)
    np.testing.assert_allclose(a[both], b[both], rtol=1e-6)
    assert (np.isfinite(a) == np.isfinite(b)).all()
