"""Live parity tests against the reference implementation.

Imports SpM-lab/admmsolver from ``$ADMMSOLVER_REFERENCE_SRC`` (the ``ref``
fixture in ``conftest.py``; read-only, used purely as a numerical oracle;
skipped when unavailable) and checks that the engine reproduces its
solutions AND its residual trajectories on the anchor workloads
(SURVEY.md §4: reference-parity idiom)."""
import numpy as np
import pytest


def _run_ref(ref, A, y, alpha_l1, niter, mu0=None):
    lstsq = ref.obj.LeastSquares(1.0, A, y)
    l1 = ref.obj.L1Regularizer(alpha_l1, A.shape[1])
    p = ref.opt.Model(
        [lstsq, l1],
        [(1, 0, ref.mat.identity(A.shape[1]), ref.mat.identity(A.shape[1]))])
    o = ref.opt.SimpleOptimizer(p, mu=mu0)
    o.solve(niter)
    return o


def _run_ours(A, y, alpha_l1, niter, mu0=None):
    from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                                SimpleOptimizer, identity)

    p = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(alpha_l1, A.shape[1])],
        [(1, 0, identity(A.shape[1]), identity(A.shape[1]))])
    o = SimpleOptimizer(p, mu=mu0)
    o.solve(niter)
    return o


def test_lasso_trajectory_parity(ref):
    y = np.array([2.0])
    A = np.array([[2.0, 1.0]])
    r = _run_ref(ref, A, y, 0.1, 100)
    t = _run_ours(A, y, 0.1, 100)
    assert len(r._primal_residual) == len(t._primal_residual)
    np.testing.assert_allclose(t._primal_residual, r._primal_residual,
                               rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(t._dual_residual, r._dual_residual,
                               rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(np.asarray(t.x[0]), r.x[0], atol=1e-12)


def test_basis_pursuit_parity(ref):
    N, M, K = 300, 40, 10
    rng = np.random.RandomState(1234)
    A = rng.randn(M, N)
    xa = np.zeros(N)
    xa[:K] = rng.randn(K)
    xa = rng.permutation(xa)
    y = A @ xa
    r = _run_ref(ref, A, y, 0.1, 100)
    t = _run_ours(A, y, 0.1, 100)
    assert len(r._primal_residual) == len(t._primal_residual)
    np.testing.assert_allclose(np.asarray(t.x[0]), r.x[0], atol=1e-8)
    np.testing.assert_allclose(t._primal_residual, r._primal_residual,
                               rtol=1e-5, atol=1e-12)


def test_ridge_parity(ref):
    rng = np.random.RandomState(100)
    rc = lambda *s: rng.randn(*s) + 1j * rng.randn(*s)
    y = rc(2)
    A = rc(2, 2)
    B = rc(1, 2)

    rp = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y), ref.obj.L2Regularizer(1.0, B)],
        [(1, 0, ref.mat.identity(2), ref.mat.identity(2))])
    ro = ref.opt.SimpleOptimizer(rp)
    ro.solve(100)

    from admmsolver_tpu import (L2Regularizer, LeastSquares, Model,
                                SimpleOptimizer, identity)

    tp = Model([LeastSquares(1.0, A, y), L2Regularizer(1.0, B)],
               [(1, 0, identity(2), identity(2))])
    to = SimpleOptimizer(tp)
    to.solve(100)
    np.testing.assert_allclose(np.asarray(to.x[0]), ro.x[0], atol=1e-10)
    assert len(to._primal_residual) == len(ro._primal_residual)


def test_three_block_parity(ref):
    """LS + L1 + NonNegative with adaptive penalties: trajectories and
    adapted mu values must match the reference."""
    rng = np.random.RandomState(5)
    M, N = 6, 4
    A = rng.randn(M, N)
    y = A @ np.abs(rng.randn(N)) + 0.01 * rng.randn(M)

    rp = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y), ref.obj.L1Regularizer(0.1, N),
         ref.obj.NonNegativePenalty(N)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N)),
         (2, 0, ref.mat.identity(N), ref.mat.identity(N))])
    ro = ref.opt.SimpleOptimizer(rp)
    ro.solve(500)

    from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                                NonNegativePenalty, SimpleOptimizer, identity)

    tp = Model([LeastSquares(1.0, A, y), L1Regularizer(0.1, N),
                NonNegativePenalty(N)],
               [(1, 0, identity(N), identity(N)),
                (2, 0, identity(N), identity(N))])
    to = SimpleOptimizer(tp)
    to.solve(500)

    assert len(to._primal_residual) == len(ro._primal_residual)
    np.testing.assert_allclose(np.asarray(to.x[0]), ro.x[0], atol=1e-8)
    np.testing.assert_allclose(np.asarray(to.x[2]), ro.x[2], atol=1e-8)
    # adapted penalties agree: reference stores mu in an (n,n) matrix at
    # (i,j), i>j (optimizer.py:154-160); ours is ordered by Model.pairs
    ref_mu = [ro._mu[i, j] for (i, j) in [(1, 0), (2, 0)]]
    np.testing.assert_allclose(np.asarray(to.mu), ref_mu, rtol=1e-12)


def test_mu0_override_parity(ref):
    y = np.array([2.0])
    A = np.array([[2.0, 1.0]])
    r = _run_ref(ref, A, y, 0.1, 60, mu0=0.25)
    t = _run_ours(A, y, 0.1, 60, mu0=0.25)
    np.testing.assert_allclose(np.asarray(t.x[0]), r.x[0], atol=1e-12)
    assert len(r._primal_residual) == len(t._primal_residual)


def test_spm_three_block_constrained_ls_parity(ref):
    """The reference's flagship SpM workload (spm.ipynb cells 10-11):
    ConstrainedLeastSquares (sum rule as hard equality) + L1 + NonNegative
    through the real-frequency projector, with adaptive mu — trajectory-
    level parity."""
    from admmsolver_tpu.models.applications import (spm_model,
                                                    synthetic_spm_data)

    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(nl=12, nw=25)
    nl, nw = s.size, prj_w.shape[0]

    rp = ref.opt.Model(
        [ref.obj.ConstrainedLeastSquares(
            1.0, ref.mat.DiagonalMatrix(-s), g,
            np.asarray(prj_sum).reshape(1, nl), np.array([1.0])),
         ref.obj.L1Regularizer(1e-3, nl),
         ref.obj.NonNegativePenalty(nw)],
        [(0, 1, ref.mat.identity(nl), ref.mat.identity(nl)),
         (0, 2, ref.mat.DenseMatrix(prj_w), ref.mat.identity(nw))])
    ro = ref.opt.SimpleOptimizer(rp, mu=0.1)
    ro.solve(400)

    tp = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    to = __import__("admmsolver_tpu").SimpleOptimizer(tp, mu=0.1)
    to.solve(400)

    assert len(to._primal_residual) == len(ro._primal_residual)
    np.testing.assert_allclose(to._primal_residual, ro._primal_residual,
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(to._dual_residual, ro._dual_residual,
                               rtol=1e-5, atol=1e-12)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(to.x[k]), ro.x[k].real,
                                   atol=1e-8)
        assert np.abs(np.asarray(ro.x[k]).imag).max() < 1e-14
    # adapted penalties agree (pairs (1,0) and (2,0) in reference storage)
    ref_mu = [ro._mu[i, j] for (i, j) in tp.pairs]
    np.testing.assert_allclose(np.asarray(to.mu), ref_mu, rtol=1e-12)
    # and the sum rule holds exactly, like the reference
    np.testing.assert_allclose(
        float(np.asarray(prj_sum) @ np.asarray(to.x[0])), 1.0, atol=1e-9)


def test_spd_penalty_parity(ref):
    """SemiPositiveDefinitePenalty engine path (batched eigh) vs the
    reference's per-slice eigh loop, with adaptive mu."""
    from admmsolver_tpu.models.applications import sdp_model

    rng = np.random.RandomState(42)
    shape, axis = (3, 4, 4), 0
    N = int(np.prod(shape))
    M = 24
    A = rng.randn(M, N)
    # target: PSD slices, so the fit has a meaningful PSD-feasible answer
    xt = np.zeros(shape)
    for i in range(shape[0]):
        Q = rng.randn(4, 4)
        xt[i] = Q @ Q.T
    y = A @ xt.ravel() + 0.01 * rng.randn(M)

    rp = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y),
         ref.obj.SemiPositiveDefinitePenalty(shape, axis)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N))])
    ro = ref.opt.SimpleOptimizer(rp)
    ro.solve(300)

    tp = sdp_model(A, y, shape, axis)
    to = __import__("admmsolver_tpu").SimpleOptimizer(tp)
    to.solve(300)

    assert len(to._primal_residual) == len(ro._primal_residual)
    np.testing.assert_allclose(to._primal_residual, ro._primal_residual,
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(to._dual_residual, ro._dual_residual,
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(np.asarray(to.x[0]), ro.x[0].real,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(to.x[1]), ro.x[1].real,
                               atol=1e-8)
    ref_mu = [ro._mu[i, j] for (i, j) in tp.pairs]
    np.testing.assert_allclose(np.asarray(to.mu), ref_mu, rtol=1e-12)
    # PSD property of the projected block
    xs = np.moveaxis(np.asarray(to.x[1]).reshape(shape), axis, 0)
    for sl in xs:
        assert np.linalg.eigvalsh(sl).min() >= -1e-10


def test_tv_denoise_builder_parity(ref):
    """tv_denoise_model composes reference-expressible blocks (LS data
    fit + L1 through a difference coupling): its trajectory must match
    the reference driving the same model (optimizer.py:302-341)."""
    from admmsolver_tpu import SimpleOptimizer
    from admmsolver_tpu.models.applications import tv_denoise_model

    rng = np.random.RandomState(31)
    n, lam, niter = 40, 0.3, 150
    y = np.r_[np.zeros(n // 2), np.ones(n - n // 2)] + 0.1 * rng.randn(n)

    t = SimpleOptimizer(tv_denoise_model(y, lam))
    t.solve(niter)

    D = np.zeros((n - 1, n))
    idx = np.arange(n - 1)
    D[idx, idx] = -1.0
    D[idx, idx + 1] = 1.0
    p = ref.opt.Model(
        [ref.obj.LeastSquares(0.5, np.eye(n), y),
         ref.obj.L1Regularizer(lam, n - 1)],
        [(0, 1, ref.mat.DenseMatrix(D), ref.mat.identity(n - 1))])
    r = ref.opt.SimpleOptimizer(p)
    r.solve(niter)

    assert len(r._primal_residual) == len(t._primal_residual)
    np.testing.assert_allclose(t._primal_residual, r._primal_residual,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(t._dual_residual, r._dual_residual,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(t.x[0]), r.x[0].real,
                               atol=1e-9)


def test_bounded_lsq_nonneg_special_case_parity(ref):
    """bounded_lsq_model with (lo=0, hi=inf) degenerates to the
    reference's LS + NonNegativePenalty model (objectivefunc.py:
    245-271): trajectories must coincide."""
    from admmsolver_tpu import SimpleOptimizer
    from admmsolver_tpu.models.applications import bounded_lsq_model

    rng = np.random.RandomState(32)
    M, N, niter = 12, 8, 150
    A = rng.randn(M, N)
    y = A @ np.abs(rng.randn(N)) + 0.05 * rng.randn(M)

    t = SimpleOptimizer(bounded_lsq_model(A, y, lo=0.0, hi=np.inf))
    t.solve(niter)

    p = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y),
         ref.obj.NonNegativePenalty(N)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N))])
    r = ref.opt.SimpleOptimizer(p)
    r.solve(niter)

    assert len(r._primal_residual) == len(t._primal_residual)
    np.testing.assert_allclose(t._primal_residual, r._primal_residual,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(t._dual_residual, r._dual_residual,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(t.x[0]), r.x[0].real,
                               atol=1e-10)
    assert np.asarray(t.x[1]).min() >= 0
