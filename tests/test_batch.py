"""Batched-runtime tests: lane-exact equivalence with single-instance
solves, per-lane convergence masking, λ-path sweeps, and override
validation."""
import numpy as np
import jax.numpy as jnp
import pytest

from admmsolver_tpu import (
    L1Regularizer,
    LeastSquares,
    Model,
    NonNegativePenalty,
    SimpleOptimizer,
    identity,
)
from admmsolver_tpu.parallel import BatchedSolver


def _bp_template(A, y0, alpha0=0.1):
    N = A.shape[1]
    return Model([LeastSquares(1.0, A, y0), L1Regularizer(alpha0, N)],
                 [(1, 0, identity(N), identity(N))])


def test_batched_matches_single():
    """Every lane of a batched solve reproduces the single-instance
    engine bit-for-bit semantics (same iterations, same trajectories)."""
    rng = np.random.RandomState(7)
    M, N, B = 12, 30, 4
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    alphas = np.linspace(0.05, 0.5, B)

    bs = BatchedSolver(_bp_template(A, ys[0], float(alphas[0])))
    res = bs.solve({(0, "y"): ys, (1, "alpha"): alphas}, niter=200)

    for b in range(B):
        m = _bp_template(A, ys[b], float(alphas[b]))
        o = SimpleOptimizer(m)
        o.solve(200)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-9)
        nit = int(res.iterations[b])
        assert nit == len(o._primal_residual)
        np.testing.assert_allclose(
            np.asarray(res.primal_residual[b])[:nit],
            o._primal_residual, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(res.mu[b]), np.asarray(o.mu), rtol=1e-12)


def test_per_lane_convergence_masking():
    """Lanes that converge early freeze while others keep iterating.

    (An exactly-zero lane would never converge: the reference's relative
    test divides 0/0 -> NaN -> not converged, optimizer.py:244-247 — we
    preserve that, so both lanes here are nonzero.)"""
    rng = np.random.RandomState(3)
    M, N = 4, 2
    A = rng.randn(M, N)
    ys = np.stack([0.1 * A @ np.ones(N), 10 * rng.randn(M)])
    alphas = np.array([1e-3, 10.0])
    bs = BatchedSolver(_bp_template(A, ys[0]))
    res = bs.solve({(0, "y"): ys, (1, "alpha"): alphas},
                   niter=3000, rtol=1e-8)
    it0, it1 = np.asarray(res.iterations)
    assert it0 != it1
    early, late = (0, it0) if it0 < it1 else (1, it1)
    # frozen lane's residual buffer is NaN-padded past its exit
    assert np.isnan(np.asarray(res.primal_residual[early])[late:]).all()
    assert np.isfinite(np.asarray(res.primal_residual[early])[:late]).all()


def test_lambda_path_sweep():
    """λ-path: larger L1 penalties give sparser solutions."""
    rng = np.random.RandomState(11)
    M, N, B = 16, 40, 8
    A = rng.randn(M, N)
    xtrue = np.zeros(N)
    xtrue[:4] = rng.randn(4)
    y = A @ xtrue
    lambdas = np.logspace(-3, 1.0, B)

    bs = BatchedSolver(_bp_template(A, y))
    res = bs.solve({(1, "alpha"): lambdas}, niter=500)
    nnz = [(np.abs(np.asarray(res.x[1][b])) > 1e-6).sum() for b in range(B)]
    assert nnz[0] >= nnz[-1]
    assert nnz[-1] <= 4 * 2


def test_x0_mu0_batched():
    rng = np.random.RandomState(5)
    M, N, B = 6, 10, 3
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(A, ys[0]))
    x0 = tuple(np.zeros((B, N), dtype=np.complex128) for _ in range(2))
    mu0 = np.array([0.5, 1.0, 2.0])
    res = bs.solve({(0, "y"): ys}, x0=x0, mu0=mu0, niter=50,
                   interval_update_mu=1000)  # no mu adaptation window
    # mu unchanged except the boundary-0 update; compare vs single runs
    for b in range(B):
        m = _bp_template(A, ys[b])
        o = SimpleOptimizer(m, mu=float(mu0[b]))
        o.solve(50, interval_update_mu=1000)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-10)


def test_three_block_batched():
    rng = np.random.RandomState(9)
    M, N, B = 10, 12, 3
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    template = Model(
        [LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N),
         NonNegativePenalty(N)],
        [(1, 0, identity(N), identity(N)),
         (2, 0, identity(N), identity(N))])
    bs = BatchedSolver(template)
    res = bs.solve({(0, "y"): ys}, niter=300)
    for b in range(B):
        m = Model(
            [LeastSquares(1.0, A, ys[b]), L1Regularizer(0.1, N),
             NonNegativePenalty(N)],
            [(1, 0, identity(N), identity(N)),
             (2, 0, identity(N), identity(N))])
        o = SimpleOptimizer(m)
        o.solve(300)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-8)
        assert np.all(np.asarray(res.x[2][b]).real >= -1e-12)


def test_model_reuse_across_solvers():
    """The SAME Model object driven by SimpleOptimizer and then
    BatchedSolver (regression: the eigendecomposition cache used to leak
    jit tracers across traces)."""
    rng = np.random.RandomState(17)
    M, N = 10, 20
    A = rng.randn(M, N)
    y = rng.randn(M)
    m = _bp_template(A, y)
    o = SimpleOptimizer(m)
    o.solve(30)
    bs = BatchedSolver(m)
    res = bs.solve({(1, "alpha"): np.array([0.05, 0.5])}, niter=30)
    assert np.isfinite(np.asarray(res.x[0])).all()


def test_override_validation():
    rng = np.random.RandomState(0)
    A = rng.randn(4, 6)
    bs = BatchedSolver(_bp_template(A, rng.randn(4)))
    with pytest.raises(ValueError, match="no batchable"):
        bs.solve({(1, "y"): rng.randn(3, 4)}, niter=5)
    with pytest.raises(ValueError, match="inconsistent batch"):
        bs.solve({(0, "y"): rng.randn(3, 4),
                  (1, "alpha"): np.ones(5)}, niter=5)
    with pytest.raises(ValueError, match="batch size is undetermined"):
        bs.solve({}, niter=5)


def test_empty_overrides_with_batch_size():
    """Identical lanes via batch_size= only (x0 jitter distinguishes)."""
    rng = np.random.RandomState(2)
    M, N, B = 6, 8, 3
    A = rng.randn(M, N)
    y = rng.randn(M)
    bs = BatchedSolver(_bp_template(A, y))
    res = bs.solve(batch_size=B, niter=100)
    # all lanes identical
    np.testing.assert_allclose(np.asarray(res.x[0][0]),
                               np.asarray(res.x[0][2]), atol=1e-14)


def test_chunked_checks_identical_at_fixed_iterations():
    """chunked_checks skips per-iteration residual work; with no early
    exit possible the final state must be bitwise identical."""
    rng = np.random.RandomState(13)
    M, N, B = 12, 30, 4
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(A, ys[0]))
    r1 = bs.solve({(0, "y"): ys}, niter=250, rtol=0.0)
    r2 = bs.solve({(0, "y"): ys}, niter=250, rtol=0.0,
                  chunked_checks=True)
    np.testing.assert_array_equal(np.asarray(r1.x[0]),
                                  np.asarray(r2.x[0]))
    np.testing.assert_array_equal(np.asarray(r1.mu), np.asarray(r2.mu))


def test_chunked_checks_converges():
    rng = np.random.RandomState(14)
    M, N, B = 12, 30, 3
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(A, ys[0]))
    res = bs.solve({(0, "y"): ys}, niter=5000, atol=1e-8,
                   chunked_checks=True)
    assert np.asarray(res.converged).all()
    # convergence granularity is the interval
    assert (np.asarray(res.iterations) % 100 <= 1).all()


def test_batched_psd_block():
    """SemiPositiveDefinite penalty inside the batched driver (batched
    eigh under vmap in the compiled loop)."""
    from admmsolver_tpu import SemiPositiveDefinitePenalty

    rng = np.random.RandomState(15)
    n, K, B = 3, 2, 3
    N = n * n * K
    A = rng.randn(2 * N, N)
    xt = np.zeros((B, n, n, K))
    for b in range(B):
        for k in range(K):
            R = rng.randn(n, n)
            xt[b, :, :, k] = R @ R.T / n
    ys = xt.reshape(B, N) @ A.T
    m = Model([LeastSquares(1.0, A, ys[0]),
               SemiPositiveDefinitePenalty((n, n, K), axis=2)],
              [(1, 0, identity(N), identity(N))])
    res = BatchedSolver(m).solve({(0, "y"): ys}, niter=600)
    x = np.asarray(res.x[1]).real.reshape(B, n, n, K)
    for b in range(B):
        for k in range(K):
            evals = np.linalg.eigvalsh(
                0.5 * (x[b, :, :, k] + x[b, :, :, k].T))
            assert evals.min() > -1e-8
    np.testing.assert_allclose(
        np.asarray(res.x[0]).real.reshape(B, n, n, K), xt, atol=5e-2)


def test_solve_path_warm_started():
    """Warm-started λ-path continuation: same solutions as cold batched
    solves at a fraction of the iterations."""
    rng = np.random.RandomState(21)
    M, N = 14, 40
    A = rng.randn(M, N)
    xt = np.zeros(N)
    xt[:4] = rng.randn(4)
    y = A @ xt
    bs = BatchedSolver(_bp_template(A, y))
    lams = np.logspace(1, -3, 16)  # descending

    cold = bs.solve({(1, "alpha"): lams}, niter=3000, rtol=1e-8)
    path = bs.solve_path((1, "alpha"), lams, group_size=4,
                         niter=3000, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(path.x[0]),
                               np.asarray(cold.x[0]), atol=1e-5)
    assert (np.asarray(path.iterations).sum()
            < 0.7 * np.asarray(cold.iterations).sum())
    assert path.x[0].shape == (16, N)


def test_config_loading():
    from admmsolver_tpu.config import ADMMConfig

    c = ADMMConfig.from_dict({"niter": 5, "max_mu": 10.0})
    assert c.niter == 5 and c.max_mu == 10.0
    with pytest.raises(ValueError, match="unknown"):
        ADMMConfig.from_dict({"bogus": 1})


def test_single_instance_record_off():
    rng = np.random.RandomState(22)
    A = rng.randn(6, 12)
    o = SimpleOptimizer(_bp_template(A, rng.randn(6)))
    o.solve(50, record_residuals=False)
    assert o._primal_residual == []
    # state still advanced; a recording solve continues fine
    o.solve(50)
    assert len(o._primal_residual) > 0


def test_record_residuals_off():
    rng = np.random.RandomState(1)
    A = rng.randn(4, 6)
    ys = rng.randn(2, 4)
    bs = BatchedSolver(_bp_template(A, ys[0]))
    res = bs.solve({(0, "y"): ys}, niter=50, record_residuals=False)
    assert res.primal_residual.shape == (2, 1)
    assert np.asarray(res.iterations).max() <= 50


def test_record_residuals_strided():
    """record_residuals=s records ceil(niter/s) samples; the sample at
    slot k is the last in-window value of the per-iteration history."""
    rng = np.random.RandomState(3)
    M, N, B = 10, 20, 3
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(A, ys[0]))

    full = bs.solve({(0, "y"): ys}, niter=100, rtol=0)
    s = 7
    strided = bs.solve({(0, "y"): ys}, niter=100, rtol=0,
                       record_residuals=s)
    nslots = -(-100 // s)
    assert strided.primal_residual.shape == (B, nslots)
    pfull = np.asarray(full.primal_residual)
    pstr = np.asarray(strided.primal_residual)
    for k in range(nslots):
        last = min((k + 1) * s - 1, 99)
        np.testing.assert_allclose(pstr[:, k], pfull[:, last], rtol=1e-12)
    # solutions identical regardless of recording mode
    np.testing.assert_array_equal(np.asarray(strided.x[0]),
                                  np.asarray(full.x[0]))
    with pytest.raises(ValueError, match="stride"):
        bs.solve({(0, "y"): ys}, niter=10, record_residuals=0)


def test_done0_freezes_lanes():
    """done0 lanes keep their initial state, execute 0 iterations, and do
    not hold up the global exit."""
    rng = np.random.RandomState(4)
    M, N, B = 10, 20, 4
    A = rng.randn(M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(A, ys[0]))
    x0 = tuple(jnp.asarray(rng.randn(B, N)) for _ in range(2))
    done0 = np.array([False, True, False, True])
    res = bs.solve({(0, "y"): ys}, x0=x0, niter=50, rtol=0, done0=done0)
    its = np.asarray(res.iterations)
    assert its[1] == 0 and its[3] == 0
    assert its[0] == 50 and its[2] == 50
    np.testing.assert_array_equal(np.asarray(res.x[0][1]),
                                  np.asarray(x0[0][1]))
    assert np.asarray(res.converged)[1]


def test_penalty_knobs_passthrough():
    """fact_incr/th_change reach the compiled penalty update (reference
    update_mu kwargs, optimizer.py:277) on both solve APIs."""
    rng = np.random.RandomState(5)
    M, N = 8, 16
    A = rng.randn(M, N)
    y = rng.randn(M)
    m = _bp_template(A, y)

    # With th_change just above 1, exactly ONE balancing branch fires at
    # the iteration-0 boundary (the residuals are not exactly equal), so
    # mu becomes fact_incr^{+-1}; the defaults (th_change=10) leave mu=1
    # on this problem.
    bs = BatchedSolver(m)
    base = bs.solve({(0, "y"): y[None]}, niter=2, rtol=0,
                    interval_update_mu=100)
    assert np.allclose(np.asarray(base.mu), 1.0)
    tuned = bs.solve({(0, "y"): y[None]}, niter=2, rtol=0,
                     interval_update_mu=100, fact_incr=8.0,
                     th_change=1.0 + 1e-9)
    mu_t = float(np.asarray(tuned.mu).ravel()[0])
    assert mu_t in (8.0, 0.125), mu_t

    o1 = SimpleOptimizer(m)
    o1.solve(2, rtol=0)
    assert np.allclose(np.asarray(o1.mu), 1.0)
    o2 = SimpleOptimizer(m)
    o2.solve(2, rtol=0, fact_incr=8.0, th_change=1.0 + 1e-9)
    mu_o = float(np.asarray(o2.mu).ravel()[0])
    assert mu_o in (8.0, 0.125), mu_o


def test_solve_path_requires_monotone_grid():
    rng = np.random.RandomState(6)
    M, N = 8, 16
    A = rng.randn(M, N)
    y = rng.randn(M)
    bs = BatchedSolver(_bp_template(A, y))
    shuffled = np.array([0.5, 0.01, 0.2, 0.1])
    with pytest.raises(ValueError, match="monotone"):
        bs.solve_path((1, "alpha"), shuffled,
                      overrides={(0, "y"): np.broadcast_to(y, (4, M))},
                      group_size=2, niter=5)
    # monotone grids (either direction) are fine
    bs.solve_path((1, "alpha"), np.sort(shuffled)[::-1],
                  overrides={(0, "y"): np.broadcast_to(y, (4, M))},
                  group_size=2, niter=5, rtol=0,
                  record_residuals=False)


def test_solve_path_fused_matches_loop():
    """The one-jit scanned path driver (fused=True) reproduces the
    host-driven group loop exactly — same chunk schedule, same
    warm-start rule — including when len(values) is not a multiple of
    group_size (last group padded by repeating the final value)."""
    rng = np.random.RandomState(33)
    M, N = 10, 24
    A = rng.randn(M, N)
    y = A @ np.concatenate([rng.randn(3), np.zeros(N - 3)])
    bs = BatchedSolver(_bp_template(A, y))
    for nlam in (12, 11):  # divisible and ragged group counts
        lams = np.logspace(0.5, -2, nlam)
        ys = np.broadcast_to(y, (nlam, M))
        kw = dict(overrides={(0, "y"): ys}, group_size=4,
                  niter=400, rtol=1e-9)
        loop = bs.solve_path((1, "alpha"), lams, fused=False, **kw)
        fused = bs.solve_path((1, "alpha"), lams, fused=True, **kw)
        # nlam=12: identical group shapes → bit-exact in practice.
        # nlam=11: the fused driver pads the last group (4 lanes vs the
        # loop's 3), so XLA's reduction shapes differ → ~1e-15 diffs.
        np.testing.assert_allclose(np.asarray(fused.x[0]),
                                   np.asarray(loop.x[0]), atol=1e-12)
        np.testing.assert_array_equal(np.asarray(fused.iterations),
                                      np.asarray(loop.iterations))
        np.testing.assert_array_equal(np.asarray(fused.mu),
                                      np.asarray(loop.mu))
        # histories may differ by ~1 ulp (XLA fuses the iteration-0
        # residual differently under the group scan); state is bit-exact
        np.testing.assert_allclose(np.asarray(fused.primal_residual),
                                   np.asarray(loop.primal_residual),
                                   rtol=1e-12, atol=1e-12)
        assert fused.x[0].shape == (nlam, N)


def test_solve_path_fused_strided_recording():
    rng = np.random.RandomState(34)
    M, N = 8, 16
    A = rng.randn(M, N)
    y = rng.randn(M)
    bs = BatchedSolver(_bp_template(A, y))
    lams = np.logspace(0, -1, 8)
    res = bs.solve_path((1, "alpha"), lams,
                        overrides={(0, "y"): np.broadcast_to(y, (8, M))},
                        group_size=4, niter=40, rtol=0,
                        record_residuals=10)
    assert res.primal_residual.shape == (8, 4)
    assert np.isfinite(np.asarray(res.primal_residual)).all()


# ------------------------------------------------- per-instance operators

def test_batched_per_instance_A_matches_independent_solves():
    """A different dense A per lane (the reference's one-optimizer-per-
    problem generality, optimizer.py:121-152) through one compiled
    batch: each lane must match its own SimpleOptimizer run."""
    rng = np.random.RandomState(21)
    M, N, B = 6, 10, 3
    As = rng.randn(B, M, N)
    ys = rng.randn(B, M)
    bs = BatchedSolver(_bp_template(As[0], ys[0]))
    res = bs.solve({(0, "A"): As, (0, "y"): ys}, niter=80)
    for b in range(B):
        o = SimpleOptimizer(_bp_template(As[b], ys[b]))
        o.solve(80)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-9)
        np.testing.assert_allclose(np.asarray(res.x[1][b]),
                                   np.asarray(o.x[1]), atol=1e-9)


def test_batched_per_instance_A_constrained_ls():
    """Per-lane SpM-style kernels: ConstrainedLeastSquares with a
    different A per instance (e.g. per-temperature kernels) plus the
    sum-rule constraint, vs independent reference-semantics runs."""
    from admmsolver_tpu import (ConstrainedLeastSquares, L1Regularizer,
                                NonNegativePenalty)

    rng = np.random.RandomState(22)
    M, N, B = 7, 9, 3
    As = rng.randn(B, M, N)
    ys = rng.randn(B, M)
    C = np.ones((1, N))
    D = np.ones(1)

    def mk(A, y):
        return Model(
            [ConstrainedLeastSquares(1.0, A, y, C, D),
             L1Regularizer(0.05, N), NonNegativePenalty(N)],
            [(1, 0, identity(N), identity(N)),
             (2, 0, identity(N), identity(N))])

    bs = BatchedSolver(mk(As[0], ys[0]))
    res = bs.solve({(0, "A"): As, (0, "y"): ys}, niter=120)
    for b in range(B):
        o = SimpleOptimizer(mk(As[b], ys[b]))
        o.solve(120)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-8)
        # hard constraint holds per lane
        np.testing.assert_allclose(
            C @ np.asarray(res.x[0][b]), D, atol=1e-8)


def test_batched_per_instance_A_guards():
    rng = np.random.RandomState(23)
    M, N, B = 4, 6, 2
    A = rng.randn(M, N)
    bs = BatchedSolver(_bp_template(A, rng.randn(M)))
    # wrong trailing shape
    with pytest.raises(ValueError, match="matching the template"):
        bs.solve({(0, "A"): rng.randn(B, M, N + 1)}, niter=5)
    # n > 128 refuses per-lane dense factors (HBM invariant)
    big = rng.randn(4, 200)
    bs2 = BatchedSolver(_bp_template(big, rng.randn(4)))
    with pytest.raises(ValueError, match="n <= 128"):
        bs2.solve({(0, "A"): rng.randn(B, 4, 200)}, niter=5)


def test_batched_psd_block_large_slice():
    """Slice sizes past the Jacobi envelope (here k=72 > 64) run through
    the polynomial matrix-sign prox inside the compiled loop — the
    round-5 unbounded-n path (reference projects any slice size via its
    per-slice eigh loop, objectivefunc.py:322-327).  Oracles: the same
    engine forced onto (a) the scan-rolled Jacobi and (b) the XLA-eigh
    fallback."""
    from admmsolver_tpu import SemiPositiveDefinitePenalty
    from admmsolver_tpu.ops import prox as prox_mod

    rng = np.random.RandomState(16)
    k, B = 72, 2
    N = k * k
    M = N // 8
    A = rng.randn(M, N)
    Q = rng.randn(k, k)
    xt = (Q @ Q.T / k).reshape(-1)
    ys = (A @ xt)[None, :] + 1e-4 * rng.randn(B, M)

    def run():
        m = Model([LeastSquares(1.0, A, ys[0]),
                   SemiPositiveDefinitePenalty((k, k, 1), axis=2)],
                  [(1, 0, identity(N), identity(N))])
        return BatchedSolver(m).solve({(0, "y"): ys}, niter=40,
                                      record_residuals=False)

    oracles = {}
    old = (prox_mod.JACOBI_MAX_N, prox_mod.USE_SIGN_ABOVE_JACOBI)
    try:
        # "always" forces the matrix-sign path
        prox_mod.USE_SIGN_ABOVE_JACOBI = "always"
        res = run()
        prox_mod.USE_SIGN_ABOVE_JACOBI = old[1]
        prox_mod.JACOBI_MAX_N = 256   # force scan-rolled Jacobi
        oracles["jacobi"] = run()
        prox_mod.JACOBI_MAX_N = 16
        prox_mod.USE_SIGN_ABOVE_JACOBI = False   # force XLA eigh
        oracles["xla_eigh"] = run()
    finally:
        prox_mod.JACOBI_MAX_N, prox_mod.USE_SIGN_ABOVE_JACOBI = old
    for name, ref in oracles.items():
        for a, b in zip(res.x, ref.x):
            assert np.isfinite(np.asarray(a)).all()
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-8,
                                       err_msg=name)
    X = np.asarray(res.x[1]).reshape(B, k, k)
    lam = np.linalg.eigvalsh(0.5 * (X + X.swapaxes(-1, -2)))
    assert lam.min() > -1e-8


class TestRecipeAutoSelection:
    """``solve(recipe=...)``: plain, mixed, and the auto choice."""

    def _sdp(self, k=6, K=2, B=3, seed=17):
        from admmsolver_tpu import SemiPositiveDefinitePenalty

        rng = np.random.RandomState(seed)
        N = k * k * K
        A = rng.randn(2 * N, N)
        xt = np.zeros((B, k, k, K))
        for b in range(B):
            for j in range(K):
                R = rng.randn(k, k)
                xt[b, :, :, j] = R @ R.T / k
        ys = xt.reshape(B, N) @ A.T
        m = Model([LeastSquares(1.0, A, ys[0]),
                   SemiPositiveDefinitePenalty((k, k, K), axis=2)],
                  [(1, 0, identity(N), identity(N))])
        return m, ys

    def test_invalid_recipe_raises(self):
        m, ys = self._sdp()
        bs = BatchedSolver(m)
        with pytest.raises(ValueError, match="recipe"):
            bs.solve({(0, "y"): ys}, niter=10, recipe="fast")

    def test_forced_mixed_matches_plain_quality(self):
        """recipe='mixed' routes through the validated 3/4-f32 + f64
        polish split and reaches the same solution as plain f64."""
        m, ys = self._sdp()
        bs = BatchedSolver(m)
        plain = bs.solve({(0, "y"): ys}, niter=400, rtol=0.0,
                         record_residuals=False, recipe="plain")
        mixed = bs.solve({(0, "y"): ys}, niter=400, rtol=0.0,
                         record_residuals=False, recipe="mixed")
        assert mixed.x[0].dtype == plain.x[0].dtype
        assert np.isfinite(np.asarray(mixed.x[1])).all()
        np.testing.assert_allclose(np.asarray(mixed.x[0]),
                                   np.asarray(plain.x[0]), atol=2e-5)
        # total budget preserved across the phase split
        np.testing.assert_array_equal(np.asarray(mixed.iterations), 400)

    def test_auto_decision_matrix(self):
        """auto selects the plain single-phase solve for every dtype,
        model family and horizon: bit-identical to recipe='plain'."""
        import jax.numpy as jnp

        m, ys = self._sdp()
        bp = _bp_template(np.random.RandomState(0).randn(6, 12),
                          np.zeros(6))
        cases = [(m, ys, jnp.float64, 200), (m, ys, jnp.float32, 200),
                 (m, ys, jnp.float64, 10),
                 (bp, np.random.RandomState(1).randn(3, 6), None, 200)]
        for model, y, dt, niter in cases:
            bs = BatchedSolver(model)
            kw = dict(niter=niter, rtol=0.0, record_residuals=False,
                      dtype=dt)
            auto = bs.solve({(0, "y"): y}, **kw)
            plain = bs.solve({(0, "y"): y}, recipe="plain", **kw)
            for a, b in zip(auto.x, plain.x):
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b))

    def test_auto_routes_to_plain(self):
        """End-to-end: the default solve() at a 400-iteration horizon
        follows the plain trajectory, not the mixed one."""
        m, ys = self._sdp()
        bs = BatchedSolver(m)
        kw = dict(niter=400, rtol=0.0, record_residuals=False)
        mixed = bs.solve({(0, "y"): ys}, recipe="mixed", **kw)
        plain = bs.solve({(0, "y"): ys}, recipe="plain", **kw)
        auto = bs.solve({(0, "y"): ys}, **kw)
        for a, b in zip(auto.x, plain.x):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert any(not np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(auto.x, mixed.x))


class TestSolveScan:
    """Amortized scan-over-instances driver for large per-instance
    operators (reference solves one SimpleOptimizer per problem,
    optimizer.py:121-152; solve() caps per-instance A at n <= 128)."""

    def test_matches_batched_small(self):
        """Oracle: where both drivers apply (n <= 128), solve_scan must
        reproduce solve() lane-for-lane."""
        rng = np.random.RandomState(30)
        M, N, B = 8, 12, 5
        As = rng.randn(B, M, N)
        ys = rng.randn(B, M)
        m = _bp_template(As[0], ys[0])
        bs = BatchedSolver(m)
        ov = {(0, "A"): As, (0, "y"): ys}
        a = bs.solve(ov, niter=150, record_residuals=False)
        b = bs.solve_scan(ov, group_size=2, niter=150)
        for xa, xb in zip(a.x, b.x):
            np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                                       rtol=0, atol=1e-12)
        np.testing.assert_array_equal(np.asarray(a.iterations),
                                      np.asarray(b.iterations))
        np.testing.assert_allclose(np.asarray(a.mu), np.asarray(b.mu))

    def test_large_per_instance_A(self):
        """n = 512 distinct-A basis pursuit in ONE call — the regime
        solve() rejects (per-lane dense factors would blow the HBM
        budget).  Short horizon: this verifies mechanics + finiteness;
        the recovery-grade run is benches/scan_large_hw.py."""
        rng = np.random.RandomState(31)
        M, N, B = 64, 512, 6
        As = rng.randn(B, M, N)
        xt = np.zeros((B, N))
        for b in range(B):
            xt[b, rng.choice(N, 8, replace=False)] = rng.randn(8)
        ys = np.einsum("bmn,bn->bm", As, xt)
        m = _bp_template(As[0], ys[0])
        bs = BatchedSolver(m)
        ov = {(0, "A"): As, (0, "y"): ys}
        with pytest.raises(ValueError, match="solve_scan"):
            bs.solve(ov, niter=5)
        res = bs.solve_scan(ov, group_size=3, niter=40)
        assert res.x[0].shape == (B, N)
        assert np.isfinite(np.asarray(res.x[0])).all()
        # distinct problems produced distinct solutions
        assert not np.allclose(np.asarray(res.x[0][0]),
                               np.asarray(res.x[0][1]))
        # and each lane actually fits its own operator
        fit = np.linalg.norm(
            np.einsum("bmn,bn->bm", As, np.asarray(res.x[0])) - ys,
            axis=1) / np.linalg.norm(ys, axis=1)
        assert fit.max() < 0.35, fit

    def test_uneven_batch_padding(self):
        rng = np.random.RandomState(32)
        M, N, B = 6, 10, 5
        As = rng.randn(B, M, N)
        ys = rng.randn(B, M)
        bs = BatchedSolver(_bp_template(As[0], ys[0]))
        res = bs.solve_scan({(0, "A"): As, (0, "y"): ys},
                            group_size=2, niter=30)  # G=3, pad 1
        assert res.x[0].shape == (B, N)
        assert np.isfinite(np.asarray(res.x[0])).all()


def test_recipe_mixed_respects_dtype_and_warm_start_guard():
    """Round-5 review regressions: (a) an explicit dtype= reaches the
    mixed recipe's full-precision phase; (b) recipe='auto' runs warm
    starts plain; (c) recipe='mixed' with niter=1 runs plain instead of
    crashing."""
    import jax.numpy as jnp

    from admmsolver_tpu import SemiPositiveDefinitePenalty

    rng = np.random.RandomState(18)
    n, K, B = 4, 2, 2
    N = n * n * K
    A = rng.randn(2 * N, N)
    ys = rng.randn(B, 2 * N)
    m = Model([LeastSquares(1.0, A, ys[0]),
               SemiPositiveDefinitePenalty((n, n, K), axis=2)],
              [(1, 0, identity(N), identity(N))])
    bs32 = BatchedSolver(m, dtype=jnp.float32)
    ov = {(0, "y"): ys}
    # (a) dtype=float64 through the mixed route -> f64 output
    res = bs32.solve(ov, niter=40, dtype=jnp.float64, recipe="mixed",
                     record_residuals=False)
    assert res.x[0].dtype == jnp.float64
    # (c) niter=1 mixed -> plain, no crash
    r1 = bs32.solve(ov, niter=1, recipe="mixed",
                    record_residuals=False)
    assert int(np.asarray(r1.iterations).max()) == 1

    # (b) auto must not route warm starts through f32
    bs = BatchedSolver(m)  # f64
    cold = bs.solve(ov, niter=300, rtol=0.0, record_residuals=False,
                    recipe="plain")
    warm_auto = bs.solve(ov, x0=cold.x, h0=cold.h, mu0=cold.mu,
                         niter=300, rtol=0.0, record_residuals=False)
    warm_plain = bs.solve(ov, x0=cold.x, h0=cold.h, mu0=cold.mu,
                          niter=300, rtol=0.0, record_residuals=False,
                          recipe="plain")
    np.testing.assert_array_equal(np.asarray(warm_auto.x[0]),
                                  np.asarray(warm_plain.x[0]))
