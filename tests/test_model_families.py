"""Additive model families: box-constrained LS, group lasso, TV
denoising, portfolio.  Uses the reference's test idioms (SURVEY.md §4):
prox oracles via scipy.optimize.minimize, solution oracles via
closed-form / dedicated scipy solvers, and property checks.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import lsq_linear, minimize

from admmsolver_tpu import (BoxProjectionPenalty, GroupL1Regularizer,
                            SimpleOptimizer)
from admmsolver_tpu.models.applications import (
    bounded_lsq_model,
    group_lasso_model,
    portfolio_model,
    tv_denoise_model,
)
from admmsolver_tpu.ops.linop import DiagonalMatrix
from admmsolver_tpu.parallel import BatchedSolver


# ---------------------------------------------------------------- prox
# oracle idiom 1: argmin F(x) + 2 Re(h^T x) + x^T mu x via scipy

def _prox_objective(F, h, mu_diag):
    return lambda x: (F(x) + 2.0 * float(h @ x)
                      + float(x @ (mu_diag * x)))


def test_box_prox_matches_scipy():
    rng = np.random.RandomState(0)
    n = 6
    h = rng.randn(n)
    mu = np.abs(rng.randn(n)) + 0.5
    lo, hi = -0.3, 0.7
    f = BoxProjectionPenalty(n, lo, hi)
    got = np.asarray(f.solve(jnp.asarray(h), DiagonalMatrix(mu)))
    obj = _prox_objective(lambda x: 0.0, h, mu)
    res = minimize(obj, np.clip(rng.randn(n), lo, hi),
                   bounds=[(lo, hi)] * n, method="L-BFGS-B")
    np.testing.assert_allclose(got, res.x, atol=1e-6)
    assert got.min() >= lo - 1e-12 and got.max() <= hi + 1e-12


def test_box_prox_vector_bounds():
    rng = np.random.RandomState(1)
    n = 5
    lo = -np.abs(rng.randn(n))
    hi = np.abs(rng.randn(n))
    f = BoxProjectionPenalty(n, lo, hi)
    h = rng.randn(n)
    mu = np.full(n, 2.0)
    got = np.asarray(f.solve(jnp.asarray(h), DiagonalMatrix(mu)))
    want = np.clip(-h / mu, lo, hi)
    np.testing.assert_allclose(got, want, atol=1e-14)


def test_box_rejects_empty_box():
    with pytest.raises(AssertionError):
        BoxProjectionPenalty(3, 1.0, 0.0)


def test_group_l1_prox_satisfies_kkt():
    """Exact subgradient optimality of
    argmin alpha sum_g |x_g| + 2 h^T x + mu |x|^2:
    x_g != 0  =>  alpha x_g/|x_g| + 2 h_g + 2 mu x_g = 0;
    x_g == 0  =>  |h_g| <= alpha/2.
    (scipy's derivative-free minimizers are too loose an oracle for this
    nonsmooth objective — the KKT conditions are exact.)
    """
    rng = np.random.RandomState(2)
    gs, ng = 3, 5
    n = gs * ng
    # mix of strong and weak groups so both KKT branches fire
    h = rng.randn(n) * np.repeat([2.0, 0.1, 2.0, 0.05, 1.0], gs)
    mu = np.full(n, 1.3)  # blockwise-uniform (here globally uniform)
    alpha = 0.8
    f = GroupL1Regularizer(alpha, gs, ng)
    got = np.asarray(f.solve(jnp.asarray(h), DiagonalMatrix(mu)))
    active = zero = 0
    for g in range(ng):
        sl = slice(g * gs, (g + 1) * gs)
        xg, hg = got[sl], h[sl]
        nx = np.linalg.norm(xg)
        if nx > 1e-12:
            grad = alpha * xg / nx + 2 * hg + 2 * mu[sl] * xg
            np.testing.assert_allclose(grad, 0.0, atol=1e-10)
            active += 1
        else:
            assert np.linalg.norm(hg) <= alpha / 2 + 1e-12
            zero += 1
    assert active >= 1 and zero >= 1  # both branches exercised


def test_group_l1_rejects_nonuniform_mu():
    f = GroupL1Regularizer(1.0, 2, 2)
    mu = DiagonalMatrix(np.array([1.0, 2.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="blockwise-uniform"):
        f.solve(jnp.zeros(4), mu)


def test_group_l1_value():
    f = GroupL1Regularizer(2.0, 2, 2)
    x = np.array([3.0, 4.0, 0.0, 0.0])
    assert np.isclose(f(x), 2.0 * 5.0)


# ------------------------------------------------------------- solvers

def test_bounded_lsq_matches_scipy():
    rng = np.random.RandomState(3)
    M, N = 20, 8
    A = rng.randn(M, N)
    y = rng.randn(M)
    lo, hi = -0.25, 0.5
    opt = SimpleOptimizer(bounded_lsq_model(A, y, lo, hi))
    opt.solve(4000)
    x = np.asarray(opt.x[1]).real  # the box block is feasible
    ref = lsq_linear(A, y, bounds=(lo, hi))
    np.testing.assert_allclose(x, ref.x, atol=1e-6)


def test_bounded_lsq_batched_per_instance_bounds():
    """BoxProjectionPenalty.batch_fields: per-instance boxes through the
    batched runtime."""
    rng = np.random.RandomState(4)
    B, M, N = 3, 15, 6
    A = rng.randn(M, N)
    y = rng.randn(M)
    his = np.array([0.2, 0.5, 1.0])
    bs = BatchedSolver(bounded_lsq_model(A, y, 0.0, 1.0))
    res = bs.solve({(1, "hi"): jnp.asarray(his)[:, None]
                    * jnp.ones((B, N))},
                   niter=3000, rtol=0.0)
    for b in range(B):
        xb = np.asarray(res.x[1][b])
        assert xb.max() <= his[b] + 1e-8 and xb.min() >= -1e-8
        ref = lsq_linear(A, y, bounds=(0.0, his[b]))
        np.testing.assert_allclose(xb, ref.x, atol=1e-5)


def test_group_lasso_recovers_block_support():
    rng = np.random.RandomState(5)
    gs, ng = 4, 10
    N = gs * ng
    M = 30
    A = rng.randn(M, N)
    xt = np.zeros(N)
    for g in (2, 7):  # two active groups
        xt[g * gs:(g + 1) * gs] = rng.randn(gs)
    y = A @ xt
    opt = SimpleOptimizer(group_lasso_model(A, y, alpha=0.05,
                                            group_size=gs))
    opt.solve(3000)
    x = np.asarray(opt.x[1]).real.reshape(ng, gs)
    norms = np.linalg.norm(x, axis=1)
    # active groups recovered, inactive groups (block-)zero
    assert norms[[2, 7]].min() > 0.5 * norms.max()
    inactive = np.delete(np.arange(ng), [2, 7])
    assert norms[inactive].max() < 1e-2 * norms.max()
    np.testing.assert_allclose(x.ravel(), xt, atol=1e-2 * np.abs(xt).max())


def test_group_lasso_large_alpha_zeroes_everything():
    rng = np.random.RandomState(6)
    A = rng.randn(10, 8)
    y = 0.01 * rng.randn(10)
    opt = SimpleOptimizer(group_lasso_model(A, y, alpha=1e3,
                                            group_size=4))
    opt.solve(500)
    assert np.abs(np.asarray(opt.x[1])).max() < 1e-8


def test_tv_denoise_large_lambda_is_constant():
    rng = np.random.RandomState(7)
    y = rng.randn(40)
    opt = SimpleOptimizer(tv_denoise_model(y, lam=1e3))
    opt.solve(3000)
    x = np.asarray(opt.x[0]).real
    np.testing.assert_allclose(x, np.full_like(x, y.mean()), atol=1e-4)


def test_tv_denoise_satisfies_kkt():
    """Exact optimality of min 0.5|x-y|^2 + lam |Dx|_1 via the dual
    certificate: x - y + lam D^T s = 0 must admit s with |s| <= 1 and
    s_i = sign((Dx)_i) wherever Dx != 0.  s is recovered from the
    stationarity equation by a cumulative sum (D^T is bidiagonal), so
    the check is exact — unlike derivative-free scipy minimizers, which
    stall far from the optimum on this nonsmooth objective (our solver
    beats their objective value; asserted below).
    """
    rng = np.random.RandomState(8)
    n = 12
    y = np.r_[np.zeros(n // 2), np.ones(n - n // 2)] + 0.1 * rng.randn(n)
    lam = 0.2
    opt = SimpleOptimizer(tv_denoise_model(y, lam))
    opt.solve(6000)
    x = np.asarray(opt.x[0]).real

    # recover the dual variable: (D^T s)_i = (y - x)_i / lam
    u = (y - x) / lam
    # (D^T s)_1 = -s_1; (D^T s)_i = s_{i-1} - s_i; (D^T s)_n = s_{n-1}
    s = -np.cumsum(u[:-1])
    np.testing.assert_allclose(s[-1], u[-1], atol=1e-6)  # consistency
    assert np.abs(s).max() <= 1.0 + 1e-6
    dx = np.diff(x)
    jump = np.abs(dx) > 1e-6
    np.testing.assert_allclose(s[jump], np.sign(dx[jump]), atol=1e-6)

    def obj(v):
        return 0.5 * np.sum((v - y) ** 2) + lam * np.sum(
            np.abs(np.diff(v)))

    res = minimize(obj, y, method="Nelder-Mead",
                   options={"maxiter": 50000, "xatol": 1e-10,
                            "fatol": 1e-12})
    assert obj(x) <= obj(res.x) + 1e-6


def test_portfolio_simplex_and_oracle():
    rng = np.random.RandomState(9)
    N = 8
    G = rng.randn(N, N)
    cov = G @ G.T / N + 0.1 * np.eye(N)
    returns = rng.randn(N)
    gamma = 0.5
    opt = SimpleOptimizer(portfolio_model(cov, returns, gamma))
    opt.solve(6000)
    x = np.asarray(opt.x[1]).real  # the nonneg block is feasible
    assert x.min() >= -1e-9
    # the CLS block satisfies the budget equality exactly
    x0 = np.asarray(opt.x[0]).real
    np.testing.assert_allclose(x0.sum(), 1.0, atol=1e-9)

    def obj(v):
        return float(v @ cov @ v - gamma * returns @ v)

    cons = [{"type": "eq", "fun": lambda v: v.sum() - 1.0}]
    ref = minimize(obj, np.full(N, 1.0 / N), method="SLSQP",
                   bounds=[(0.0, None)] * N, constraints=cons,
                   options={"maxiter": 1000, "ftol": 1e-14})
    assert obj(x) <= obj(ref.x) + 1e-6
    np.testing.assert_allclose(x, ref.x, atol=1e-4)


# ------------------------------------------------------------ robust PCA

def test_nuclear_prox_matches_scipy():
    """Singular-value soft-threshold vs the generic-minimizer oracle."""
    from admmsolver_tpu import NuclearNormPenalty
    from admmsolver_tpu.ops.linop import ScaledIdentityMatrix

    rng = np.random.RandomState(3)
    m, n = 4, 3
    alpha, mu = 0.8, 1.3
    h = rng.randn(m * n)
    f = NuclearNormPenalty(alpha, (m, n))
    got = np.asarray(f.solve(jnp.asarray(h),
                             ScaledIdentityMatrix(m * n, mu)))

    def F(x):
        return alpha * np.linalg.svd(x.reshape(m, n),
                                     compute_uv=False).sum()

    obj = _prox_objective(F, h, np.full(m * n, mu))
    # closed form dominates the generic minimizer (Nelder-Mead stalls
    # short of the optimum in 12 dims, so compare objectives, not x)
    res = minimize(obj, got + 0.1 * rng.randn(m * n),
                   method="Nelder-Mead",
                   options={"maxiter": 40000, "xatol": 1e-10,
                            "fatol": 1e-12})
    assert obj(got) <= res.fun + 1e-8
    # independent NumPy singular-value soft-threshold of -h/mu
    V = (-h / mu).reshape(m, n)
    U, s, Vh = np.linalg.svd(V, full_matrices=False)
    want = (U * np.maximum(s - 0.5 * alpha / mu, 0.0)) @ Vh
    np.testing.assert_allclose(got, want.reshape(-1), atol=1e-12)


def test_nuclear_prox_gram_svd_matches_xla_svd():
    """The Gram SVD route (eigh of the Gram, svd_method='gram') computes
    the same singular-value soft-threshold as the exact-SVD route: the
    Gram's sqrt(eps) small-singular-value floor sits inside the
    threshold dead zone."""
    from admmsolver_tpu import NuclearNormPenalty
    from admmsolver_tpu.ops.linop import ScaledIdentityMatrix

    rng = np.random.RandomState(13)
    m, n = 8, 6
    h = rng.randn(m * n)
    mu = ScaledIdentityMatrix(m * n, 1.1)
    f_x = NuclearNormPenalty(0.9, (m, n), svd_method="xla")
    f_g = NuclearNormPenalty(0.9, (m, n), svd_method="gram")
    got_x = np.asarray(f_x.solve(jnp.asarray(h), mu))
    got_g = np.asarray(f_g.solve(jnp.asarray(h), mu))
    np.testing.assert_allclose(got_g, got_x, rtol=0, atol=1e-9)
    # and the batched/vmapped form the engine uses
    import jax

    hb = rng.randn(5, m * n)
    md = jnp.full(m * n, 1.1)
    gx = np.asarray(jax.vmap(lambda v: f_x.prox_diag(v, md))(
        jnp.asarray(hb)))
    gg = np.asarray(jax.vmap(lambda v: f_g.prox_diag(v, md))(
        jnp.asarray(hb)))
    np.testing.assert_allclose(gg, gx, rtol=0, atol=1e-9)


def test_rpca_solves_with_gram_svd():
    """Full rpca trajectory with the Gram SVD route matches the exact-SVD
    trajectory to engine tolerance."""
    from admmsolver_tpu import (L1Regularizer, NuclearNormPenalty,
                                SimpleOptimizer)
    from admmsolver_tpu.models.applications import rpca_model

    rng = np.random.RandomState(14)
    m, n = 10, 8
    L0 = rng.randn(m, 2) @ rng.randn(2, n)
    Y = L0.copy()
    Y[rng.rand(m, n) < 0.08] += 5.0

    def run(method):
        o = SimpleOptimizer(rpca_model(Y, svd_method=method))
        o.solve(400)
        return np.asarray(o.x[0])

    np.testing.assert_allclose(run("gram"), run("xla"), rtol=0,
                               atol=5e-7)


def test_nuclear_prox_rejects_nonuniform_mu():
    from admmsolver_tpu import NuclearNormPenalty

    f = NuclearNormPenalty(1.0, (2, 3))
    with pytest.raises(ValueError, match="uniform"):
        f.solve(jnp.zeros(6), DiagonalMatrix(np.arange(1.0, 7.0)))


def test_l1_offset_prox_matches_scipy():
    from admmsolver_tpu import L1Regularizer

    rng = np.random.RandomState(4)
    n = 5
    alpha = 0.7
    y = rng.randn(n)
    h = rng.randn(n)
    mu = np.abs(rng.randn(n)) + 0.5
    f = L1Regularizer(alpha, n, offset=y)
    got = np.asarray(f.solve(jnp.asarray(h), DiagonalMatrix(mu)))
    obj = _prox_objective(lambda x: alpha * np.abs(x - y).sum(), h, mu)
    res = minimize(obj, got + 0.05 * rng.randn(n), method="Nelder-Mead",
                   options={"maxiter": 20000, "xatol": 1e-10,
                            "fatol": 1e-12})
    assert obj(got) <= res.fun + 1e-9
    np.testing.assert_allclose(got, res.x, atol=1e-5)


def test_rpca_recovers_low_rank_plus_sparse():
    """Property check: RPCA separates a rank-2 matrix from sparse
    corruption (standard lam = 1/sqrt(max_dim))."""
    from admmsolver_tpu.models.applications import rpca_model

    rng = np.random.RandomState(5)
    m, n, r = 20, 16, 2
    L0 = rng.randn(m, r) @ rng.randn(r, n)
    S0 = np.zeros((m, n))
    mask = rng.rand(m, n) < 0.06
    S0[mask] = 5.0 * rng.randn(mask.sum())
    Y = L0 + S0

    o = SimpleOptimizer(rpca_model(Y))
    o.solve(800)
    L = np.asarray(o.x[0]).reshape(m, n)
    S = Y - L
    assert np.abs(L - L0).max() < 0.15 * np.abs(L0).max()
    # sparse part concentrates on the corrupted mask
    off = np.abs(S)[~mask].max() if (~mask).any() else 0.0
    on = np.abs(S)[mask].min() if mask.any() else 1.0
    assert off < 0.3, off
    sv = np.linalg.svd(L, compute_uv=False)
    assert sv[r:].max() < 0.05 * sv[0], sv


def test_rpca_batched_per_instance_Y():
    """Per-instance data through the offset batch field."""
    from admmsolver_tpu.models.applications import rpca_model

    rng = np.random.RandomState(6)
    m, n, B = 8, 6, 3
    Ys = []
    for _ in range(B):
        L0 = np.outer(rng.randn(m), rng.randn(n))
        S0 = np.zeros((m, n))
        S0[rng.randint(m), rng.randint(n)] = 4.0
        Ys.append(L0 + S0)
    Ys = np.stack(Ys)
    model = rpca_model(Ys[0])
    bs = BatchedSolver(model)
    res = bs.solve({(1, "offset"): Ys.reshape(B, m * n)}, niter=400)
    for b in range(B):
        o = SimpleOptimizer(rpca_model(Ys[b]))
        o.solve(400)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-8)


# ----------------------------------------------------- Huber regression

def test_huber_prox_matches_scipy():
    from admmsolver_tpu import HuberLoss

    rng = np.random.RandomState(7)
    n = 6
    alpha, delta = 0.9, 0.6
    y = rng.randn(n)
    h = 2.0 * rng.randn(n)
    mu = np.abs(rng.randn(n)) + 0.3
    f = HuberLoss(alpha, y, delta)
    got = np.asarray(f.solve(jnp.asarray(h), DiagonalMatrix(mu)))

    def H(x):
        z = np.abs(x - y)
        return alpha * np.sum(np.where(z <= delta, 0.5 * z * z,
                                       delta * (z - 0.5 * delta)))

    obj = _prox_objective(H, h, mu)
    res = minimize(obj, got + 0.05 * rng.randn(n), method="Nelder-Mead",
                   options={"maxiter": 40000, "xatol": 1e-12,
                            "fatol": 1e-14})
    assert obj(got) <= res.fun + 1e-10
    np.testing.assert_allclose(got, res.x, atol=1e-5)


def test_huber_value_and_quadratic_limit():
    from admmsolver_tpu import HuberLoss
    from admmsolver_tpu.ops.linop import ScaledIdentityMatrix

    rng = np.random.RandomState(8)
    n = 5
    y = rng.randn(n)
    x = y + 0.01 * rng.randn(n)  # inside the quadratic region
    f = HuberLoss(2.0, y, delta=1.0)
    np.testing.assert_allclose(f(jnp.asarray(x)),
                               2.0 * 0.5 * np.sum((x - y) ** 2),
                               rtol=1e-12)
    # delta -> inf degenerates to the shifted-quadratic solve
    big = HuberLoss(2.0, y, delta=1e9)
    h = rng.randn(n)
    mu = 1.7
    got = np.asarray(big.solve(jnp.asarray(h),
                               ScaledIdentityMatrix(n, mu)))
    # argmin alpha/2 |x-y|^2 + 2 h x + mu x^2
    want = (2.0 * y - 2.0 * h) / (2.0 + 2.0 * mu)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_robust_regression_resists_outliers():
    """Huber fit tracks the clean line; plain LS is dragged by the
    outliers (property check)."""
    from admmsolver_tpu.models.applications import robust_regression_model

    rng = np.random.RandomState(9)
    M, N = 60, 3
    A = np.c_[np.ones(M), rng.randn(M, N - 1)]
    beta = np.array([1.0, -2.0, 0.5])
    y = A @ beta + 0.05 * rng.randn(M)
    out = rng.choice(M, 6, replace=False)
    y[out] += 25.0 * rng.choice([-1.0, 1.0], 6)

    o = SimpleOptimizer(robust_regression_model(A, y, delta=0.5))
    o.solve(3000)
    bh = np.asarray(o.x[0])
    b_ls = np.linalg.lstsq(A, y, rcond=None)[0]
    err_h = np.abs(bh - beta).max()
    err_ls = np.abs(b_ls - beta).max()
    assert err_h < 0.1, err_h
    assert err_h < 0.3 * err_ls, (err_h, err_ls)


def test_robust_regression_batched_per_instance_y():
    from admmsolver_tpu.models.applications import robust_regression_model

    rng = np.random.RandomState(10)
    M, N, B = 20, 2, 3
    A = np.c_[np.ones(M), rng.randn(M)]
    ys = np.stack([A @ rng.randn(N) + 0.1 * rng.randn(M)
                   for _ in range(B)])
    ys[:, 0] += 10.0  # one shared outlier
    model = robust_regression_model(A, ys[0], delta=0.5)
    bs = BatchedSolver(model)
    res = bs.solve({(1, "y"): ys}, niter=800)
    for b in range(B):
        o = SimpleOptimizer(robust_regression_model(A, ys[b], delta=0.5))
        o.solve(800)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-8)


def test_tv_structured_matches_dense_trajectory():
    """BandedMatrix D + cyclic-reduction factor drives the same engine
    trajectory as the dense construction (to fp roundoff)."""
    from admmsolver_tpu import SimpleOptimizer
    from admmsolver_tpu.models.applications import tv_denoise_model
    from admmsolver_tpu.ops.linop import BandedMatrix, TridiagFactor

    rng = np.random.RandomState(41)
    n = 60
    y = np.r_[np.zeros(n // 2), np.ones(n - n // 2)] + 0.2 * rng.randn(n)
    mb = tv_denoise_model(y, 0.4, structured=True)
    assert isinstance(mb.E[(1, 0)], BandedMatrix)
    # the quadratic factor is the CR cascade, never a dense inverse
    from admmsolver_tpu.optimizer import ADMMPlan

    plan = ADMMPlan(mb)
    factors = plan.compute_factors(jnp.ones(1))
    assert isinstance(factors[0], TridiagFactor)

    o1 = SimpleOptimizer(mb)
    o1.solve(200)
    o2 = SimpleOptimizer(tv_denoise_model(y, 0.4, structured=False))
    o2.solve(200)
    np.testing.assert_allclose(np.asarray(o1.x[0]), np.asarray(o2.x[0]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(o1._primal_residual, o2._primal_residual,
                               rtol=1e-8, atol=1e-12)


def test_tv_structured_batched_lanes_match_single():
    """The CR factor vmaps: batched TV solves match per-instance runs."""
    from admmsolver_tpu import SimpleOptimizer
    from admmsolver_tpu.models.applications import tv_denoise_model

    rng = np.random.RandomState(42)
    n, B = 40, 3
    truth = np.r_[np.zeros(n // 2), np.ones(n - n // 2)]
    ys = truth[None, :] + 0.2 * rng.randn(B, n)
    bs = BatchedSolver(tv_denoise_model(ys[0], 0.4))
    res = bs.solve({(0, "y"): ys}, niter=150)
    for b in range(B):
        o = SimpleOptimizer(tv_denoise_model(ys[b], 0.4))
        o.solve(150)
        np.testing.assert_allclose(np.asarray(res.x[0][b]),
                                   np.asarray(o.x[0]), atol=1e-9)


def test_covariance_denoise_model():
    """Weighted nearest-PSD denoising (the large-slice SDP family):
    solution is PSD, beats the noisy input in Frobenius distance to the
    clean matrix, and equals the unweighted analytic projection when
    W = I and the data-fit weight dominates."""
    import jax.numpy as jnp

    from admmsolver_tpu import SimpleOptimizer
    from admmsolver_tpu.models.applications import covariance_denoise_model

    rng = np.random.RandomState(5)
    k = 24
    Q = rng.randn(k, k)
    C = Q @ Q.T / k
    Y = C + 0.25 * rng.randn(k, k)
    Y = (Y + Y.T) / 2

    m = covariance_denoise_model(Y, weights=1.0 + rng.rand(k * k))
    o = SimpleOptimizer(m)
    o.solve(2000, rtol=1e-10)
    X = np.asarray(o.x[1]).reshape(k, k)
    lam = np.linalg.eigvalsh(0.5 * (X + X.T))
    assert lam.min() > -1e-9
    assert np.linalg.norm(X - C) < np.linalg.norm(Y - C)

    # batched driver over per-lane Y (the (0,'y') override carries w*Y)
    from admmsolver_tpu.parallel import BatchedSolver

    B = 3
    Ys = Y[None] + 0.05 * rng.randn(B, k, k)
    Ys = (Ys + Ys.swapaxes(-1, -2)) / 2
    m1 = covariance_denoise_model(Ys[0])
    bs = BatchedSolver(m1)
    res = bs.solve({(0, "y"): jnp.asarray(Ys.reshape(B, -1))},
                   niter=1500, rtol=1e-9, record_residuals=False)
    Xb = np.asarray(res.x[1]).reshape(B, k, k)
    lamb = np.linalg.eigvalsh(0.5 * (Xb + Xb.swapaxes(-1, -2)))
    assert lamb.min() > -1e-8


def test_nuclear_prox_sign_route_matches_svd():
    """svd_method='sign' (the SVD-free polar route) reproduces the exact-SVD soft-threshold, through
    the prox AND inside a full rpca solve."""
    import jax.numpy as jnp

    from admmsolver_tpu import NuclearNormPenalty
    from admmsolver_tpu.ops.linop import DiagonalMatrix

    rng = np.random.RandomState(9)
    m, n = 80, 72
    f_sign = NuclearNormPenalty(1.3, (m, n), svd_method="sign")
    f_xla = NuclearNormPenalty(1.3, (m, n), svd_method="xla")
    h = jnp.asarray(rng.randn(m * n))
    mu = DiagonalMatrix(jnp.full(m * n, 0.7))
    np.testing.assert_allclose(np.asarray(f_sign.solve(h, mu)),
                               np.asarray(f_xla.solve(h, mu)),
                               rtol=0, atol=1e-11)
    # objective value still evaluable (falls back to Gram SVD)
    v = float(f_sign(h))
    assert np.isfinite(v) and v > 0

    # full solve: rpca with 80x72 matrices, sign vs xla trajectories
    from admmsolver_tpu.models.applications import rpca_model
    from admmsolver_tpu.parallel import BatchedSolver

    L0 = rng.randn(m, 3) @ rng.randn(3, n)
    Y = L0.copy()
    mask = rng.rand(m, n) < 0.05
    Y[mask] += 6.0 * rng.randn(int(mask.sum()))

    def run(method):
        mod = rpca_model(Y, svd_method=method)
        return BatchedSolver(mod).solve(
            batch_size=1,
            overrides={(1, "offset"): Y.reshape(1, -1)},
            niter=150, rtol=0.0, record_residuals=False)

    a = run("sign")
    b = run("xla")
    np.testing.assert_allclose(np.asarray(a.x[0]), np.asarray(b.x[0]),
                               rtol=0, atol=1e-9)
