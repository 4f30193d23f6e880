"""Fused SpM 3-block solver tests (the XLA engine is the oracle — the
chunk must reproduce the iteration math, including the constrained-LS
elimination folded into the affine factor)."""
import numpy as np
import jax.numpy as jnp
import pytest

from admmsolver_tpu.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu.parallel import BatchedSolver, FusedSpMSolver


@pytest.fixture(scope="module")
def spm_setup():
    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(nl=12, nw=25)
    rng = np.random.RandomState(0)
    B = 6
    gs = np.asarray(g)[None, :] + 1e-4 * rng.randn(B, g.size)
    model = spm_model(s, np.asarray(g), prj_sum, prj_w, alpha_l1=1e-3)
    return model, gs


def test_fused_spm_matches_engine_short(spm_setup):
    """Short horizon: per-iteration f32 state match (through the
    iteration-0 penalty boundary)."""
    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    rf = fs.solve({(0, "y"): gs}, niter=21, mu0=0.1)
    rb = BatchedSolver(model).solve({(0, "y"): gs}, niter=21, mu0=0.1,
                                    dtype=jnp.float32)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(rf.x[k]),
                                   np.asarray(rb.x[k]), atol=5e-4)
    for k in range(2):
        np.testing.assert_allclose(np.asarray(rf.h[k]),
                                   np.asarray(rb.h[k]), atol=5e-4)


def test_fused_spm_matches_engine_long(spm_setup):
    """Long horizon through many penalty updates: same fixed-point
    neighborhood, penalties within one balancing step."""
    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    rf = fs.solve({(0, "y"): gs}, niter=1501, mu0=0.1, rtol=1e-6)
    rb = BatchedSolver(model).solve({(0, "y"): gs}, niter=1501, mu0=0.1,
                                    rtol=1e-6, dtype=jnp.float32)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(rf.x[k]),
                                   np.asarray(rb.x[k]), atol=2e-3)
    ratio = np.asarray(rf.mu) / np.asarray(rb.mu)
    assert np.all((ratio >= 0.49) & (ratio <= 2.01)), ratio


def test_fused_spm_solution_properties(spm_setup):
    """Solution-level checks: sum rule exact, spectrum nonnegative,
    converged lanes flagged."""
    model, gs = spm_setup
    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(nl=12, nw=25)
    fs = FusedSpMSolver(model)
    rf = fs.solve({(0, "y"): gs}, niter=4000, mu0=0.1, atol=1e-6)
    assert bool(np.all(np.asarray(rf.converged)))
    x2 = np.asarray(rf.x[2])
    assert x2.min() >= 0.0
    sums = np.asarray(rf.x[0]) @ np.asarray(prj_sum)
    np.testing.assert_allclose(sums, 1.0, atol=1e-4)


def test_fused_spm_plain_ls_block():
    """The LeastSquares (unconstrained) special case: M = B, b2 = aBA†y."""
    from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                                NonNegativePenalty, identity)

    rng = np.random.RandomState(1)
    nl, nw, B = 10, 17, 4
    A = rng.randn(14, nl)
    P = rng.randn(nw, nl) * 0.3
    ys = rng.randn(B, 14)
    model = Model(
        [LeastSquares(1.0, A, ys[0]), L1Regularizer(0.05, nl),
         NonNegativePenalty(nw)],
        [(0, 1, identity(nl), identity(nl)),
         (0, 2, P, identity(nw))])
    fs = FusedSpMSolver(model)
    rf = fs.solve({(0, "y"): ys}, niter=120)
    rb = BatchedSolver(model).solve({(0, "y"): ys}, niter=120,
                                    dtype=jnp.float32)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(rf.x[k]),
                                   np.asarray(rb.x[k]), atol=1e-3)


def test_fused_spm_alpha_overrides(spm_setup):
    """Per-lane alpha overrides reach the kernel's threshold and factor."""
    model, gs = spm_setup
    B = gs.shape[0]
    alphas = np.linspace(5e-4, 5e-3, B)
    fs = FusedSpMSolver(model)
    rf = fs.solve({(0, "y"): gs, (1, "alpha"): alphas}, niter=80, mu0=0.1)
    rb = BatchedSolver(model).solve(
        {(0, "y"): gs, (1, "alpha"): alphas}, niter=80, mu0=0.1,
        dtype=jnp.float32)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(rf.x[k]),
                                   np.asarray(rb.x[k]), atol=1e-3)


def test_fused_spm_rejects_wrong_structure():
    from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                                identity)

    rng = np.random.RandomState(2)
    A = rng.randn(6, 8)
    m2 = Model([LeastSquares(1.0, A, rng.randn(6)),
                L1Regularizer(0.1, 8)],
               [(1, 0, identity(8), identity(8))])
    with pytest.raises(AssertionError):
        FusedSpMSolver(m2)


def test_fused_spm_mixed_precision_handoff(spm_setup):
    """Fused-f32 phase + f64 engine polish reaches the same solution as
    a pure-f64 solve of the same total budget."""
    import jax.numpy as jnp

    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    mixed = fs.solve_mixed({(0, "y"): gs}, niter_low=600, niter=300,
                           mu0=0.1, rtol=0.0, record_residuals=False)
    pure = BatchedSolver(model, dtype=jnp.float64).solve(
        {(0, "y"): gs}, niter=900, mu0=0.1, rtol=0.0,
        record_residuals=False)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(mixed.x[k]),
                                   np.asarray(pure.x[k]), atol=2e-5)
    assert mixed.x[0].dtype == jnp.float64
    # the f32 phase may exit early at low_atol; total = phase1 + phase2
    total = int(np.asarray(mixed.iterations)[0])
    assert 300 < total <= 900, total


def test_fused_spm_mixed_one_jit_matches_two_dispatch(spm_setup):
    """The one-jit composite (kernel phase + promotion + engine polish)
    reproduces the two-dispatch driver exactly."""
    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    ov = {(0, "y"): gs}
    kw = dict(niter_low=200, niter=100, mu0=0.1, rtol=0.0,
              record_residuals=False)
    two = fs.solve_mixed(ov, fused=False, **kw)
    one = fs.solve_mixed(ov, fused=True, **kw)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(one.x[k]),
                                   np.asarray(two.x[k]),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(np.asarray(one.iterations),
                                  np.asarray(two.iterations))
    np.testing.assert_allclose(np.asarray(one.mu), np.asarray(two.mu),
                               rtol=1e-12)
    assert one.x[0].dtype == jnp.float64


def test_fused_spm_rejects_unsupported_overrides(spm_setup):
    """Engine-legal override keys the kernel does not plumb (e.g. a
    per-instance operator) must raise, not silently solve the template
    problem (round-4 advisor, fused_spm.py)."""
    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    B = gs.shape[0]
    nl = model.functions[0].size_x
    bad = {(0, "y"): gs, (0, "A"): np.zeros((B, gs.shape[1], nl))}
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve(bad, niter=5)
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve_mixed(bad, niter_low=5, niter=5)
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve_mixed(bad, niter_low=5, niter=5, fused=False)
    # scalar override (no batch axis) also rejected
    with pytest.raises(ValueError, match="leading batch axis"):
        fs.solve({(1, "alpha"): 0.1}, batch_size=B, niter=5)


def test_fused_spm_nontile_batch_pad_trim(spm_setup):
    """Any batch size runs as it is, with no padding: a sub-batch solves
    lane-for-lane like the full batch (lanes are independent), and each
    batch size compiles its own program."""
    model, gs = spm_setup
    fs = FusedSpMSolver(model)
    r = fs.solve({(0, "y"): gs}, niter=40, mu0=0.1)
    for k in range(3):
        assert np.asarray(r.x[k]).shape[0] == gs.shape[0]
    n_main = sum(1 for k in fs._run_cache if k[0] == "solve")
    r5 = fs.solve({(0, "y"): gs[:5]}, niter=40, mu0=0.1)
    assert sum(1 for k in fs._run_cache if k[0] == "solve") == n_main + 1
    for k in range(3):
        np.testing.assert_allclose(np.asarray(r5.x[k]),
                                   np.asarray(r.x[k])[:5], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(r5.iterations),
                                  np.asarray(r.iterations)[:5])
