"""Fused-chunk tests (the engine is the oracle — the chunks must
reproduce the XLA engine's iteration math)."""
import numpy as np
import jax.numpy as jnp
import pytest

from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                            NonNegativePenalty, identity,
                            DiagonalMatrix)
from admmsolver_tpu.parallel import BatchedSolver
from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver


def _bp(A, y, alpha=0.1, block1="l1"):
    N = A.shape[1]
    b1 = (L1Regularizer(alpha, N) if block1 == "l1"
          else NonNegativePenalty(N))
    return Model([LeastSquares(1.0, A, y), b1],
                 [(1, 0, identity(N), identity(N))])


def _setup(B=8, M=64, N=128, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 8, replace=False)] = rng.randn(8)
    return A, xt @ A.T, xt


def test_fused_matches_engine_l1():
    A, ys, _ = _setup()
    t = _bp(A, ys[0])
    fs = FusedTwoBlockSolver(t)
    # strict short-horizon match: per-iteration f32 noise between the
    # kernel's and the engine's (equivalent) contraction orders is ~3e-5
    # and random-walks through the L1 switching dynamics, so exact state
    # equality only holds over short horizons.
    rf = fs.solve({(0, "y"): ys}, niter=21)
    rb = BatchedSolver(t).solve({(0, "y"): ys}, niter=21,
                                dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(rf.h), np.asarray(rb.h[0]),
                               atol=5e-4)
    # long horizon: both land in the same fixed-point neighborhood, with
    # penalties at most one residual-balancing step apart.
    rf = fs.solve({(0, "y"): ys}, niter=4001, rtol=1e-7)
    rb = BatchedSolver(t).solve({(0, "y"): ys}, niter=4001, rtol=1e-7,
                                dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(rf.x1), np.asarray(rb.x[1]),
                               atol=1e-3)
    ratio = np.asarray(rf.mu) / np.asarray(rb.mu[:, 0])
    assert np.all((ratio >= 0.49) & (ratio <= 2.01)), ratio


def test_fused_matches_engine_nonneg():
    A, ys, _ = _setup(seed=3)
    ys = np.abs(ys)
    t = _bp(A, ys[0], block1="nonneg")
    fs = FusedTwoBlockSolver(t)
    # strict short-horizon match (before f32 rounding noise amplifies in
    # the shrinkage-free nonneg iteration)
    rf = fs.solve({(0, "y"): ys}, niter=21)
    rb = BatchedSolver(t).solve({(0, "y"): ys}, niter=21,
                                dtype=jnp.float32)
    # different-but-equivalent contraction orders: ~1e-5 f32 noise/iter
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=1e-3)
    # long horizon: same fixed point neighborhood
    rf = fs.solve({(0, "y"): ys}, niter=201)
    rb = BatchedSolver(t).solve({(0, "y"): ys}, niter=201,
                                dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=1e-2)
    assert np.asarray(rf.x1).min() >= 0


def test_fused_lambda_sweep_and_padding():
    """Per-lane L1 strengths on a batch of six lanes."""
    A, ys, xt = _setup(B=6)
    t = _bp(A, ys[0])
    fs = FusedTwoBlockSolver(t)
    lam = np.logspace(-2, 0, 6)
    rf = fs.solve({(0, "y"): ys, (1, "alpha"): lam}, niter=301)
    assert rf.x0.shape == (6, A.shape[1])
    rb = BatchedSolver(t).solve({(0, "y"): ys, (1, "alpha"): lam},
                                niter=301, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=2e-4)


def test_fused_rejects_unsupported():
    A, ys, _ = _setup()
    N = A.shape[1]
    # non-identity coupling
    t = Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N)],
              [(1, 0, DiagonalMatrix(jnp.asarray(np.ones(N) * 2.0)),
                identity(N))])
    with pytest.raises(ValueError, match="identity couplings"):
        FusedTwoBlockSolver(t)
    # 3-block model
    t3 = Model(
        [LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N),
         NonNegativePenalty(N)],
        [(1, 0, identity(N), identity(N)),
         (2, 0, identity(N), identity(N))])
    with pytest.raises(AssertionError):
        FusedTwoBlockSolver(t3)


def test_fused_atol_early_exit():
    A, ys, _ = _setup()
    t = _bp(A, ys[0])
    fs = FusedTwoBlockSolver(t)
    # f32 floors around ~1e-5 absolute residual on this problem; 1e-3 is
    # comfortably reachable
    rf = fs.solve({(0, "y"): ys}, niter=5001, atol=1e-3)
    assert np.asarray(rf.converged).all()
    assert np.asarray(rf.iterations).max() < 5001


def test_fused_realified_complex():
    """Complex basis pursuit through the fused kernel: realify the model
    (models.realify), solve the real embedding with the `_even` prox
    modes, decode — must land at the complex f64 engine's fixed point."""
    from admmsolver_tpu import realify_model
    from admmsolver_tpu.models.realify import decode, encode
    from admmsolver_tpu import SimpleOptimizer

    rng = np.random.RandomState(11)
    M, N, B = 24, 64, 4
    A = rng.randn(M, N) + 1j * rng.randn(M, N)
    # real sparse signal: the reference's L1 prox projects its argument
    # to the real part (objectivefunc.py:193-194), so the minimizer's
    # sparse block is real-valued — only real signals are recoverable.
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 4, replace=False)] = rng.randn(4)
    ys = xt @ A.T  # complex data

    model = _bp(A, ys[0], alpha=0.05)
    re = realify_model(model)
    fs = FusedTwoBlockSolver(re.model)
    assert fs.prox == "l1_even"
    assert fs.thin  # embedded wide A keeps the thin-spectral kernel
    ys_enc = np.stack([np.asarray(encode(y)) for y in ys])

    # strict short-horizon parity vs the f32 engine on the same
    # realified model (the oracle)
    rf = fs.solve({(0, "y"): ys_enc}, niter=21)
    rb = BatchedSolver(re.model).solve({(0, "y"): ys_enc}, niter=21,
                                       dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=5e-4)

    # long horizon: same neighborhood as the f32 engine on the realified
    # model (some lanes converge slowly in f32 — at 1501 iterations the
    # f32 engine itself can sit ~1e-1 from the f64 fixed point, so the
    # f64 complex engine is not the right long-horizon oracle here; the
    # f64-realified == complex-trajectory identity is covered at 1e-12
    # by tests/test_realify.py)
    rf = fs.solve({(0, "y"): ys_enc}, niter=1501, rtol=1e-7)
    rb = BatchedSolver(re.model).solve({(0, "y"): ys_enc}, niter=1501,
                                       rtol=1e-7, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(rf.x0), np.asarray(rb.x[0]),
                               atol=1e-2)
    # Im lanes of the separable block are exactly zero
    assert np.all(np.asarray(rf.x1)[:, 1::2] == 0)
    # decoded solutions recover the planted complex signal
    for b in range(B):
        got = np.asarray(decode(rf.x0[b]))
        assert np.abs(got - xt[b]).max() <= 5e-2 * np.abs(xt[b]).max()


def test_fused_two_block_rejects_unsupported_overrides():
    """Per-instance fields the kernel does not plumb must raise (round-4
    advisor): a (0,'A') override would silently solve the template."""
    A, ys, _ = _setup()
    B, N = ys.shape[0], A.shape[1]
    model = Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N)],
                  [(1, 0, identity(N), identity(N))])
    fs = FusedTwoBlockSolver(model)
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve({(0, "y"): ys,
                  (0, "A"): np.zeros((B,) + A.shape)}, niter=5)
    with pytest.raises(ValueError, match="leading batch axis"):
        fs.solve({(1, "alpha"): 0.1}, batch_size=B, niter=5)


def test_spm_chunk_matches_numpy_lane_loop():
    """The SpM chunk (feature-major, whole batch) against the iteration
    chain written lane by lane in NumPy f64, at a small size."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from admmsolver_tpu.models.applications import (spm_model,
                                                    synthetic_spm_data)
    from admmsolver_tpu.ops.kernels import fused_spm_chunk
    from admmsolver_tpu.parallel import FusedSpMSolver

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=7, nw=15)
    gs = np.asarray(g)[None, :] + 1e-4 * np.random.RandomState(0).randn(
        5, np.size(g))
    fs = FusedSpMSolver(spm_model(s, np.asarray(g), prj_sum, prj_w,
                                  alpha_l1=1e-3))
    args = [jnp.asarray(a, jnp.float64) for a in cs.chunk_inputs(fs, gs)]
    out = fused_spm_chunk(*args, n_iters=12)
    want = cs.numpy_spm_chunk(args, range(5), 12)
    for a, b in zip(out, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-10,
                                   atol=1e-13)


def test_two_block_chunk_carries_previous_iterate():
    """fused_two_block_chunk returns (x0, x1, h, x0_prev): x0_prev is
    the block-0 iterate one step before the end."""
    from admmsolver_tpu.ops.kernels import fused_two_block_chunk

    rng = np.random.RandomState(1)
    N, B = 6, 3
    U = jnp.asarray(np.linalg.qr(rng.randn(N, N))[0], jnp.float32)
    args = (U, U.T, jnp.full((B, N), 0.5, jnp.float32),
            jnp.asarray(rng.randn(B, N), jnp.float32),
            jnp.ones((B, 1), jnp.float32),
            jnp.full((B, 1), 0.1, jnp.float32))
    z = jnp.zeros((B, N), jnp.float32)
    a = fused_two_block_chunk(*args, z, z, z, n_iters=4)
    b = fused_two_block_chunk(*args, z, z, z, n_iters=3)
    np.testing.assert_array_equal(np.asarray(a[3]), np.asarray(b[0]))
