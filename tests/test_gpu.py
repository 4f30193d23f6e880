"""Checks that need an NVIDIA GPU; they skip elsewhere.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_default_f32_product_is_not_full_precision_on_gpu(gpu):
    """The hazard the precision pins guard against: an f32 product at
    DEFAULT precision runs in TF32 on the card, HIGHEST does not."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    a = rng.randn(256, 256).astype(np.float32)
    b = rng.randn(256, 256).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    A, Bm = jax.device_put(a, gpu), jax.device_put(b, gpu)
    hi = np.asarray(jnp.matmul(A, Bm, precision=jax.lax.Precision.HIGHEST))
    lo = np.asarray(jnp.matmul(A, Bm))
    err = lambda x: np.abs(x - exact).max() / np.abs(exact).max()
    assert err(hi) < 1e-5
    assert err(lo) > 10 * err(hi)


def test_f32_basis_pursuit_matches_f64_on_gpu(gpu):
    """An f32-state solve on the card lands within the f32 floor of the
    f64 solve (it would not with TF32 products)."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import basis_pursuit_model
    from admmsolver_tpu.parallel import BatchedSolver

    rng = np.random.RandomState(1)
    A = rng.randn(64, 128)
    xt = np.zeros((16, 128))
    for b in range(16):
        xt[b, rng.choice(128, 5, replace=False)] = rng.randn(5)
    ys = xt @ A.T
    model = basis_pursuit_model(A, ys[0])
    kw = dict(niter=2000, rtol=0.0, mu0=10.0, relax=1.8,
              record_residuals=False)
    x64 = np.asarray(BatchedSolver(model, dtype=jnp.float64).solve(
        {(0, "y"): ys}, **kw).x[0])
    x32 = np.asarray(BatchedSolver(model, dtype=jnp.float32).solve(
        {(0, "y"): ys.astype(np.float32)}, **kw).x[0], np.float64)
    assert np.abs(x32 - x64).max() <= 1e-3 * np.abs(xt).max()
