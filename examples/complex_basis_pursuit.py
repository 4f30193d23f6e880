"""Complex compressed sensing in real arithmetic.

The reference solver is complex128-first (``optimizer.py:151,159``).
``realify_model`` maps the complex model to an exactly
trajectory-isomorphic real model (interleaved Re/Im lanes,
``models/realify.py``), which then runs on any solver — here both the f64
engine and, batched over a λ-sweep, the real-only fused f32 solver.
"""
import os

import numpy as np

from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                            SimpleOptimizer, identity, realify_model)
from admmsolver_tpu.models.realify import encode
from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    rng = np.random.RandomState(0)
    M, N, K = (16, 64, 3) if small else (64, 256, 8)
    niter = 300 if small else 2000
    nlam = 4 if small else 8
    A = rng.randn(M, N) + 1j * rng.randn(M, N)
    # the reference L1 prox projects onto real vectors
    # (objectivefunc.py:193-194): recoverable signals are real-valued
    x_true = np.zeros(N)
    x_true[rng.choice(N, K, replace=False)] = rng.randn(K)
    y = A @ x_true  # complex measurements

    model = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(0.05, N)],
        [(1, 0, identity(N), identity(N))])
    re = realify_model(model)

    # exact complex trajectory through the f64 engine
    opt = SimpleOptimizer(re.model)
    opt.solve(niter, rtol=1e-10)
    x = np.asarray(re.decode_x(opt.x)[0])
    print(f"f64 engine:  max|x - x_true| = {np.abs(x - x_true).max():.2e}")

    # batched lambda-sweep through the fused f32 chunk solver
    lams = np.logspace(-0.5, -2, nlam)
    fs = FusedTwoBlockSolver(re.model)
    ys = np.broadcast_to(np.asarray(encode(y)), (nlam, 2 * M))
    r = fs.solve({(0, "y"): np.array(ys), (1, "alpha"): lams},
                 niter=niter, rtol=1e-7)
    xs = np.asarray(r.x0).reshape(nlam, N, 2)[..., 0]  # Re lanes
    errs = np.abs(xs - x_true).max(axis=1)
    for lam, e in zip(lams, errs):
        print(f"fused kernel λ={lam:7.4f}: max err {e:.2e}")


if __name__ == "__main__":
    main()
