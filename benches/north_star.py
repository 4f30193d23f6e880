"""North-star demonstration (BASELINE.json): >= 10,000 batched ADMM
instances converged to 1e-10 residual on basis pursuit, one chip.

Solves B=10240 independent 256x512 basis-pursuit instances in one
compiled graph with per-lane early exit at an absolute primal+dual
residual of 1e-10 (float64), and reports wall time, convergence fraction
and iteration statistics as one JSON line.

The multi-card side of the north star (batch sharding over four GPUs) is
``python chip_smoke.py --four``.  ``--cpu`` forces the CPU backend (small
default batch) as a rehearsal; its output says ``cpu``.  Without ``--cpu`` the script fails
when JAX finds no GPU.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    if "--cpu" in sys.argv[1:]:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from admmsolver_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and "--cpu" not in sys.argv[1:]:
        sys.exit(f"north_star.py needs a GPU (or --cpu for a rehearsal); "
                 f"JAX reports {dev.platform!r}")
    enable_compile_cache()

    from admmsolver_tpu.models.applications import basis_pursuit_model
    from admmsolver_tpu.parallel import BatchedSolver

    B = 1024 if "--cpu" in sys.argv[1:] else 10240
    M, N, K = 256, 512, 20
    tol, niter = 1e-10, 20000

    rng = np.random.RandomState(0)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, K, replace=False)] = rng.randn(K)
    ys = xt @ A.T

    bs = BatchedSolver(basis_pursuit_model(A, ys[0]), dtype=jnp.float64)
    ov = {(0, "y"): jnp.asarray(ys)}
    # Strided residual recording: one sample per 50 iterations.  Full
    # per-iteration histories at this scale would be 2 x (10240, 20000)
    # f64 = 3.3 GB; the stride keeps it at 66 MB while
    # still recording every lane's convergence curve.
    #
    # Recipe (round 5): over-relaxation 1.8 + mu0=10 with the adaptive
    # schedule — measured median 1095 iterations to 1e-10 vs 1414 for
    # the round-1 default (mu0=1, relax off), identical solutions
    # (relaxation preserves fixed points exactly; tests/test_optimizer
    # TestOverRelaxation).  ``--plain`` runs the round-1 recipe for A/B.
    kw = dict(niter=niter, rtol=0.0, atol=tol, record_residuals=50,
              mu0=10.0, relax=1.8)
    if "--plain" in sys.argv[1:]:
        kw.update(mu0=1.0, relax=1.0)

    # Warm with the IDENTICAL call: cfg.niter is a static jit key, so a
    # tiny-horizon warmup compiles a DIFFERENT program and the measured
    # run would pay the (cached-)compile fetch + allocation itself —
    # that fixed cost masked a 22% iteration-count win in the round-5
    # relax A/B before this fix.
    warm = bs.solve(ov, **kw)
    jax.block_until_ready(warm.x)

    t0 = time.perf_counter()
    res = bs.solve(ov, **kw)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0

    iters = np.asarray(res.iterations)
    conv = np.asarray(res.converged)
    err = float(np.max(np.abs(np.asarray(res.x[0]) - xt)))
    # recorded (strided) residual curves: every converged lane's last
    # finite sample must be near the stop tolerance
    pb = np.asarray(res.primal_residual)
    hist_bytes = pb.nbytes * 2
    print(json.dumps({
        "metric": f"time for {B} basis-pursuit instances to {tol:g} "
                  "absolute primal+dual residual (float64, 1 chip)",
        "backend": dev.platform, "kind": dev.device_kind,
        "seconds": round(dt, 2),
        "converged_fraction": round(float(conv.mean()), 4),
        "iterations_median": int(np.median(iters)),
        "iterations_max": int(iters.max()),
        "instances_per_minute": round(B * conv.mean() / (dt / 60.0), 1),
        "max_err_vs_truth": err,
        "residual_history_mb": round(hist_bytes / 1e6, 1),
        "residual_samples_per_lane": int(pb.shape[1]),
    }))


if __name__ == "__main__":
    main()
