"""Benchmark: batched ADMM throughput on basis pursuit vs the reference.

    python bench.py

Workload: BASELINE.json config #1 — basis pursuit with dense A (256x512),
two-block ADMM (LeastSquares + L1), the reference's headline notebook
(``notebooks/basis_pursuit.ipynb``).  A batch of independent instances
is solved in one compiled graph on one GPU, and the run reports
**instance-iterations per second**.  It fails when JAX finds no GPU.

``vs_baseline`` = our throughput / the reference implementation's
single-instance NumPy throughput (the reference has no parallelism —
SURVEY.md §2.2 — so its single-instance rate is its throughput).  The
denominator is pinned in ``BASELINE.json["measured"]`` (a CPU rate of the
NumPy reference, median of 7 repeats).

Prints the card (``device_kind``, ``nvidia-smi`` name and power limit) and
then exactly one JSON line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _make_problem(M, N, B, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xtrue = np.zeros((B, N))
    for b in range(B):
        idx = rng.choice(N, 20, replace=False)
        xtrue[b, idx] = rng.randn(20)
    ys = xtrue @ A.T
    return A, ys, xtrue


def bench_batched(A, ys, xtrue, niter, dtype_name="float64", repeats=3):
    import jax
    import jax.numpy as jnp

    from admmsolver_tpu import L1Regularizer, LeastSquares, Model, identity
    from admmsolver_tpu.parallel import BatchedSolver

    dtype = jnp.dtype(dtype_name)
    N = A.shape[1]
    model = Model(
        [LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N)],
        [(1, 0, identity(N), identity(N))])
    bs = BatchedSolver(model, dtype=dtype)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}

    # rtol=0 -> no early exit; fixed-iteration throughput measurement.
    kw = dict(niter=niter, rtol=0.0, record_residuals=False)
    res = bs.solve(ov, **kw)  # compile + run (warmup, identical call)
    jax.block_until_ready(res.x)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = bs.solve(ov, **kw)
        jax.block_until_ready(res.x)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    # Recovery gate: the measured run must actually recover the sparse
    # signal (the reference's own anchor: max|x - x*| <= 1e-2 * max|x*|,
    # reference test/test_optimizer.py:77-82).  A solver diverging to
    # finite garbage must NOT post a throughput headline.
    err = float(np.abs(np.asarray(res.x[0], np.float64) - xtrue).max())
    thr = 1e-2 * float(np.abs(xtrue).max())
    assert err < thr, (
        f"bench solution failed recovery: max err {err:.3e} >= {thr:.3e}")
    return ys.shape[0] * niter / dt, dt


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX reports {dev.platform!r}")
    sys.path.insert(0, ROOT)
    from admmsolver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {dev.device_kind} | {card}", flush=True)

    M, N, B = 256, 512, 4096
    niter = 200
    A, ys, xtrue = _make_problem(M, N, B)
    ours_ips, dt = bench_batched(A, ys, xtrue, niter)

    with open(os.path.join(ROOT, "BASELINE.json")) as f:
        pinned = json.load(f).get("measured", {}).get(
            "reference_cpu_single_instance_iters_per_s")
    vs = (ours_ips / pinned) if pinned else None
    print(json.dumps({
        "metric": "batched ADMM instance-iterations/s on one GPU "
                  f"(basis pursuit {M}x{N}, batch {B}, float64; reference "
                  "baseline = its single-instance NumPy iters/s on a CPU, "
                  "pinned in BASELINE.json)",
        "value": ours_ips,
        "unit": "instance-iters/s",
        "seconds": dt,
        "vs_baseline": vs,
        "ref_iters_per_s_pinned": pinned,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": card,
    }))


if __name__ == "__main__":
    main()
