"""Per-workload benchmarks: the five BASELINE.json configs on one GPU.

``--cpu`` runs them on the CPU instead, as a rehearsal; its output says
``cpu``.  Without ``--cpu`` the script fails when JAX finds no GPU.

Prints one JSON line per config: batched instance-iterations/s, plus a
workload-specific correctness figure so a throughput number can never
hide a broken solve.  ``python benches/bench_workloads.py [config ...]``
with configs from {bp, lasso, spm, spmf, sdp, sdp32, sdp128, rpca,
rpca96, glasso, huber, lpath}; default runs the five BASELINE configs (spmf =
just the fused-mixed SpM row; sdp32/rpca/glasso/huber are the round-4
extended rows, sdp128 the round-5 large-slice row — run them by name).

The headline driver benchmark stays ``bench.py`` (basis pursuit only).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _time_solve(solve, repeats=2):
    import jax
    res = solve()  # compile + warmup (identical call)
    jax.block_until_ready(res.x)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = solve()
        jax.block_until_ready(res.x)
        times.append(time.perf_counter() - t0)
    return res, float(np.median(times))


def _emit(name, B, niter, dt, extra, ref_ips=None):
    import jax

    ours = B * niter / dt
    out = {
        "config": name,
        "platform": jax.devices()[0].platform,
        "batch": B,
        "niter": niter,
        "seconds": round(dt, 4),
        "instance_iters_per_s": round(ours, 1),
        **extra,
    }
    if ref_ips:
        out["ref_iters_per_s"] = round(ref_ips, 2)
        out["vs_baseline"] = round(ours / ref_ips, 1)
    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------
# Reference (SpM-lab/admmsolver, NumPy, on the host CPU) baselines, when
# its source tree is given in ADMMSOLVER_REFERENCE_SRC.  The reference
# has no batching/parallelism (SURVEY.md §2.2): its throughput IS its
# single-instance iteration rate on the same problem.
# ---------------------------------------------------------------------

def _ref_modules():
    src = os.environ.get("ADMMSOLVER_REFERENCE_SRC")
    if not src:
        return None
    sys.path.insert(0, src)
    try:
        import admmsolver.matrix as mat
        import admmsolver.objectivefunc as obj
        import admmsolver.optimizer as opt
    except ImportError:
        return None
    finally:
        sys.path.remove(src)
    import types

    return types.SimpleNamespace(mat=mat, obj=obj, opt=opt)


def _ref_rate(build, niter=30):
    """Single-instance reference iterations/s for a model builder."""
    ref = _ref_modules()
    if ref is None:
        return None
    o = build(ref)
    o.solve(2)  # warm the factorization cache
    t0 = time.perf_counter()
    o.solve(niter, rtol=0.0)
    return niter / (time.perf_counter() - t0)


def _ref_bp(ref, A, y, alpha=0.1):
    N = A.shape[1]
    p = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y), ref.obj.L1Regularizer(alpha, N)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N))])
    return ref.opt.SimpleOptimizer(p)


def _ref_lasso_nn(ref, A, y, alpha):
    N = A.shape[1]
    p = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y), ref.obj.L1Regularizer(alpha, N),
         ref.obj.NonNegativePenalty(N)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N)),
         (2, 0, ref.mat.identity(N), ref.mat.identity(N))])
    return ref.opt.SimpleOptimizer(p)


def _ref_spm(ref, s, g, prj_sum, prj_w, alpha):
    nl, nw = s.size, prj_w.shape[0]
    p = ref.opt.Model(
        [ref.obj.ConstrainedLeastSquares(
            1.0, ref.mat.DiagonalMatrix(-np.asarray(s)), np.asarray(g),
            np.asarray(prj_sum).reshape(1, nl), np.array([1.0])),
         ref.obj.L1Regularizer(alpha, nl),
         ref.obj.NonNegativePenalty(nw)],
        [(0, 1, ref.mat.identity(nl), ref.mat.identity(nl)),
         (0, 2, ref.mat.DenseMatrix(np.asarray(prj_w)),
          ref.mat.identity(nw))])
    return ref.opt.SimpleOptimizer(p, mu=0.1)


def _ref_sdp(ref, A, y, shape, axis):
    N = int(np.prod(shape))
    p = ref.opt.Model(
        [ref.obj.LeastSquares(1.0, A, y),
         ref.obj.SemiPositiveDefinitePenalty(shape, axis)],
        [(1, 0, ref.mat.identity(N), ref.mat.identity(N))])
    return ref.opt.SimpleOptimizer(p)


def bench_bp(dtype):
    """Config 1: basis pursuit, dense A 256x512, two-block."""
    import jax.numpy as jnp
    from admmsolver_tpu.models.applications import basis_pursuit_model
    from admmsolver_tpu.parallel import BatchedSolver

    M, N, B, niter = 256, 512, 1024, 200
    rng = np.random.RandomState(0)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 20, replace=False)] = rng.randn(20)
    ys = xt @ A.T
    bs = BatchedSolver(basis_pursuit_model(A, ys[0]), dtype=dtype)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False))
    err = float(np.max(np.abs(np.asarray(res.x[0], np.float64) - xt)))
    _emit("basis_pursuit", B, niter, dt,
          {"max_err_vs_truth": round(err, 6)},
          ref_ips=_ref_rate(lambda ref: _ref_bp(ref, A, ys[0])))


def bench_lasso(dtype):
    """Config 2: nonnegative elastic-net, three-block with adaptive mu."""
    import jax.numpy as jnp
    from admmsolver_tpu.models.applications import lasso_model
    from admmsolver_tpu.parallel import BatchedSolver

    M, N, B, niter = 256, 512, 512, 200
    rng = np.random.RandomState(1)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 20, replace=False)] = np.abs(rng.randn(20))
    ys = xt @ A.T
    model = lasso_model(A, ys[0], alpha_l1=0.05, nonneg=True)
    bs = BatchedSolver(model, dtype=dtype)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False))
    xs = np.asarray(res.x[2], np.float64)
    _emit("lasso_nonneg_3block", B, niter, dt,
          {"min_x_nonneg_block": round(float(xs.min()), 9)},
          ref_ips=_ref_rate(lambda ref: _ref_lasso_nn(ref, A, ys[0], 0.05)))


def bench_spm(dtype, rows=("engine", "fused")):
    """Config 3: SpM analytic continuation, batched per-frequency data
    (three-block: ConstrainedLS sum rule + L1 + nonneg via projector).

    ``rows`` selects which measurements run (the ``spmf`` CLI config
    reruns just the fused row without paying for the engine row's
    compile)."""
    import jax.numpy as jnp
    from admmsolver_tpu.models.applications import (spm_model,
                                                    synthetic_spm_data)
    from admmsolver_tpu.parallel import BatchedSolver

    B, niter = 4096, 500
    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(
        nl=30, nw=201, noise=1e-5)
    rng = np.random.RandomState(2)
    gs = np.asarray(g)[None, :] + 1e-5 * rng.randn(B, g.size)
    model = spm_model(s, np.asarray(g), prj_sum, prj_w, alpha_l1=1e-4)
    bs = BatchedSolver(model, dtype=dtype)
    ov = {(0, "y"): jnp.asarray(gs, dtype=dtype)}
    ref = _ref_rate(lambda r: _ref_spm(r, s, g, prj_sum, prj_w, 1e-4))
    if "engine" in rows:
        res, dt = _time_solve(lambda: bs.solve(
            ov, mu0=0.1, niter=niter, rtol=0.0, record_residuals=False))
        rho_out = np.asarray(res.x[2], np.float64)
        _emit("spm_per_frequency", B, niter, dt,
              {"min_rho": round(float(rho_out.min()), 9),
               "median_sum_rule_dev": round(
                   float(np.median(np.abs(
                       np.asarray(res.x[0], np.float64)
                       @ np.asarray(prj_sum) - 1.0))), 9)},
              ref_ips=ref)

    # Fused fast path: the f32 chunk solver burns 4/5 of the budget,
    # then the f64 engine polishes from the warm primal/dual/penalty
    # state to reference precision.
    from admmsolver_tpu.parallel import FusedSpMSolver

    if "fused" not in rows:
        return
    fs = FusedSpMSolver(model)
    resf, dtf = _time_solve(lambda: fs.solve_mixed(
        ov, niter_low=4 * niter // 5, niter=niter - 4 * niter // 5,
        mu0=0.1, low_atol=0.0, rtol=0.0, record_residuals=False))
    rho_f = np.asarray(resf.x[2], np.float64)
    _emit("spm_fused_mixed", B, niter, dtf,
          {"min_rho": round(float(rho_f.min()), 9),
           "median_sum_rule_dev": round(
               float(np.median(np.abs(
                   np.asarray(resf.x[0], np.float64) @ np.asarray(prj_sum)
                   - 1.0))), 9)},
          ref_ips=ref)


def bench_sdp(dtype):
    """Config 4: semidefinite-constrained quadratic — batched eigh prox."""
    import jax.numpy as jnp
    from admmsolver_tpu.models.applications import sdp_model
    from admmsolver_tpu.parallel import BatchedSolver

    k, rest, B, niter = 8, 16, 256, 100
    shape = (k, k, rest)
    N = k * k * rest
    M = N // 2
    rng = np.random.RandomState(3)
    A = rng.randn(M, N)
    # PSD ground truth per slice
    xt = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    y = A @ xt.reshape(-1)
    ys = y[None, :] + 1e-4 * rng.randn(B, M)
    model = sdp_model(A, y, shape, axis=2)
    bs = BatchedSolver(model, dtype=dtype)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False,
        recipe="plain"))
    X = np.asarray(res.x[1], np.float64).reshape(B, k, k, rest)
    lam_min = np.linalg.eigvalsh(
        np.moveaxis(X, (1, 2), (-2, -1))).min()
    ref = _ref_rate(lambda ref: _ref_sdp(ref, A, y, shape, 2), niter=20)
    _emit("sdp_psd_prox", B, niter, dt,
          {"min_eigenvalue_psd_block": round(float(lam_min), 9)},
          ref_ips=ref)

    # Mixed-precision recipe: 3/4 of the budget in f32, then an f64
    # polish continuing the same primal/dual/penalty state.  Run at a
    # realistic convergence horizon (4x the short row): the two-phase
    # hand-off has fixed costs (second dispatch + fresh f64 factors).
    nit_m = 4 * niter
    resm, dtm = _time_solve(lambda: bs.solve_mixed(
        ov, niter_low=3 * nit_m // 4, niter=nit_m - 3 * nit_m // 4,
        rtol=0.0, low_rtol=0.0, record_residuals=False))
    Xm = np.asarray(resm.x[1], np.float64).reshape(B, k, k, rest)
    lam_min_m = np.linalg.eigvalsh(
        np.moveaxis(Xm, (1, 2), (-2, -1))).min()
    _emit("sdp_psd_prox_mixed", B, nit_m, dtm,
          {"min_eigenvalue_psd_block": round(float(lam_min_m), 9)},
          ref_ips=ref)


def bench_sdp32(dtype):
    """SDP with k=32 slices: the scan-rolled Jacobi PSD prox vs the
    vmapped XLA-eigh fallback (round-3 ceiling was k <= 16; the
    reference projects any slice size, objectivefunc.py:322-327).
    Emits an A/B pair so the dispatch win is measured, not assumed."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import sdp_model
    from admmsolver_tpu.ops import prox as prox_mod
    from admmsolver_tpu.parallel import BatchedSolver

    k, rest, B, niter = 32, 4, 64, 100
    shape = (k, k, rest)
    N = k * k * rest
    M = N // 2
    rng = np.random.RandomState(6)
    A = rng.randn(M, N)
    xt = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    y = A @ xt.reshape(-1)
    ys = y[None, :] + 1e-4 * rng.randn(B, M)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}
    ref = _ref_rate(lambda ref: _ref_sdp(ref, A, y, shape, 2), niter=10)

    for label, ceil in (("jacobi", 64), ("xla_eigh", 16)):
        old = (prox_mod.JACOBI_MAX_N, prox_mod.JACOBI_MAX_N_F32)
        prox_mod.JACOBI_MAX_N = ceil
        prox_mod.JACOBI_MAX_N_F32 = None
        try:
            model = sdp_model(A, y, shape, axis=2)
            bs = BatchedSolver(model, dtype=dtype)
            res, dt = _time_solve(lambda: bs.solve(
                ov, niter=niter, rtol=0.0, record_residuals=False,
                recipe="plain"), repeats=1)
            X = np.asarray(res.x[1], np.float64).reshape(B, *shape)
            lam_min = np.linalg.eigvalsh(
                np.moveaxis(X, (1, 2), (-2, -1))).min()
            _emit(f"sdp_k32_{label}", B, niter, dt,
                  {"min_eigenvalue_psd_block": round(float(lam_min), 9)},
                  ref_ips=ref)
        finally:
            prox_mod.JACOBI_MAX_N, prox_mod.JACOBI_MAX_N_F32 = old

    # The mixed SDP recipe at k=32: 3/4 of the budget in f32, then an
    # f64 polish.
    nit_m = 4 * niter
    model = sdp_model(A, y, shape, axis=2)
    bs = BatchedSolver(model, dtype=dtype)
    resm, dtm = _time_solve(lambda: bs.solve_mixed(
        ov, niter_low=3 * nit_m // 4, niter=nit_m - 3 * nit_m // 4,
        rtol=0.0, low_rtol=0.0, record_residuals=False), repeats=1)
    Xm = np.asarray(resm.x[1], np.float64).reshape(B, *shape)
    lam_min_m = np.linalg.eigvalsh(
        np.moveaxis(Xm, (1, 2), (-2, -1))).min()
    _emit("sdp_k32_mixed", B, nit_m, dtm,
          {"min_eigenvalue_psd_block": round(float(lam_min_m), 9)},
          ref_ips=ref)


def bench_sdp128(dtype):
    """SDP with 128x128 slices — the round-5 envelope extension
    (previous loop-safe ceiling was k = 64; the reference projects any
    slice size via its per-slice Python loop, objectivefunc.py:322-327).

    Workload: weighted covariance denoising / nearest-PSD-matrix —
    ``min_X ||W^(1/2)(X - Y)||^2 s.t. X >= 0`` per instance, a diagonal
    data operator (keeps the quadratic block O(N) instead of a dense
    16384^2 Gram) so the per-iteration cost IS the in-loop 128x128 PSD
    prox.  A/B: matrix-sign prox vs scan-rolled Jacobi vs the vmapped
    in-loop XLA eigh, plus the mixed recipe."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import covariance_denoise_model
    from admmsolver_tpu.ops import prox as prox_mod
    from admmsolver_tpu.parallel import BatchedSolver

    k, rest, B, niter = 128, 1, 64, 50
    shape = (k, k, rest)
    N = k * k * rest
    rng = np.random.RandomState(15)
    w = 1.0 + rng.rand(N)
    rw = np.sqrt(w)
    Q = rng.randn(k, k)
    xt = (Q @ Q.T / k).reshape(-1)
    ys = xt[None, :] + 0.1 * rng.randn(B, N)
    wys = ys * rw[None, :]   # sqrt(w)-scaled data, matching the model
    ov = {(0, "y"): jnp.asarray(wys, dtype=dtype)}

    def build():
        return covariance_denoise_model(ys[0].reshape(k, k), weights=w)

    def ref_build(ref):
        p = ref.opt.Model(
            [ref.obj.LeastSquares(1.0, ref.mat.DiagonalMatrix(rw), wys[0]),
             ref.obj.SemiPositiveDefinitePenalty(shape, 2)],
            [(1, 0, ref.mat.identity(N), ref.mat.identity(N))])
        return ref.opt.SimpleOptimizer(p)

    ref = _ref_rate(ref_build, niter=10)

    # Three prox paths: sign = the polynomial matrix-sign projection
    # (GEMMs only, any n); jacobi = scan-rolled Jacobi forced; xla_eigh
    # = the in-loop batched eigh (the default above the boundary).
    paths = (("sign", 64, "always"), ("jacobi", 256, False),
             ("xla_eigh", 16, False))
    for label, ceil, use_sign in paths:
        old = (prox_mod.JACOBI_MAX_N, prox_mod.JACOBI_MAX_N_F32,
               prox_mod.USE_SIGN_ABOVE_JACOBI)
        prox_mod.JACOBI_MAX_N = ceil
        prox_mod.JACOBI_MAX_N_F32 = None
        prox_mod.USE_SIGN_ABOVE_JACOBI = use_sign
        try:
            bs = BatchedSolver(build(), dtype=dtype)
            res, dt = _time_solve(lambda: bs.solve(
                ov, niter=niter, rtol=0.0, record_residuals=False,
                recipe="plain"), repeats=1)
            X = np.asarray(res.x[1], np.float64).reshape(B, *shape)
            lam = np.linalg.eigvalsh(np.moveaxis(X, (1, 2), (-2, -1)))
            finite = bool(np.isfinite(np.asarray(res.x[1])).all())
            _emit(f"sdp_k128_{label}", B, niter, dt,
                  {"min_eigenvalue_psd_block": round(float(lam.min()), 9),
                   "finite": finite},
                  ref_ips=ref)
        finally:
            (prox_mod.JACOBI_MAX_N, prox_mod.JACOBI_MAX_N_F32,
             prox_mod.USE_SIGN_ABOVE_JACOBI) = old

    nit_m = 4 * niter
    bs = BatchedSolver(build(), dtype=dtype)
    resm, dtm = _time_solve(lambda: bs.solve_mixed(
        ov, niter_low=3 * nit_m // 4, niter=nit_m - 3 * nit_m // 4,
        rtol=0.0, low_rtol=0.0, record_residuals=False), repeats=1)
    Xm = np.asarray(resm.x[1], np.float64).reshape(B, *shape)
    lamm = np.linalg.eigvalsh(np.moveaxis(Xm, (1, 2), (-2, -1)))
    _emit("sdp_k128_mixed", B, nit_m, dtm,
          {"min_eigenvalue_psd_block": round(float(lamm.min()), 9),
           "finite": bool(np.isfinite(np.asarray(resm.x[1])).all())},
          ref_ips=ref)


def bench_rpca(dtype):
    """Robust PCA: batched nuclear-norm + offset-L1 decomposition, the
    nuclear prox through ``jnp.linalg.svd`` inside the loop.  No
    vs_baseline: the reference cannot express a nuclear-norm block.
    """
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import rpca_model
    from admmsolver_tpu.parallel import BatchedSolver

    m, n, B, niter = 32, 32, 256, 200
    rng = np.random.RandomState(7)
    L0 = rng.randn(B, m, 3) @ rng.randn(3, n)
    Ys = L0.copy()
    mask = rng.rand(B, m, n) < 0.05
    Ys[mask] += 6.0 * rng.randn(int(mask.sum()))
    bs = BatchedSolver(rpca_model(Ys[0]), dtype=dtype)
    ov = {(1, "offset"): jnp.asarray(Ys.reshape(B, -1), dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False,
        recipe="plain"), repeats=1)
    L = np.asarray(res.x[0], np.float64).reshape(B, m, n)
    rel = np.abs(L - L0).max() / np.abs(L0).max()
    sv = np.linalg.svd(L, compute_uv=False)
    rank = int(np.median((sv > 1e-3 * sv[:, :1]).sum(axis=1)))
    _emit("rpca_nuclear", B, niter, dt,
          {"max_rel_err_L": round(float(rel), 4),
           "median_effective_rank": rank, "ref": "inexpressible"})

    # Mixed recipe: 3/4 of the budget with the f32 SVD prox.
    nit_m = 2 * niter
    resm, dtm = _time_solve(lambda: bs.solve_mixed(
        ov, niter_low=3 * nit_m // 4, niter=nit_m - 3 * nit_m // 4,
        rtol=0.0, low_rtol=0.0, record_residuals=False), repeats=1)
    Lm = np.asarray(resm.x[0], np.float64).reshape(B, m, n)
    relm = np.abs(Lm - L0).max() / np.abs(L0).max()
    svm = np.linalg.svd(Lm, compute_uv=False)
    rankm = int(np.median((svm > 1e-3 * svm[:, :1]).sum(axis=1)))
    _emit("rpca_nuclear_mixed", B, nit_m, dtm,
          {"max_rel_err_L": round(float(relm), 4),
           "median_effective_rank": rankm, "ref": "inexpressible"})


def bench_rpca96(dtype):
    """Robust PCA at 96x96 — above the Gram-Jacobi envelope (64): the
    SVD-free polar/sign nuclear prox vs the Gram-eigh route vs the
    library SVD.  No vs_baseline: the reference cannot express a
    nuclear-norm block."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import rpca_model
    from admmsolver_tpu.parallel import BatchedSolver

    m, n, B, niter = 96, 96, 128, 200
    rng = np.random.RandomState(17)
    L0 = rng.randn(B, m, 4) @ rng.randn(4, n)
    Ys = L0.copy()
    mask = rng.rand(B, m, n) < 0.05
    Ys[mask] += 6.0 * rng.randn(int(mask.sum()))
    ov = {(1, "offset"): jnp.asarray(Ys.reshape(B, -1), dtype=dtype)}
    for method in ("sign", "gram", "xla"):
        bs = BatchedSolver(rpca_model(Ys[0], svd_method=method),
                           dtype=dtype)
        res, dt = _time_solve(lambda: bs.solve(
            ov, niter=niter, rtol=0.0, record_residuals=False,
            recipe="plain"), repeats=1)
        L = np.asarray(res.x[0], np.float64).reshape(B, m, n)
        rel = np.abs(L - L0).max() / np.abs(L0).max()
        sv = np.linalg.svd(L, compute_uv=False)
        rank = int(np.median((sv > 1e-3 * sv[:, :1]).sum(axis=1)))
        _emit(f"rpca96_{method}", B, niter, dt,
              {"max_rel_err_L": round(float(rel), 4),
               "median_effective_rank": rank,
               "finite": bool(np.isfinite(L).all()),
               "ref": "inexpressible"})


def bench_group_lasso(dtype):
    """Group lasso (round-3 model family, first hardware row): block-
    sparse recovery, group soft-threshold prox.  No vs_baseline: the
    reference has no group-L1 objective."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import group_lasso_model
    from admmsolver_tpu.parallel import BatchedSolver

    M, N, gs, B, niter = 256, 512, 8, 1024, 200
    rng = np.random.RandomState(8)
    A = rng.randn(M, N)
    xt = np.zeros(N)
    on = rng.choice(N // gs, 6, replace=False)
    for g in on:
        xt[g * gs:(g + 1) * gs] = rng.randn(gs)
    ys = (A @ xt)[None, :] + 0.01 * rng.randn(B, M)
    bs = BatchedSolver(group_lasso_model(A, ys[0], 0.5, gs), dtype=dtype)
    ov = {(0, "y"): jnp.asarray(ys, dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False), repeats=1)
    X = np.asarray(res.x[1], np.float64)
    gn = np.sqrt((X.reshape(B, -1, gs) ** 2).sum(-1))
    active = gn > 1e-3 * np.abs(X).max()
    hit = float((active[:, on].all(axis=1)).mean())
    _emit("group_lasso", B, niter, dt,
          {"support_recovery_rate": round(hit, 3),
           "median_active_groups": int(np.median(active.sum(axis=1))),
           "ref": "inexpressible"})


def bench_huber(dtype):
    """Huber robust regression (round-3 model family, first hardware
    row): outlier-resistant fit through a non-identity A coupling.  No
    vs_baseline: the reference has no Huber objective."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import robust_regression_model
    from admmsolver_tpu.parallel import BatchedSolver

    M, N, B, niter = 256, 128, 1024, 200
    rng = np.random.RandomState(9)
    A = rng.randn(M, N) / np.sqrt(M)
    xt = rng.randn(N)
    ys = (A @ xt)[None, :] + 0.01 * rng.randn(B, M)
    out = rng.rand(B, M) < 0.05
    ys = ys + out * 8.0 * rng.randn(B, M)
    bs = BatchedSolver(robust_regression_model(A, ys[0], delta=0.1),
                       dtype=dtype)
    ov = {(1, "y"): jnp.asarray(ys, dtype=dtype)}
    res, dt = _time_solve(lambda: bs.solve(
        ov, niter=niter, rtol=0.0, record_residuals=False), repeats=1)
    X = np.asarray(res.x[0], np.float64)
    err = float(np.abs(X - xt).max())
    _emit("huber_regression", B, niter, dt,
          {"max_coef_err_under_outliers": round(err, 4),
           "ref": "inexpressible"})


def bench_lpath(dtype):
    """Config 5: warm-started lambda-path sweep, 1024 values."""
    import jax.numpy as jnp
    from admmsolver_tpu.models.applications import basis_pursuit_model
    from admmsolver_tpu.parallel import BatchedSolver

    M, N, nlam, niter = 256, 512, 1024, 100
    rng = np.random.RandomState(4)
    A = rng.randn(M, N)
    xt = np.zeros(N)
    xt[rng.choice(N, 20, replace=False)] = rng.randn(20)
    y = A @ xt
    lams = np.logspace(0, -3, nlam)
    bs = BatchedSolver(basis_pursuit_model(A, y), dtype=dtype)
    res, dt = _time_solve(lambda: bs.solve_path(
        (1, "alpha"), lams, group_size=256, niter=niter, rtol=0.0,
        record_residuals=False), repeats=1)
    err = float(np.max(np.abs(np.asarray(res.x[0][-1], np.float64) - xt)))
    # reference baseline: it solves each lambda as an independent
    # single-instance problem at its basis-pursuit iteration rate
    _emit("lambda_path_1024", nlam, niter, dt,
          {"max_err_at_smallest_lambda": round(err, 6)},
          ref_ips=_ref_rate(lambda ref: _ref_bp(ref, A, y, 0.5)))


def main():
    import jax
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    if "--cpu" in sys.argv[1:]:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from admmsolver_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and "--cpu" not in sys.argv[1:]:
        sys.exit(f"bench_workloads.py needs a GPU (or --cpu for a "
                 f"rehearsal); JAX reports {dev.platform!r}")
    enable_compile_cache()
    dtype = jnp.float64
    names = args or ["bp", "lasso", "spm", "sdp", "lpath"]
    print(json.dumps({"backend": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices()),
                      "dtype": str(dtype.__name__)}), flush=True)
    table = {"bp": bench_bp, "lasso": bench_lasso, "spm": bench_spm,
             "spmf": lambda d: bench_spm(d, rows=("fused",)),
             "sdp": bench_sdp, "sdp32": bench_sdp32,
             "sdp128": bench_sdp128,
             "rpca": bench_rpca, "rpca96": bench_rpca96,
             "glasso": bench_group_lasso,
             "huber": bench_huber, "lpath": bench_lpath}
    for n in names:
        table[n](dtype)


if __name__ == "__main__":
    main()
