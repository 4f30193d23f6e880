"""``chip_smoke.py`` on the CPU: the script refuses to run without a GPU,
and each phase function works at a tiny size."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY_BP = dict(B=6, M=12, N=24, K=2, niter=4000, niter32=1500,
               ref_lanes=3)


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _no_result(proc):
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    return '"ok"' not in last


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_fails_without_gpu(args):
    proc = _run_script(ROOT, *args)
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "no GPU" in proc.stderr


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc)


def test_require_gpu_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu()


def test_lasso_reference_matches_batched_solver():
    """The script's NumPy oracle and the package agree on a small batch
    (both solved to convergence)."""
    import jax.numpy as jnp

    from admmsolver_tpu.models.applications import basis_pursuit_model
    from admmsolver_tpu.parallel import BatchedSolver

    A, ys, xt = cs.bp_problem(4, 20, 40, 3, seed=3)
    bs = BatchedSolver(basis_pursuit_model(A, ys[0]), dtype=jnp.float64)
    res = bs.solve({(0, "y"): jnp.asarray(ys)}, niter=20000, rtol=0.0,
                   atol=1e-12, mu0=10.0, relax=1.8,
                   record_residuals=False)
    assert np.asarray(res.converged).all()
    xref = cs.lasso_reference(A, ys, 0.1)
    np.testing.assert_allclose(np.asarray(res.x[0]), xref, rtol=0,
                               atol=1e-8 * np.abs(xref).max())


def test_lasso_reference_kkt():
    """The oracle's answer satisfies the LASSO optimality conditions."""
    A, ys, _ = cs.bp_problem(2, 10, 30, 2, seed=4)
    alpha = 0.3
    X = cs.lasso_reference(A, ys, alpha)
    for x, y in zip(X, ys):
        g = 2.0 * A.T @ (y - A @ x)
        on = x != 0
        np.testing.assert_allclose(g[on], alpha * np.sign(x[on]),
                                   atol=1e-9)
        assert np.abs(g[~on]).max() <= alpha * (1 + 1e-9)


def test_phase_bp64_and_bp32_tiny():
    out, prev = cs.phase_bp64(TINY_BP)
    assert out["converged_fraction"] == 1.0
    assert out["max_err_vs_numpy_ref"] <= out["tol_vs_numpy_ref"]
    assert len(out["memory"]) == 1
    json.dumps(out)
    out32, ok = cs.phase_bp32(prev, TINY_BP)
    assert ok, out32
    assert out32["max_err_vs_f64"] <= out32["tol"]


def test_phase_bp32_catches_a_wrong_solution():
    out, (A, ys, xt, x64) = cs.phase_bp64(TINY_BP)
    wrong = x64 + 2 * cs.TOL_F32 * np.abs(xt).max()
    _, ok = cs.phase_bp32((A, ys, xt, wrong), TINY_BP)
    assert not ok


@pytest.fixture(scope="module")
def tiny_spm():
    return cs.phase_spm(dict(B=6, nl=8, nw=20, niter=900))


def test_phase_spm_tiny(tiny_spm):
    out, (fs, gs) = tiny_spm
    assert out["max_dev_fused_vs_engine"] <= out["tol"]
    assert out["engine_min_rho"] >= 0.0 and out["fused_min_rho"] >= 0.0


def test_phase_spm_chunk_tiny(tiny_spm):
    _, (fs, gs) = tiny_spm
    out = cs.phase_spm_chunk(fs, gs, dict(n_iters=7))
    assert out["max_err_vs_numpy"] <= out["tol"]
    assert (out["nl"], out["nw"]) == (8, 20)


def test_numpy_spm_chunk_catches_a_wrong_term(tiny_spm):
    """The NumPy oracle disagrees with a chunk whose factor is wrong."""
    import jax.numpy as jnp

    from admmsolver_tpu.ops.kernels import fused_spm_chunk

    _, (fs, gs) = tiny_spm
    args = cs.chunk_inputs(fs, gs)
    good = cs.numpy_spm_chunk(args, [0, 3], 5)
    bad = list(args)
    bad[2] = 1.1 * bad[2]
    out = fused_spm_chunk(*bad, n_iters=5)
    err = max(float(np.abs(np.asarray(a)[:, [0, 3]] - b).max())
              for a, b in zip(out, good))
    scale = max(float(np.abs(b).max()) for b in good)
    assert err > cs.TOL_CHUNK * scale


def test_phase_prox_tiny():
    out = cs.phase_prox(dict(sdp_B=2, sdp_k=3, sdp_rest=2, sdp_niter=20,
                             rpca_B=3, rpca_m=10, rpca_n=8, rpca_rank=1,
                             rpca_niter=800, rpca_ref_lanes=3))
    assert out["sdp"]["min_eigenvalue"] > -1e-8
    assert out["rpca"]["max_err_vs_numpy_ref"] <= out["rpca"]["tol"]


def test_rpca_reference_separates_low_rank_and_sparse():
    rng = np.random.RandomState(5)
    L0 = rng.randn(20, 2) @ rng.randn(2, 16)
    S0 = np.zeros((20, 16))
    mask = rng.rand(20, 16) < 0.06
    S0[mask] = 5.0 * rng.randn(mask.sum())
    L = cs.rpca_reference(L0 + S0, 1.0 / np.sqrt(20))
    assert np.abs(L - L0).max() < 0.15 * np.abs(L0).max()


def test_phase_four_on_virtual_devices():
    """The four-card phase on four of the suite's virtual CPU devices."""
    out = cs.phase_four(dict(B=8, M=8, N=16, K=2, niter=4000, rs_M=6,
                             rs_N=32, rs_K=2, rs_niter=50))
    assert sorted(out["lanes_per_device"].values()) == [2, 2, 2, 2]
    assert out["rowshard"]["features_per_device"] == [8, 8, 8, 8]
    assert out["max_dev_sharded_vs_single"] <= out["tol"]
