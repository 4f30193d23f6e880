"""Every f32 contraction on the solve paths runs at full f32 precision.

On the GPU an f32 product at DEFAULT precision may run in TF32 (about
three decimal digits), which breaks the f32-state solves.  The solvers
pin ``linop.MATMUL_PRECISION``; these tests lower each family's f32
program and check that no ``dot_general`` on f32 operands was left at
DEFAULT.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

from admmsolver_tpu.models.applications import (basis_pursuit_model,
                                                rpca_model, sdp_model,
                                                spm_model,
                                                synthetic_spm_data)
from admmsolver_tpu.parallel import BatchedSolver, FusedSpMSolver

_DOT = re.compile(r"stablehlo\.dot_general.*:\s*\((tensor<[^)]*)\)")


def _unpinned_f32_dots(hlo: str):
    bad = []
    for line in hlo.splitlines():
        m = _DOT.search(line)
        if m and "xf32>" in m.group(1) \
                and "precision = [HIGHEST, HIGHEST]" not in line:
            bad.append(line.strip())
    return bad


def _lowered_steps(solver, call):
    """HLO text of every program ``call`` compiles through
    ``solver._compiled``."""
    seen = []
    factory = solver._compiled

    def capture(*a, **k):
        fn = factory(*a, **k)

        def run(*args):
            seen.append(fn.lower(*args).as_text())
            return fn(*args)
        return run

    solver._compiled = capture
    call()
    assert seen
    return seen


def _bp():
    rng = np.random.RandomState(0)
    A = rng.randn(8, 16)
    ys = rng.randn(3, 8)
    return basis_pursuit_model(A, ys[0]), {(0, "y"): ys}


def _spm():
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=6, nw=9)
    gs = np.asarray(g)[None, :] + 1e-4 * np.random.RandomState(1).randn(
        3, np.size(g))
    return (spm_model(s, np.asarray(g), prj_sum, prj_w, alpha_l1=1e-3),
            {(0, "y"): gs})


def _sdp():
    rng = np.random.RandomState(2)
    shape = (3, 3, 2)
    N = 18
    A = rng.randn(N // 2, N)
    ys = rng.randn(3, N // 2)
    return sdp_model(A, ys[0], shape, axis=2), {(0, "y"): ys}


def _rpca():
    rng = np.random.RandomState(3)
    Ys = rng.randn(3, 4, 5)
    return rpca_model(Ys[0]), {(1, "offset"): Ys.reshape(3, -1)}


@pytest.mark.parametrize("family", ["bp", "spm", "sdp", "rpca"])
def test_f32_engine_contractions_are_pinned(family):
    model, ov = {"bp": _bp, "spm": _spm, "sdp": _sdp,
                 "rpca": _rpca}[family]()
    bs = BatchedSolver(model, dtype=jnp.float32)
    ov = {k: jnp.asarray(v, jnp.float32) for k, v in ov.items()}
    for hlo in _lowered_steps(bs, lambda: bs.solve(
            ov, niter=3, record_residuals=False)):
        assert _unpinned_f32_dots(hlo) == []


def test_f32_fused_spm_contractions_are_pinned():
    """The fused solver's f32 chunks and chunk-boundary residuals."""
    import jax

    model, ov = _spm()
    fs = FusedSpMSolver(model)
    fs.solve(ov, niter=3, mu0=0.1)
    (key, run), = [(k, f) for k, f in fs._run_cache.items()
                   if k[0] == "solve"]
    B = key[3]
    args = (jnp.zeros((B, 6), jnp.float32), jnp.ones(B, jnp.float32),
            jnp.ones(B, jnp.float32), jnp.float32(0.1),
            (jnp.float32(0), jnp.float32(0)),
            (jnp.float32(2), jnp.float32(10), jnp.float32(1e3)),
            jnp.zeros(B, bool))
    hlo = jax.jit(run).lower(*args).as_text()
    assert "dot_general" in hlo
    assert _unpinned_f32_dots(hlo) == []


def test_audit_catches_a_default_precision_product():
    """The audit itself: an unpinned f32 product is reported."""
    import jax

    hlo = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((4, 4), jnp.float32), jnp.ones((4, 4), jnp.float32)
    ).as_text()
    assert len(_unpinned_f32_dots(hlo)) == 1


def test_f32_psd_eigh_path_contractions_are_pinned(monkeypatch):
    """Slices above the Jacobi boundary take batched eigh; the rebuild
    V diag(w) V^T is pinned too."""
    from admmsolver_tpu.ops import prox as prox_mod

    monkeypatch.setattr(prox_mod, "JACOBI_MAX_N_F32", 2)
    model, ov = _sdp()
    bs = BatchedSolver(model, dtype=jnp.float32)
    ov = {k: jnp.asarray(v, jnp.float32) for k, v in ov.items()}
    for hlo in _lowered_steps(bs, lambda: bs.solve(
            ov, niter=3, record_residuals=False)):
        assert "eigh" in hlo.lower() or "syevd" in hlo.lower()
        assert _unpinned_f32_dots(hlo) == []
