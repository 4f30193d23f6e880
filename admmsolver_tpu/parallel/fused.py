"""Fused fast path for 2-block identity-coupled problems.

Drives :func:`admmsolver_tpu.ops.kernels.fused_two_block_chunk`: each
chunk runs ``interval_update_mu`` iterations with the penalties frozen;
between chunks an XLA step computes residuals, the
convergence predicate, and the adaptive penalty update (the same
residual-balancing rule as the engine, reference ``optimizer.py:277-299``),
then refreshes the spectral denominators — penalty updates and
factorization refresh stay a static schedule, now at chunk granularity.

Scope: ``Model([LeastSquares-like spectral block, L1 or NonNegative],
[(1, 0, c·I, c·I)])`` in float32.  Everything else uses
:class:`~admmsolver_tpu.parallel.batch.BatchedSolver`.  Convergence is
checked once per chunk (not per iteration as the reference does) — lanes
may run up to one chunk longer than strictly needed; solutions are
unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.objectivefunc import (L1Regularizer, NonNegativePenalty,
                                    _ShiftedQuadratic)
from ..models.realify import RealPartProx
from ..models.problem import Model
from ..ops.kernels import fused_two_block_chunk
from ..ops import linop
from ..ops.linop import ScaledIdentityMatrix, _concrete

__all__ = ["FusedTwoBlockSolver", "FusedResult"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FusedResult:
    x0: jnp.ndarray
    x1: jnp.ndarray
    h: jnp.ndarray
    mu: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    primal_residual: jnp.ndarray  # (B, nchunks) per-chunk samples
    dual_residual: jnp.ndarray


def _is_identity_si(E) -> bool:
    return (isinstance(E, ScaledIdentityMatrix) and E.is_square()
            and np.allclose(np.asarray(E.coeff), 1.0))


# The per-instance fields the fused kernels actually plumb.  Anything
# else (e.g. the engine's per-instance ``(0, 'A')`` operators or L1
# ``offset``s) would silently solve the TEMPLATE problem and return
# wrong results flagged converged — reject it up front.
_FUSED_OV_KEYS = frozenset({(0, "y"), (0, "alpha"), (1, "alpha")})


def _check_fused_overrides(overrides, path: str) -> int:
    """Validate fused-path override keys and return the batch size.

    Mirrors ``BatchedSolver._validate_overrides``'s batch-axis checks but
    against the fused kernels' supported set; returns None for empty
    overrides (caller falls back to ``batch_size``)."""
    bad = sorted(set(overrides) - _FUSED_OV_KEYS, key=repr)
    if bad:
        raise ValueError(
            f"{path} supports per-instance overrides "
            f"{sorted(_FUSED_OV_KEYS)} only, got {bad}; use "
            "BatchedSolver for other per-instance fields")
    B = None
    for key, v in overrides.items():
        if np.ndim(v) < 1:
            raise ValueError(
                f"override {key} must have a leading batch axis, got a "
                "scalar; wrap per-instance scalars as a (B,) array")
        b = np.shape(v)[0]
        if B is None:
            B = b
        elif B != b:
            raise ValueError(
                f"inconsistent batch sizes: {B} vs {b} for override {key}")
    return B


class FusedTwoBlockSolver:
    """Chunk-scheduled solver for the flagship 2-block family.

    .. note:: Prefer :class:`~admmsolver_tpu.parallel.batch.BatchedSolver`
       for 2-block problems: each iteration is two batched GEMMs either
       way, and this class only moves the residual checks and penalty
       updates to chunk boundaries.  It stays as an oracle-tested
       alternative and as the chunk-schedule scaffolding that
       :class:`~admmsolver_tpu.parallel.fused_spm.FusedSpMSolver` shares.
    """

    def __init__(self, model: Model) -> None:
        assert model.num_func == 2, "fused path covers 2-block models"
        assert model.pairs == [(1, 0)], "blocks must be coupled"
        E10, E01 = model.E[(1, 0)], model.E[(0, 1)]
        if not (_is_identity_si(E10) and _is_identity_si(E01)):
            raise ValueError(
                "fused path requires identity couplings; use BatchedSolver")
        f0, f1 = model.functions
        if not (isinstance(f0, _ShiftedQuadratic) and f0._spectral_ok()):
            raise ValueError(
                "block 0 must be a dense-Gram quadratic (LeastSquares/L2)")
        # Realified complex models (models.realify) wrap the separable
        # block in RealPartProx — same elementwise prox on the Re lanes,
        # zeros on the Im lanes (the `_even` kernel modes).
        f1_inner, suffix = f1, ""
        if isinstance(f1, RealPartProx):
            f1_inner, suffix = f1._inner, "_even"
        if isinstance(f1_inner, L1Regularizer):
            if f1_inner._offset is not None:
                raise ValueError(
                    "fused path does not support L1Regularizer offsets "
                    "(the kernel applies the plain soft-threshold); use "
                    "BatchedSolver")
            self.prox = "l1" + suffix
        elif isinstance(f1_inner, NonNegativePenalty):
            self.prox = "nonneg" + suffix
        else:
            raise ValueError(
                "block 1 must be L1 or NonNegative (optionally realified), "
                f"got {type(f1_inner).__name__}")
        self._f1_inner = f1_inner
        self.model = model
        self.f0 = f0

        thin = f0._get_eig_thin()
        if thin is not False:
            # Thin rank-R basis of a wide data matrix — the engine's
            # `_get_eig_thin` path.  Same algebra as BatchedSolver's
            # solve, and the per-iteration matmuls shrink from (B,N)x(N,N)
            # to (B,N)x(N,R): for basis pursuit (M=100, N=1000) that is
            # ~8x fewer FLOPs.
            lam, U = thin
        else:
            lam, U = f0._get_eig()
        lam = np.asarray(lam)
        U = np.asarray(U)
        if np.iscomplexobj(U):
            if np.abs(U.imag).max() > 0:
                raise ValueError(
                    "fused path is real-f32 only; wrap complex models with "
                    "admmsolver_tpu.realify_model first")
            U = U.real
        self.thin = thin is not False
        self.N = U.shape[0]
        self.lam = jnp.asarray(lam, dtype=jnp.float32)
        self.U = jnp.asarray(U, dtype=jnp.float32)
        self.Ut = jnp.asarray(U.T.copy(), dtype=jnp.float32)

    def _build_step(self, n_iters: int):
        lam, U, Ut = self.lam, self.U, self.Ut
        prox, thin = self.prox, self.thin

        def step(state, acy, alpha_ls, alpha1, tols, knobs, do_mu):
            x0, x1, h, mu, done, count = state
            rtol, atol = tols
            fact_incr, th_change, max_mu = knobs
            dinv = 1.0 / (alpha_ls[:, None] * lam[None, :] + mu)
            if thin:
                dinv = dinv - 1.0 / mu
            if prox.startswith("l1"):
                thr = 0.5 * alpha1[:, None] / mu
            else:
                thr = jnp.zeros_like(mu)
            x0n, x1n, hn, x0p = fused_two_block_chunk(
                U, Ut, dinv, acy, mu, thr, x0, x1, h,
                n_iters=n_iters, prox=prox, thin=thin)
            active = jnp.logical_not(done)
            am = active[:, None]
            x0n = jnp.where(am, x0n, x0)
            x1n = jnp.where(am, x1n, x1)
            hn = jnp.where(am, hn, h)

            # residuals of the chunk's final iteration (engine
            # semantics: pair (1,0), E both identity)
            pn = jnp.linalg.norm(x0n - x1n, axis=1)
            dn = mu[:, 0] * jnp.linalg.norm(x0n - x0p, axis=1)
            n0 = jnp.linalg.norm(x0n, axis=1)
            n1 = jnp.linalg.norm(x1n, axis=1)
            d1 = mu[:, 0] * n0
            d2 = mu[:, 0] * jnp.linalg.norm(x0p, axis=1)
            conv = ((pn / jnp.maximum(n0, n1) < rtol) &
                    (dn / jnp.maximum(d1, d2) < rtol))
            conv = conv | ((pn < atol) & (dn < atol))
            done_new = done | (active & conv)

            # residual-balancing penalty update (chunk-granular)
            mu1 = mu[:, 0]
            mu_new = jnp.where(pn > th_change * dn, mu1 * fact_incr, mu1)
            mu_new = jnp.where(dn > th_change * pn, mu_new / fact_incr,
                               mu_new)
            mu_new = jnp.minimum(mu_new, max_mu)
            upd = do_mu & active & jnp.logical_not(done_new)
            mu_out = jnp.where(upd, mu_new, mu1)[:, None]

            count = count + active.astype(count.dtype) * n_iters
            state = (x0n, x1n, hn, mu_out, done_new, count)
            return state, (pn, dn)

        return step

    def _compiled_run(self, niter: int, interval: int):
        """Full solve as ONE jitted call: iteration-0 chunk, a
        while_loop of full chunks with early exit, then a remainder
        chunk.  Dispatching chunks from Python would cost a host round
        trip per chunk."""
        cached = getattr(self, "_run_cache", None)
        if cached is None:
            cached = self._run_cache = {}
        key = (niter, interval)
        if key in cached:
            return cached[key]

        nfull = (niter - 1) // interval
        nrem = (niter - 1) % interval
        nchunks = 1 + nfull + (1 if nrem else 0)
        step1 = self._build_step(1)
        stepI = self._build_step(interval) if nfull else None
        stepR = self._build_step(nrem) if nrem else None

        def run(x0a, x1a, ha, mu, acy, alpha_ls, alpha1, tols, knobs,
                done0):
            B = mu.shape[0]
            state = (x0a, x1a, ha, mu, done0, jnp.zeros(B, jnp.int32))
            pbuf = jnp.full((nchunks, B), jnp.nan, jnp.float32)
            dbuf = jnp.full((nchunks, B), jnp.nan, jnp.float32)

            state, (pn, dn) = step1(state, acy, alpha_ls, alpha1,
                                    tols, knobs, jnp.array(True))
            pbuf = pbuf.at[0].set(pn)
            dbuf = dbuf.at[0].set(dn)

            if nfull:
                def cond(c):
                    k, state, pb, db = c
                    return (k < nfull) & jnp.logical_not(
                        jnp.all(state[4]))

                def body(c):
                    k, state, pb, db = c
                    state, (pn, dn) = stepI(state, acy, alpha_ls,
                                            alpha1, tols, knobs,
                                            jnp.array(True))
                    pb = pb.at[1 + k].set(pn)
                    db = db.at[1 + k].set(dn)
                    return (k + 1, state, pb, db)

                _, state, pbuf, dbuf = jax.lax.while_loop(
                    cond, body,
                    (jnp.array(0, jnp.int32), state, pbuf, dbuf))
            if nrem:
                def last(c):
                    state, pb, db = c
                    state, (pn, dn) = stepR(state, acy, alpha_ls,
                                            alpha1, tols, knobs,
                                            jnp.array(False))
                    pb = pb.at[nchunks - 1].set(pn)
                    db = db.at[nchunks - 1].set(dn)
                    return (state, pb, db)

                state, pbuf, dbuf = jax.lax.cond(
                    jnp.all(state[4]), lambda c: c, last,
                    (state, pbuf, dbuf))
            return state, pbuf, dbuf

        cached[key] = jax.jit(run)
        return cached[key]

    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              niter: int = 10000,
              mu0=1.0,
              interval_update_mu: int = 100,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              x0=None, x1=None, h0=None, done0=None) -> FusedResult:
        """Solve a batch.  ``overrides``: ``{(0,'y'): (B,M), (0,'alpha'):
        (B,), (1,'alpha'): (B,)}`` subsets, as in BatchedSolver.
        ``done0``: (B,) bool mask of lanes that start converged (never
        iterate) — the scheduler convention BatchedSolver.solve uses."""
        overrides = dict(overrides or {})
        B = _check_fused_overrides(overrides, "FusedTwoBlockSolver")
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError("pass overrides or batch_size")

        def batch_of(key, default, shape1):
            if key in overrides:
                return jnp.asarray(overrides[key], dtype=jnp.float32)
            return jnp.broadcast_to(
                jnp.asarray(default, dtype=jnp.float32), (B,) + shape1)

        f0 = self.f0
        ys = overrides.get((0, "y"))
        if ys is not None:
            # on-device GEMM: ys may already be device-resident
            Ac = jnp.asarray(np.asarray(_concrete(f0._Ac.asmatrix()),
                                        np.float32))
            acy = jnp.matmul(jnp.asarray(ys).astype(jnp.float32), Ac.T,
                             precision=linop.MATMUL_PRECISION)
        else:
            acy1 = jnp.asarray(np.asarray(f0._Acy), dtype=jnp.float32)
            acy = jnp.broadcast_to(acy1, (B, self.N))
        alpha_ls = batch_of((0, "alpha"), float(f0._alpha), ())
        acy = acy * alpha_ls[:, None]
        a1_default = getattr(self._f1_inner, "_alpha", 0.0)
        alpha1 = batch_of((1, "alpha"), float(a1_default or 0.0), ())

        state_of = lambda a: (
            jnp.zeros((B, self.N), dtype=jnp.float32) if a is None
            else jnp.asarray(a, dtype=jnp.float32))
        x0a, x1a, ha = state_of(x0), state_of(x1), state_of(h0)
        if np.ndim(mu0) == 1:
            mu = jnp.asarray(mu0, dtype=jnp.float32)[:, None]
        else:
            mu = jnp.full((B, 1), float(mu0), dtype=jnp.float32)

        tols = (jnp.float32(rtol), jnp.float32(atol))
        knobs = (jnp.float32(fact_incr), jnp.float32(th_change),
                 jnp.float32(max_mu))
        if done0 is None:
            d0 = jnp.zeros(B, dtype=bool)
        else:
            d0 = jnp.asarray(done0, dtype=bool)
            assert d0.shape == (B,), d0.shape

        # reference schedule: penalty update after iterations 0, interval,
        # 2*interval, ... (optimizer.py:319-320); chunk boundaries align
        # with it, remainder chunks skip the update.  The whole chunk
        # loop runs inside ONE jit (see _compiled_run).
        run = self._compiled_run(int(niter), int(interval_update_mu))
        state, pbuf, dbuf = run(x0a, x1a, ha, mu, acy, alpha_ls, alpha1,
                                tols, knobs, d0)

        x0f, x1f, hf, muf, done, count = state
        return FusedResult(
            x0=x0f, x1=x1f, h=hf, mu=muf[:, 0],
            iterations=jnp.minimum(count, niter), converged=done,
            primal_residual=pbuf.T, dual_residual=dbuf.T)
