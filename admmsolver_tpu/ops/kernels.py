"""Multi-iteration ADMM chunks for the two fused solver families.

Both chunks run ``n_iters`` ADMM iterations of one fixed family with the
penalties frozen; the drivers (:mod:`admmsolver_tpu.parallel.fused` and
:mod:`admmsolver_tpu.parallel.fused_spm`) evaluate residuals, convergence
and the penalty update between chunks.

**2-block identity-coupled family** (basis pursuit / LASSO / λ-sweeps —
reference ``notebooks/basis_pursuit.ipynb``).  Per iteration (derived from
the engine's sweep, ``optimizer.py`` ``ADMMPlan.sweep``, and verified
against it in ``tests/test_kernels.py``):

    v   = alpha·A†y + h + mu·x1
    x0  = U ((U† v) / (alpha·lam + mu))     # spectral shifted-quadratic
    x1  = prox(x0 - h/mu)                   # soft-threshold or nonneg clip
    h  += mu (x1 - x0)                      # dual ascent

Each iteration is two ``(B, N) x (N, R)`` GEMMs over the whole batch,
which the GPU's BLAS serves directly, so :func:`fused_two_block_chunk` is
a plain ``lax.fori_loop``.

**3-block SpM family**: see the section comment above
:func:`fused_spm_chunk`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import linop

__all__ = ["fused_two_block_chunk", "fused_spm_chunk"]


def _iteration_body(U, Ut, dinv, acy, mu, thr, prox: str, thin: bool,
                    carry):
    x0, x1, h, _ = carry
    hi = linop.MATMUL_PRECISION
    v = acy + h + mu * x1
    w = jnp.dot(v, U, preferred_element_type=jnp.float32,
                precision=hi)  # U† v (U real)
    w = w * dinv
    x0_new = jnp.dot(w, Ut, preferred_element_type=jnp.float32,
                     precision=hi)
    if thin:
        # Thin-spectral form (engine's `_get_eig_thin` path): U holds the
        # r = rank(A†A) eigenvectors of the data range, dinv holds
        # 1/(alpha*lam + mu) - 1/mu, and the null-space response is the
        # closed-form v/mu term.  Same algebra as the XLA engine, so the
        # oracle tests stay comparable in f32.
        x0_new = x0_new + v / mu
    z = x0_new - h / mu
    if prox in ("l1", "l1_even"):
        x1_new = jnp.sign(z) * jnp.maximum(jnp.abs(z) - thr, 0.0)
    elif prox in ("nonneg", "nonneg_even"):
        x1_new = jnp.maximum(z, 0.0)
    else:  # pragma: no cover - guarded at the caller
        raise ValueError(prox)
    if prox.endswith("_even"):
        # Realified complex model (models.realify.RealPartProx): the
        # separable prox acts on the Re (even) interleaved lanes and the
        # minimizer's Im lanes are zero.
        lane = jax.lax.broadcasted_iota(jnp.int32, z.shape, 1)
        x1_new = jnp.where(lane % 2 == 0, x1_new, 0.0)
    h_new = h + mu * (x1_new - x0_new)
    return (x0_new, x1_new, h_new, x0)


@functools.partial(jax.jit, static_argnames=("n_iters", "prox", "thin"))
def fused_two_block_chunk(U, Ut, dinv, acy, mu, thr, x0, x1, h,
                          n_iters: int, prox: str = "l1",
                          thin: bool = False):
    """Run ``n_iters`` ADMM iterations on a batch of 2-block problems.

    Shapes: ``U`` (N, R) / ``Ut`` (R, N) shared f32 eigenbasis — the full
    basis (R = N, ``thin=False``, ``dinv`` = 1/(alpha·lam + mu)) or the
    thin rank-R basis of a wide data matrix (``thin=True``, ``dinv`` =
    1/(alpha·lam + mu) − 1/mu (B, R), null-space handled in closed form);
    ``acy`` = alpha·A†y (B, N); ``mu``/``thr`` (B, 1); state
    ``x0``/``x1``/``h`` (B, N).  Returns (x0, x1, h, x0_prev) where
    ``x0_prev`` is the penultimate iterate (for the dual residual).
    """
    body = functools.partial(_iteration_body, U, Ut, dinv, acy, mu, thr,
                             prox, thin)
    return jax.lax.fori_loop(0, n_iters, lambda t, c: body(c),
                             (x0, x1, h, x0))


# =====================================================================
# Fused 3-block SpM sweep
# =====================================================================
#
# Target regime (BASELINE config #3, the reference's flagship SpM
# workload, notebooks/spm.ipynb cells 10-11): small blocks (nl ~ 30 IR
# coefficients, nw ~ 201 frequencies) and thousands of instances.  One
# iteration is a chain of about ten tiny per-lane operations (two skinny
# GEMMs against the projector, a per-lane nl x nl matvec, two proxes, two
# dual updates).  The chunk runs only that chain: the engine's general
# sweep adds per-iteration residuals, penalty checks and the
# block-elimination solve.
#
# Layout is FEATURE-MAJOR, (feature, batch): the batch is the contiguous
# axis, per-lane elementwise math broadcasts along it, and the shared
# projector contractions become ordinary matmuls over the tiny feature
# axis.  The per-lane factor is (nl, nl, B).
#
# The constrained-LS prox is folded at FACTOR time into a per-lane
# affine map (see parallel/fused_spm.py):
#
#     x0 = b2 - M @ hk0,   M = (I - xi2 S^{-1} C) B,
#                          b2 = alpha M A†y + xi2 S^{-1} D
#
# algebraically identical to the engine's xi1/xi2/nu elimination
# (reference objectivefunc.py:138-157), so each iteration is:
#
#     hk0 = -h10 - mu1*x1 - P†(h20 + mu2*x2)      # (nl,nw)x(nw,B)
#     x0  = b2 - M hk0                             # per-lane matvec
#     x1  = soft_threshold(-(h10 - mu1 x0)/mu1)
#     Px0 = P x0                                   # (nw,nl)x(nl,B)
#     x2  = max(-(h20 - mu2 Px0)/mu2, 0)
#     h10 += mu1 (x1 - x0);  h20 += mu2 (x2 - Px0) # dual ascent
#
# (sweep order/signs per optimizer.py ADMMPlan for the SpM pair graph;
# oracle-tested against BatchedSolver in tests/test_fused_spm.py).


def _spm_iteration(Pt, P, M, b2, mu1, mu2, thr1, carry):
    x0, x1, x2, h10, h20, _ = carry
    hi = linop.MATMUL_PRECISION

    hk0 = -h10 - mu1 * x1 - jnp.dot(Pt, h20 + mu2 * x2, precision=hi)
    # per-lane affine solve: x0[i,l] = b2[i,l] - sum_j M[i,j,l] hk0[j,l]
    x0n = b2 - jnp.sum(M * hk0[None, :, :], axis=1)

    z1 = -(h10 - mu1 * x0n) / mu1
    x1n = jnp.sign(z1) * jnp.maximum(jnp.abs(z1) - thr1, 0.0)

    Px0 = jnp.dot(P, x0n, precision=hi)
    z2 = -(h20 - mu2 * Px0) / mu2
    x2n = jnp.maximum(z2, 0.0)

    h10n = h10 + mu1 * (x1n - x0n)
    h20n = h20 + mu2 * (x2n - Px0)
    return (x0n, x1n, x2n, h10n, h20n, x0)


@functools.partial(jax.jit, static_argnames=("n_iters",))
def fused_spm_chunk(Pt, P, M, b2, scal, x0, x1, x2, h10, h20,
                    n_iters: int):
    """``n_iters`` SpM 3-block iterations with the penalties frozen.

    Feature-major shapes: shared ``Pt`` (nl, nw) / ``P`` (nw, nl);
    per-lane factor ``M`` (nl, nl, B), ``b2`` (nl, B), ``scal`` (3, B)
    rows [mu1, mu2, thr1]; state ``x0``/``x1``/``h10`` (nl, B),
    ``x2``/``h20`` (nw, B).  Returns the advanced state plus ``x0_prev``
    (penultimate block-0 iterate, for the dual residual), in the
    arguments' dtype.

    A plain ``lax.fori_loop`` over the whole batch: on the GPU each
    iteration is two skinny GEMMs and a few fused elementwise kernels.
    A Triton kernel running a whole chunk per launch was measured slower
    end to end (PERF.md).
    """
    mu1, mu2, thr1 = scal[0:1], scal[1:2], scal[2:3]
    body = functools.partial(_spm_iteration, Pt, P, M, b2, mu1, mu2, thr1)
    return jax.lax.fori_loop(0, n_iters, lambda t, c: body(c),
                             (x0, x1, x2, h10, h20, x0))
