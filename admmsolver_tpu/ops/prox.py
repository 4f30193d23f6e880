"""Proximal-operator primitives as pure, fusable JAX functions.

These are the vectorized counterparts of the reference's prox helpers
(``/root/reference/src/admmsolver/objectivefunc.py:330-355`` and the
per-slice eigendecomposition loop at ``objectivefunc.py:320-327``).  All are
branch-free elementwise/matmul expressions so XLA fuses them into the
surrounding sweep; the PSD projection replaces the reference's Python
``for``-loop of ``np.linalg.eigh`` calls with one batched ``eigh`` that XLA
maps over slices on-device.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import linop


def soft_threshold(y, lam):
    """Soft-thresholding shrinkage (reference ``_softmax``).

    ``y - lam`` where ``y > lam``; ``y + lam`` where ``y < -lam``; else 0
    (``objectivefunc.py:335-355``).  Branch-free, so XLA fuses it.
    """
    return jnp.sign(y) * jnp.maximum(jnp.abs(y) - lam, 0.0)


def project_nonneg(x):
    """Projection onto the nonnegative orthant (``_project_plus``,
    ``objectivefunc.py:330-333``)."""
    return jnp.maximum(x, 0.0)


def psd_project(x, shape, axis):
    """Project Hermitian slices of a 3-way tensor onto the PSD cone.

    ``x`` is flat of size prod(shape); it is reshaped to ``shape``, sliced
    along ``axis``, and each (hermitian) slice is projected by clamping its
    eigenvalues at zero.  Replaces the reference's sequential slice loop
    (``objectivefunc.py:320-327``) with a single batched ``eigh`` — the
    batch axis maps onto device parallelism instead of Python iteration.
    """
    x3 = x.reshape(shape)
    x3 = jnp.moveaxis(x3, axis, 0)  # (K, n, n)
    # Reference semantics: np.linalg.eigh reads ONLY the lower triangle
    # (UPLO='L'), whereas jnp.linalg.eigh symmetrizes its input.  The
    # slices are NOT exactly Hermitian inside the ADMM loop (the duals h
    # are unconstrained), so build the Hermitian matrix the reference
    # implicitly diagonalizes: lower triangle mirrored, diagonal real.
    lo = jnp.tril(x3, -1)
    eye = jnp.eye(x3.shape[-1], dtype=jnp.real(x3).dtype)
    herm = lo + lo.conj().swapaxes(-1, -2) + jnp.real(x3) * eye
    proj = _psd_project_herm(herm)
    return jnp.moveaxis(proj, 0, axis).ravel()


# PSD-projection dispatch (module-level so benches and tests can force
# any path):
#   n <= JACOBI_MAX_N            -> scan-rolled/unrolled Jacobi eigh
#                                   (loop-body-safe; the scan envelope
#                                   is validated to 256)
#   n >  JACOBI_MAX_N, default   -> batched jnp.linalg.eigh (exact)
#   n >  JACOBI_MAX_N, "always"  -> polynomial matrix-sign projection
#                                   (psd_project_sign): ANY slice size,
#                                   GEMMs only
# The boundaries are inherited, not measured on the GPU; see ROADMAP.
JACOBI_MAX_N = 64
#: f32 boundary.  ``None`` falls back to JACOBI_MAX_N (benches forcing
#: a path set both).
JACOBI_MAX_N_F32: "int | None" = 32
#: Above the Jacobi boundary: ``"always"`` = polynomial matrix-sign
#: projection; False (default) = exact batched eigh.
USE_SIGN_ABOVE_JACOBI: "bool | str" = False


def _jacobi_boundary(dtype) -> int:
    if JACOBI_MAX_N_F32 is not None and jnp.finfo(dtype).bits <= 32:
        return JACOBI_MAX_N_F32
    return JACOBI_MAX_N


def _sign_active() -> bool:
    return USE_SIGN_ABOVE_JACOBI == "always"

# Matrix-sign polynomial schedules (k_quintic, k_cubic) per precision.
# The quintic is the tuned Newton–Schulz variant (coefficients from the
# public Muon orthogonalizer, a*x + b*x^3 + c*x^5); the cubic tail is
# the exact NS sign iteration (monotone on (0, sqrt(3)), quadratic near
# 1).  Scalar composition study (round 5): eigenvalues with
# |lam|/||X||_F >= delta are signed to <= eps, with
#   f32 (8, 8):  delta ~ 1.0e-5  (matches the f32 Jacobi's own error)
#   f64 (16, 10): delta ~ 1.8e-10 at eps = 1e-12
# Eigenvalues BELOW the floor contribute projection error <= |lam|
# itself (sign in [-1, 1] either way) — bounded by delta * ||X||_F.
SIGN_SCHEDULES = {32: (8, 8), 64: (16, 10)}
_SIGN_QUINTIC = (3.4445, -4.7750, 2.0315)


def psd_project_sign(herm):
    """PSD projection of real symmetric slices via the polynomial
    matrix-sign function — GEMMs only, no eigendecomposition.

    ``P(X) = (X + X sign(X)) / 2`` with ``sign(X)`` computed by a fixed
    odd-polynomial iteration on ``X / ||X||_F`` (quintic Newton–Schulz
    schedule + exact-cubic tail, see :data:`SIGN_SCHEDULES`).  Unlike
    eigendecomposition this is GEMM-only and works for ANY slice size.
    Accuracy: exact sign for
    eigenvalue magnitudes above ``delta * ||X||_F`` (delta per the
    schedule table); smaller eigenvalues err by at most their own
    magnitude.  The reference's per-slice exact eigh
    (objectivefunc.py:322-327) is matched to the floor.
    """
    bits = jnp.finfo(herm.dtype).bits
    k1, k2 = SIGN_SCHEDULES[64 if bits > 32 else 32]
    a, b, c = _SIGN_QUINTIC
    hi = linop.MATMUL_PRECISION
    mm = lambda x, y: jnp.matmul(x, y, precision=hi)

    s = jnp.sqrt(jnp.sum(herm * herm, axis=(-2, -1), keepdims=True))
    y = herm / jnp.where(s > 0, s, 1.0)
    eye = jnp.eye(herm.shape[-1], dtype=herm.dtype)
    z = y
    for _ in range(k1):
        z2 = mm(z, z)
        z4 = mm(z2, z2)
        z = mm(z, a * eye + b * z2 + c * z4)
    for _ in range(k2):
        z2 = mm(z, z)
        z = mm(z, 1.5 * eye - 0.5 * z2)
    # |Y| = Y sign(Y); symmetrize against roundoff drift
    absy = mm(y, z)
    absy = 0.5 * (absy + absy.swapaxes(-1, -2))
    return s * 0.5 * (y + absy)


def svt_sign(x, tau):
    """Singular-value soft-threshold via polynomial polar decomposition
    — GEMMs only, no SVD/eigh, any matrix size.

    ``SVT(X, tau) = U (S - tau)_+ V^T`` for ``X = U S V^T``.  Compute
    the thin polar factor ``U_p = U V^T`` by the same odd-polynomial
    (quintic Newton–Schulz + cubic tail) iteration applied to the
    rectangular ``X / ||X||_F`` — a Newton–Schulz orthogonalizer — then
    ``H = U_p^T X = V S V^T`` and ``SVT = U_p @ psd_project_sign(H -
    tau I)``.  Accuracy: singular directions with ``s >= delta *
    ||X||_F`` (delta per :data:`SIGN_SCHEDULES`) are exact to the
    polynomial tail; SMALLER ones are precisely the region the
    soft-threshold zeroes whenever ``tau`` is above the floor — the
    iteration's inaccurate subspace is annihilated by construction
    (and for ``tau`` below the floor the error is bounded by the floor,
    like :func:`psd_project_sign`).  ``tau``: scalar or broadcastable
    to the batch.  Batched over leading dims.
    """
    if jnp.iscomplexobj(x):
        raise TypeError("svt_sign supports real input only")
    m, n = x.shape[-2], x.shape[-1]
    if m < n:
        return svt_sign(x.swapaxes(-1, -2), tau).swapaxes(-1, -2)
    bits = jnp.finfo(x.dtype).bits
    k1, k2 = SIGN_SCHEDULES[64 if bits > 32 else 32]
    a, b, c = _SIGN_QUINTIC
    hi = linop.MATMUL_PRECISION
    mm = lambda p, q: jnp.matmul(p, q, precision=hi)

    s = jnp.sqrt(jnp.sum(x * x, axis=(-2, -1), keepdims=True))
    z = x / jnp.where(s > 0, s, 1.0)
    eye = jnp.eye(n, dtype=x.dtype)
    for _ in range(k1):
        g = mm(z.swapaxes(-1, -2), z)
        z = mm(z, a * eye + b * g + c * mm(g, g))
    for _ in range(k2):
        g = mm(z.swapaxes(-1, -2), z)
        z = mm(z, 1.5 * eye - 0.5 * g)
    # z ~ U_p = U V^T (thin polar factor); H = U_p^T X = V S V^T
    h = mm(z.swapaxes(-1, -2), x)
    h = 0.5 * (h + h.swapaxes(-1, -2))
    tau_arr = jnp.asarray(tau, x.dtype)
    shifted = h - tau_arr[..., None, None] * eye if tau_arr.ndim \
        else h - tau_arr * eye
    return mm(z, psd_project_sign(shifted))


def _psd_project_herm(herm):
    """PSD projection of exactly-Hermitian slices ``(K, n, n)``.

    Real n <= JACOBI_MAX_N: the loop-body-safe Jacobi
    eigendecomposition (unrolled for n <= 16, scan-rolled above).
    Larger real slices: batched ``jnp.linalg.eigh``, or the polynomial
    matrix-sign projection (:func:`psd_project_sign`, GEMMs only) when
    :data:`USE_SIGN_ABOVE_JACOBI` is ``"always"``.  Complex Hermitian
    slices small enough for Jacobi (or on the sign path): the realify
    embedding ``H = X + iY -> R = [[X, -Y], [Y, X]]`` — a
    *-isomorphism, so spectral functions commute with it: project the
    real symmetric 2n x 2n embedding with the same real dispatch and
    map back.  Larger complex slices: complex ``jnp.linalg.eigh``.
    """
    n = herm.shape[-1]
    if jnp.iscomplexobj(herm):
        if 2 * n <= _jacobi_boundary(jnp.real(herm).dtype) \
                or _sign_active():
            X, Y = jnp.real(herm), jnp.imag(herm)
            top = jnp.concatenate([X, -Y], axis=-1)
            bot = jnp.concatenate([Y, X], axis=-1)
            R = jnp.concatenate([top, bot], axis=-2)     # (K, 2n, 2n)
            Rp = _psd_project_herm(R)
            Xp = 0.5 * (Rp[..., :n, :n] + Rp[..., n:, n:])
            Yp = 0.5 * (Rp[..., n:, :n] - Rp[..., :n, n:])
            return Xp + 1j * Yp
        evals, evecs = jnp.linalg.eigh(herm)
        evals = jnp.maximum(evals, 0.0)
        return jnp.einsum("kij,kj,klj->kil", evecs, evals, evecs.conj(),
                          precision=linop.MATMUL_PRECISION)
    if n <= _jacobi_boundary(herm.dtype):
        from .linop import jacobi_eigh

        evals, evecs = jacobi_eigh(herm, sort=False)
        evals = jnp.maximum(evals, 0.0)
        if n <= 16:
            # Rebuild V diag(w) V^T as broadcast-multiply + reduce, not
            # einsum/dot_general: it fuses with the surrounding
            # elementwise work instead of launching a batched tiny GEMM.
            # The (K,n,n,n) intermediate is tiny for n <= 16.
            scaled = evecs * evals[..., None, :]            # (K, i, j)
            return jnp.sum(
                scaled[..., :, None, :] * evecs[..., None, :, :],
                axis=-1)                                    # (K, i, l)
        # n = 17..JACOBI_MAX_N: the (K,n,n,n) elementwise intermediate
        # no longer fits comfortably (n=64, K=4096, f64 -> 8 GB); a
        # batched GEMM at this size is worth a BLAS call.
        return jnp.matmul(evecs * evals[..., None, :],
                          evecs.swapaxes(-1, -2),
                          precision=linop.MATMUL_PRECISION)
    if _sign_active():
        return psd_project_sign(herm)
    evals, evecs = jnp.linalg.eigh(herm)
    evals = jnp.maximum(evals, 0.0)
    return jnp.einsum("kij,kj,klj->kil", evecs, evals, evecs.conj(),
                      precision=linop.MATMUL_PRECISION)
