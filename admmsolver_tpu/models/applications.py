"""Problem builders for the benchmark workloads.

One builder per BASELINE.json config, composing the objective library and
constraint graph exactly like the reference's demo notebooks:

* :func:`basis_pursuit_model` — ``notebooks/basis_pursuit.ipynb`` cells
  5-7: LeastSquares + L1 coupled by identities.
* :func:`lasso_model` — LASSO / elastic-net / nonnegative variants
  (three-block with adaptive penalty).
* :func:`spm_model` — ``notebooks/spm.ipynb`` cells 10-11: the
  sparse-modeling analytic-continuation model — ConstrainedLeastSquares
  (sum rule) + L1 + NonNegativity through a real-frequency projector.
* :func:`sdp_model` — semidefinite-constrained quadratic with the
  PSD-projection prox.
* :func:`synthetic_spm_data` — a self-contained stand-in for the
  ``sparse_ir`` basis the reference notebook downloads (an SVD of an
  analytic-continuation kernel), so the workload runs hermetically.

Additive model families beyond the reference's two notebooks (each a
composition of the same block/coupling machinery):

* :func:`covariance_denoise_model` — weighted nearest-PSD matrix
  (the large-slice SDP workload).
* :func:`tv_denoise_model` — 1-D total-variation denoising.
* :func:`bounded_lsq_model` — box-constrained least squares.
* :func:`group_lasso_model` — block-sparse (group-L1) recovery.
* :func:`portfolio_model` — long-only mean-variance portfolio
  (hard simplex equality + nonnegativity).
* :func:`rpca_model` — robust PCA (nuclear-norm low-rank + sparse
  residual via the offset-L1 form).
* :func:`robust_regression_model` — outlier-resistant Huber regression.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.linop import DiagonalMatrix, MatrixBase, identity
from ..utils.grids import smooth_regularizer_coeff
from .objectivefunc import (
    BoxProjectionPenalty,
    ConstrainedLeastSquares,
    GroupL1Regularizer,
    HuberLoss,
    L1Regularizer,
    L2Regularizer,
    LeastSquares,
    NonNegativePenalty,
    NuclearNormPenalty,
    SemiPositiveDefinitePenalty,
)
from .problem import Model

__all__ = [
    "basis_pursuit_model",
    "lasso_model",
    "spm_model",
    "sdp_model",
    "covariance_denoise_model",
    "synthetic_spm_data",
    "tv_denoise_model",
    "bounded_lsq_model",
    "group_lasso_model",
    "portfolio_model",
    "rpca_model",
    "robust_regression_model",
]


def basis_pursuit_model(A, y, alpha_l1: float = 0.1) -> Model:
    """min ||y - A x||² + alpha |z|_1  s.t. z = x  (2-block)."""
    N = A.shape[1]
    return Model(
        [LeastSquares(1.0, A, y), L1Regularizer(alpha_l1, N)],
        [(1, 0, identity(N), identity(N))])


def lasso_model(A, y, alpha_l1: float,
                alpha_l2: float = 0.0,
                nonneg: bool = False,
                smooth_A: Optional[np.ndarray] = None) -> Model:
    """LASSO / elastic-net / nonnegative-LASSO (2- or 3-block).

    ``alpha_l2 > 0`` adds an L2 (ridge or, with ``smooth_A``, smoothness)
    term on the same variable block; ``nonneg`` adds the nonnegativity
    block coupled by identity.
    """
    N = A.shape[1]
    functions = [LeastSquares(1.0, A, y), L1Regularizer(alpha_l1, N)]
    eqs = [(1, 0, identity(N), identity(N))]
    if alpha_l2 > 0.0:
        B = smooth_A if smooth_A is not None else np.eye(N)
        functions.append(L2Regularizer(alpha_l2, B))
        eqs.append((len(functions) - 1, 0, identity(N), identity(N)))
    if nonneg:
        functions.append(NonNegativePenalty(N))
        eqs.append((len(functions) - 1, 0, identity(N), identity(N)))
    return Model(functions, eqs)


def spm_model(s_diag, g, prj_sum, prj_w, alpha_l1: float,
              sum_value: float = 1.0) -> Model:
    """Sparse-modeling analytic continuation (``spm.ipynb`` cells 10-11).

    Blocks: 0 = IR coefficients rho_l fitted as
    ``ConstrainedLeastSquares(1, -Diag(s), g, prj_sum, [sum_value])``
    (the sum rule as a hard equality); 1 = L1 sparsity on rho_l;
    2 = nonnegativity of the real-frequency spectrum.  Couplings:
    ``(0, 1, I, I)`` and ``(0, 2, prj_w, I)``.
    """
    s_diag = np.asarray(s_diag)
    nl = s_diag.size
    nw = prj_w.shape[0]
    assert prj_w.shape[1] == nl
    f0 = ConstrainedLeastSquares(
        1.0, DiagonalMatrix(-s_diag), g,
        np.asarray(prj_sum).reshape(1, nl), np.array([sum_value]))
    f1 = L1Regularizer(alpha_l1, nl)
    f2 = NonNegativePenalty(nw)
    eqs = [
        (0, 1, identity(nl), identity(nl)),
        (0, 2, prj_w, identity(nw)),
    ]
    return Model([f0, f1, f2], eqs)


def sdp_model(A, y, shape: Tuple[int, int, int], axis: int,
              alpha_l1: float = 0.0) -> Model:
    """Semidefinite-constrained quadratic: LS data fit + PSD cone on x
    viewed as ``shape`` with Hermitian slices along ``axis``
    (BASELINE.json config #4)."""
    N = int(np.prod(shape))
    assert A.shape[1] == N
    functions = [LeastSquares(1.0, A, y),
                 SemiPositiveDefinitePenalty(shape, axis)]
    eqs = [(1, 0, identity(N), identity(N))]
    if alpha_l1 > 0.0:
        functions.append(L1Regularizer(alpha_l1, N))
        eqs.append((2, 0, identity(N), identity(N)))
    return Model(functions, eqs)


def covariance_denoise_model(Y, weights=None) -> Model:
    """Weighted nearest-PSD-matrix / covariance denoising:
    ``min_X ||W^(1/2) (X - Y)||_F^2  s.t.  X >= 0`` for a noisy symmetric
    ``Y`` (k, k) and optional per-entry weights ``W`` (flat, k*k).

    The round-5 large-slice SDP workload (``bench_workloads.py
    sdp128``): the data operator is DIAGONAL, so the quadratic block is
    O(N) and the per-iteration cost is the PSD projection itself — which
    has no slice-size ceiling here (Jacobi eigh to 64, batched eigh or
    the polynomial matrix-sign path above).  Batch per-lane
    ``Y`` via the ``(0, "y")`` override (pass ``sqrt(w) * Y.ravel()``,
    matching the operator's ``sqrt(w)`` scaling).
    """
    Y = np.asarray(Y)
    k = Y.shape[-1]
    assert Y.shape[-2] == k, Y.shape
    N = k * k
    w = (np.ones(N) if weights is None
         else np.broadcast_to(np.asarray(weights, np.float64), (N,)))
    assert np.all(w > 0), "weights must be positive"
    # ||W^(1/2)(X - Y)||^2 = ||sqrt(w)*X - sqrt(w)*Y||^2: the operator
    # carries sqrt(w) so each entry is weighted w_i, not w_i^2.
    rw = np.sqrt(w)
    return Model(
        [LeastSquares(1.0, DiagonalMatrix(rw),
                      rw * np.reshape(Y, (-1,))),
         SemiPositiveDefinitePenalty((k, k, 1), 2)],
        [(1, 0, identity(N), identity(N))])


def tv_denoise_model(y, lam: float, structured: bool = True) -> Model:
    """1-D total-variation denoising:
    ``min_x  0.5 ||x - y||² + lam |D x|_1`` with ``D`` the forward
    difference operator (additive model family; composes the reference's
    block types — LS data fit + L1 on an auxiliary block — with a
    *non-identity* coupling ``D x = z``, the same machinery
    ``spm_model`` uses for its ``prj_w`` coupling).

    ``structured=True`` (default) stores ``D`` as a
    :class:`~admmsolver_tpu.ops.linop.BandedMatrix`: the Model
    precompute ``D†D`` stays tridiagonal, and the engine's quadratic
    factor is a cyclic-reduction cascade — O(N) memory and O(N log N)
    solves, so TV scales to N = 10⁵+ where the dense route's N × N
    Gram/factor is O(N²).  ``structured=False`` keeps the dense-``D``
    construction (bit-identical trajectories; used by the parity
    tests).
    """
    y = np.asarray(y)
    assert y.ndim == 1
    N = y.shape[0]
    assert N >= 2
    from ..ops.linop import BandedMatrix, ScaledIdentityMatrix

    if structured:
        bands = np.zeros((2, N - 1))
        bands[0, :] = -1.0   # offset 0
        bands[1, :] = 1.0    # offset +1
        D = BandedMatrix((0, 1), bands, (N - 1, N))
    else:
        D = np.zeros((N - 1, N))
        idx = np.arange(N - 1)
        D[idx, idx] = -1.0
        D[idx, idx + 1] = 1.0

    return Model(
        [LeastSquares(0.5, ScaledIdentityMatrix(N, 1.0), y),
         L1Regularizer(lam, N - 1)],
        [(0, 1, D, identity(N - 1))])


def bounded_lsq_model(A, y, lo=0.0, hi=1.0) -> Model:
    """Box-constrained least squares:
    ``min_x ||y - A x||²  s.t.  lo <= x <= hi`` elementwise (additive;
    oracle = ``scipy.optimize.lsq_linear``).  2-block: LS + box
    projection coupled by identity.
    """
    N = A.shape[1]
    return Model(
        [LeastSquares(1.0, A, y), BoxProjectionPenalty(N, lo, hi)],
        [(1, 0, identity(N), identity(N))])


def group_lasso_model(A, y, alpha: float, group_size: int) -> Model:
    """Group lasso: ``min_x ||y - A x||² + alpha sum_g ||x_g||_2`` over
    equal contiguous groups (additive; block-sparse recovery).  2-block:
    LS + group soft-threshold coupled by identity (which guarantees the
    blockwise-uniform penalty the closed-form group prox requires).
    """
    N = A.shape[1]
    assert N % group_size == 0, (N, group_size)
    return Model(
        [LeastSquares(1.0, A, y),
         GroupL1Regularizer(alpha, group_size, N // group_size)],
        [(1, 0, identity(N), identity(N))])


def robust_regression_model(A, y, delta: float = 1.0,
                            alpha_reg: float = 1e-6) -> Model:
    """Robust (Huber) regression:
    ``min_x  sum_i H_delta((A x - y)_i) + alpha_reg ||x||²`` (additive
    model family; outlier-resistant data fit).  2-block: a ridge-
    regularized coefficient block coupled through ``A`` to a residual
    block carrying the elementwise Huber prox with offset ``y`` — the
    same non-identity-coupling pattern as :func:`tv_denoise_model`.
    ``y`` is per-instance overridable via ``{(1, "y"): y_batch}``.
    """
    A = np.asarray(A)
    y = np.asarray(y, dtype=np.float64)
    M, N = A.shape
    assert y.shape == (M,)
    return Model(
        [L2Regularizer(alpha_reg, np.eye(N)),
         HuberLoss(1.0, y, delta)],
        [(0, 1, A, identity(M))])


def rpca_model(Y, lam: Optional[float] = None,
               svd_method: str = "auto") -> Model:
    """Robust PCA: ``min_L ||L||_* + lam |Y - L|_1`` — decompose ``Y``
    into a low-rank part ``L = x0`` and a sparse part ``S = Y - L``
    (additive model family; exercises the spectral
    :class:`NuclearNormPenalty` prox and the offset form of
    :class:`L1Regularizer`).

    2-block with identity coupling: block 0 carries the nuclear norm,
    block 1 the sparse deviation ``lam |x1 - vec(Y)|_1``.  Default
    ``lam = 1/sqrt(max(Y.shape))`` (the standard RPCA weight).  ``Y`` is
    per-instance overridable in the batched runtime via
    ``{(1, "offset"): vec(Y_batch)}``.
    """
    Y = np.asarray(Y, dtype=np.float64)
    assert Y.ndim == 2
    m, n = Y.shape
    if lam is None:
        lam = 1.0 / np.sqrt(max(m, n))
    mn = m * n
    return Model(
        [NuclearNormPenalty(1.0, (m, n), svd_method=svd_method),
         L1Regularizer(lam, mn, offset=Y.reshape(mn))],
        [(1, 0, identity(mn), identity(mn))])


def portfolio_model(cov, returns, gamma: float = 1.0) -> Model:
    """Long-only mean-variance portfolio (Markowitz):
    ``min_x x†Σx − gamma·r†x  s.t.  1†x = 1,  x >= 0`` (additive;
    exercises ConstrainedLeastSquares' hard equality + the nonneg
    block).  The quadratic-plus-linear objective is expressed in the
    ``alpha||y − A x||²`` form with ``A = Σ^{1/2}`` and
    ``y = (gamma/2)·Σ^{-1/2} r`` (constant offset dropped).
    """
    cov = np.asarray(cov, dtype=np.float64)
    returns = np.asarray(returns, dtype=np.float64)
    N = returns.shape[0]
    assert cov.shape == (N, N)
    w, V = np.linalg.eigh((cov + cov.T) / 2.0)
    assert w.min() > 0, "covariance must be positive definite"
    sqrt_cov = (V * np.sqrt(w)) @ V.T
    y = (gamma / 2.0) * ((V * (1.0 / np.sqrt(w))) @ V.T @ returns)
    f0 = ConstrainedLeastSquares(
        1.0, sqrt_cov, y, np.ones((1, N)), np.array([1.0]))
    return Model(
        [f0, NonNegativePenalty(N)],
        [(1, 0, identity(N), identity(N))])


def synthetic_spm_data(nl: int = 30, nw: int = 61, beta: float = 10.0,
                       wmax: float = 5.0, noise: float = 1e-5,
                       seed: int = 0):
    """Hermetic stand-in for the sparse_ir basis of ``spm.ipynb``.

    Builds the fermionic analytic-continuation kernel
    ``K(tau, w) = -exp(-tau w) / (1 + exp(-beta w))`` on a tau x omega
    grid, takes its SVD ``K = U S V†`` (the IR basis), synthesizes a
    two-peak spectrum rho(w) >= 0 with unit weight, and returns

    (s, g, prj_sum, prj_w, omega, rho_true)

    where ``s`` are the singular values, ``g = -S V† (rho*dw)`` the noisy
    IR-basis data, ``prj_sum`` the sum-rule row, ``prj_w`` the
    coefficient→spectrum projector (V† rows), mirroring the notebook's
    model wiring.
    """
    rng = np.random.RandomState(seed)
    ntau = 2 * nl
    tau = np.linspace(0, beta, ntau)
    omega = np.linspace(-wmax, wmax, nw)
    dw = np.gradient(omega)

    with np.errstate(over="ignore"):
        K = -np.exp(-tau[:, None] * omega[None, :]) / \
            (1.0 + np.exp(-beta * omega[None, :]))
    # weight columns by dw so K @ rho approximates the integral
    Kw = K * dw[None, :]
    U, S, Vh = np.linalg.svd(Kw, full_matrices=False)
    s = S[:nl]
    V = Vh[:nl]  # (nl, nw): rho_l = V @ rho_w

    # ground-truth spectrum: two Gaussians, unit total weight
    rho = (np.exp(-0.5 * ((omega - 1.2) / 0.4) ** 2) +
           0.7 * np.exp(-0.5 * ((omega + 1.0) / 0.6) ** 2))
    rho = rho / (rho * dw).sum()
    rho_l = V @ (rho * dw)

    g = -s * rho_l
    g = g + noise * rng.randn(nl)

    # prj_w maps coefficients rho_l -> spectrum values rho(w)*dw ... use
    # the (pseudo)inverse relation rho_w ≈ V† rho_l (V has orthonormal
    # rows), matching the notebook's real-frequency projector.
    prj_w = V.T  # (nw, nl)
    prj_sum = np.ones(nw) @ prj_w  # sum rule: 1·rho_w = sum over weights
    return s, g, prj_sum, prj_w, omega, rho * dw
