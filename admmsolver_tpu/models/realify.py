"""Complex→real embedding: run complex problems in real arithmetic.

The reference solver is complex128-first (``optimizer.py:151,159``).  The
GPU and CPU backends run complex state natively; this module is the
alternative: it maps a complex :class:`~admmsolver_tpu.models.
problem.Model` onto an *exactly trajectory-isomorphic* real model of
doubled sizes, so complex workloads (SpM analytic continuation with
Matsubara data, complex compressed sensing) run in plain f32/f64
arithmetic — including the real-only fused solvers.

Embedding (interleaved layout): a complex vector ``v ∈ C^n`` becomes
``R(v) = [Re v_0, Im v_0, Re v_1, Im v_1, …] ∈ R^{2n}`` and a complex
matrix ``M`` becomes the real matrix with 2×2 blocks ``[[a, -b], [b, a]]``
per entry (``M = a + ib``).  Then ``R(Mv) = R(M) R(v)``,
``R(M†) = R(M)^T``, ``Re(u†v) = R(u)·R(v)``, and ``‖v‖ = ‖R(v)‖`` — every
piece of the ADMM iteration (Gauss–Seidel sweep, prox solves, dual
ascent, residual norms, convergence predicate, penalty adaptation) maps
term by term, so the real trajectory *is* the complex trajectory
(verified in ``tests/test_realify.py``).

The interleaved layout is chosen so **real** structured operators stay
structured: a real operator acts on interleaved coordinates as
``A ⊗ I_2``, i.e. a :class:`PartialDiagonalMatrix` — real dense couplings
cost two fused RHS columns (the exact complex-arithmetic FLOP
count), real diagonals stay diagonal, and identity couplings stay scaled
identities.  Genuinely complex *diagonal / scaled-identity* operators
keep an O(n) structured form too
(:class:`~admmsolver_tpu.ops.linop.InterleavedComplexDiagonalMatrix`,
whose Hermitian Gram collapses back to a plain diagonal — so
diagonal-penalty proxes survive complex couplings); only complex dense
operators densify.

Objectives map as:

* quadratic blocks (LeastSquares / ConstrainedLeastSquares /
  L2Regularizer) — same class over the embedded operators; the spectral
  solve path sees ``A†A ⊗ I_2`` and keeps its shared (thin)
  eigendecomposition of the small factor.
* separable blocks (L1 / NonNegative / SemiPositiveDefinite) — the
  reference prox consumes only ``h.real`` and returns a real minimizer
  (``objectivefunc.py:193-194,267-268,316``); the embedded prox reads the
  even (Re) lanes and writes zeros to the odd (Im) lanes
  (:class:`RealPartProx`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.linop import (
    DenseMatrix,
    DiagonalMatrix,
    InterleavedComplexDiagonalMatrix,
    MatrixBase,
    PartialDiagonalMatrix,
    ScaledIdentityMatrix,
    _concrete,
)
from .objectivefunc import (
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    LeastSquares,
    NonNegativePenalty,
    ObjectiveFunctionBase,
    SemiPositiveDefinitePenalty,
    _mu_diagonal,
)
from .problem import Model

__all__ = ["encode", "decode", "realify_matrix", "realify_objective",
           "realify_model", "RealifiedModel", "RealPartProx"]


def encode(v):
    """Complex ``(..., n)`` → real interleaved ``(..., 2n)``.

    Complex-side manipulation happens HOST-SIDE in numpy whenever the
    input is concrete, so no complex array has to exist on a device;
    only the already-real interleaved result is turned into a device
    array.  Traced (necessarily complex-capable) inputs keep a jnp path.
    """
    if isinstance(v, jax.core.Tracer):
        rdt = np.zeros(1, dtype=v.dtype).real.dtype
        out = jnp.stack([v.real, v.imag], axis=-1)
        return out.reshape(v.shape[:-1] + (2 * v.shape[-1],)).astype(rdt)
    v = np.asarray(jax.device_get(v))
    out = np.stack([v.real, v.imag], axis=-1)
    out = out.reshape(v.shape[:-1] + (2 * v.shape[-1],))
    return jnp.asarray(np.ascontiguousarray(out, dtype=v.real.dtype))


def decode(v):
    """Real interleaved ``(..., 2n)`` → complex ``(..., n)``.

    Concrete inputs are decoded host-side in numpy (complex output cannot
    live on a complex-less device); the result is a numpy complex array.
    """
    if isinstance(v, jax.core.Tracer):
        pairs = v.reshape(v.shape[:-1] + (v.shape[-1] // 2, 2))
        return pairs[..., 0] + 1j * pairs[..., 1]
    v = np.asarray(jax.device_get(v))
    pairs = v.reshape(v.shape[:-1] + (v.shape[-1] // 2, 2))
    return pairs[..., 0] + 1j * pairs[..., 1]


def _embed_dense(M) -> np.ndarray:
    """Interleaved real embedding of a concrete complex matrix."""
    M = np.asarray(M)
    m, n = M.shape
    R = np.zeros((2 * m, 2 * n), dtype=M.real.dtype)
    R[0::2, 0::2] = M.real
    R[0::2, 1::2] = -M.imag
    R[1::2, 0::2] = M.imag
    R[1::2, 1::2] = M.real
    return R


def _is_real(op: MatrixBase) -> bool:
    for leaf in jax.tree_util.tree_leaves(op):
        dt = getattr(leaf, "dtype", None)
        is_cplx = (np.issubdtype(np.dtype(dt), np.complexfloating)
                   if dt is not None else np.iscomplexobj(leaf))
        if is_cplx:
            c = _concrete(leaf)
            if c is None:
                return False
            # host-side: .imag of a device complex array would execute a
            # complex op on a possibly complex-less backend
            if np.any(np.asarray(jax.device_get(c)).imag != 0):
                return False
    return True


def realify_matrix(op: MatrixBase) -> MatrixBase:
    """Structured interleaved embedding of an operator.

    Real operators stay structured (``A ⊗ I_2``); complex ones densify.
    """
    if _is_real(op):
        if isinstance(op, ScaledIdentityMatrix):
            coeff = op.coeff
            if np.iscomplexobj(jax.device_get(_concrete(coeff))
                               if _concrete(coeff) is not None else coeff):
                # real-valued but complex-dtype: cast host-side (traced
                # complex leaves already failed _is_real)
                coeff = float(
                    np.asarray(jax.device_get(_concrete(coeff))).real)
            if op.is_square():
                return ScaledIdentityMatrix(2 * op.shape[0], coeff)
            return PartialDiagonalMatrix(
                ScaledIdentityMatrix(op.shape, coeff).to_diagonal_matrix(),
                (2,))
        if isinstance(op, DiagonalMatrix):
            d = op.diagonals
            if np.issubdtype(np.dtype(d.dtype), np.complexfloating):
                d = jnp.asarray(np.asarray(
                    jax.device_get(_concrete(d))).real.copy())
            if op.is_square():
                return DiagonalMatrix(jnp.repeat(d, 2))
            return PartialDiagonalMatrix(DiagonalMatrix(d, op.shape), (2,))
        if isinstance(op, PartialDiagonalMatrix):
            inner = op.matrix
            if _is_real(inner):
                inner = _as_real_matrix(inner)
                return PartialDiagonalMatrix(inner, op.rest_dims + (2,))
        if isinstance(op, DenseMatrix):
            data = op.data
            if np.issubdtype(np.asarray(data).dtype, np.complexfloating):
                data = jnp.asarray(
                    np.asarray(jax.device_get(data)).real.copy())
                op = DenseMatrix(data)
            return PartialDiagonalMatrix(op, (2,))
        return PartialDiagonalMatrix(DenseMatrix(op.asmatrix()), (2,))
    # Genuinely complex operators.  Diagonal structure survives the
    # embedding exactly (2×2 rotation-scale blocks): keep it, so EcE /
    # EcE2 products in realified models stay diagonal and the
    # diagonal-penalty proxes remain usable (the complex reference handles
    # this case fine — E†E is a real diagonal).
    if isinstance(op, ScaledIdentityMatrix) and op.is_square():
        c = complex(np.asarray(jax.device_get(_concrete(op.coeff))))
        n = op.shape[0]
        return InterleavedComplexDiagonalMatrix(
            jnp.full(n, c.real), jnp.full(n, c.imag))
    if isinstance(op, DiagonalMatrix) and op.is_square():
        d = np.asarray(jax.device_get(_concrete(op.diagonals)))
        return InterleavedComplexDiagonalMatrix(
            jnp.asarray(d.real.copy()), jnp.asarray(d.imag.copy()))
    dense = _concrete(op.asmatrix())
    if dense is None:
        raise ValueError(
            "realify_matrix requires concrete operator values for complex "
            "operators (structure is resolved at trace time)")
    return DenseMatrix(jnp.asarray(_embed_dense(jax.device_get(dense))))


def _as_real_matrix(op: MatrixBase) -> MatrixBase:
    """Cast a real-valued (possibly complex-dtype) operator to real dtype."""
    def fix(leaf):
        a = np.asarray(jax.device_get(leaf))
        if np.issubdtype(a.dtype, np.complexfloating):
            return jnp.asarray(a.real.copy())
        return leaf

    leaves, treedef = jax.tree_util.tree_flatten(op)
    return jax.tree_util.tree_unflatten(treedef, [fix(l) for l in leaves])


class RealPartProx(ObjectiveFunctionBase):
    """Embedded separable objective: prox on the Re lanes, zero Im lanes.

    Wraps L1 / NonNegative / SemiPositiveDefinite, whose reference prox
    projects ``h`` to its real part and returns a real minimizer
    (``objectivefunc.py:193-194,267-268,316``): in interleaved
    coordinates that is exactly "prox of the even lanes, zeros in the odd
    lanes".  Penalty diagonals are constant over each (Re, Im) pair (they
    come from embedded Hermitian couplings), so the even-lane diagonal is
    the original diagonal.
    """

    needs_diagonal_mu = True

    def __init__(self, inner: ObjectiveFunctionBase) -> None:
        assert inner.needs_diagonal_mu, type(inner)
        super().__init__(2 * inner.size_x)
        self._inner = inner

    @property
    def batch_fields(self) -> tuple:  # type: ignore[override]
        return self._inner.batch_fields

    def _apply_updates(self, updates: dict) -> None:
        if updates:
            self._inner = self._inner.clone_with(**updates)

    def __call__(self, x) -> float:
        return self._inner(decode(jnp.asarray(x)))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        assert h is not None
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(jnp.asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag):
        n = self._inner.size_x
        h_re = h.reshape(n, 2)[:, 0]
        mu_re = jnp.broadcast_to(mu_diag, (2 * n,)).reshape(n, 2)[:, 0]
        x_re = self._inner.prox_diag(h_re, mu_re)
        out = jnp.stack([x_re, jnp.zeros_like(x_re)], axis=-1)
        return out.reshape(2 * n)


def realify_objective(f: ObjectiveFunctionBase) -> ObjectiveFunctionBase:
    if isinstance(f, ConstrainedLeastSquares):
        return ConstrainedLeastSquares(
            f._alpha, realify_matrix(f._A), encode(f._y),
            realify_matrix(f._C), encode(f._D))
    if isinstance(f, LeastSquares):
        return LeastSquares(f._alpha, realify_matrix(f._A), encode(f._y))
    if isinstance(f, L2Regularizer):
        return L2Regularizer(f._alpha, realify_matrix(f._A))
    if isinstance(f, (L1Regularizer, NonNegativePenalty,
                      SemiPositiveDefinitePenalty)):
        return RealPartProx(f)
    raise TypeError(
        f"realify_objective: unsupported objective {type(f).__name__}")


class RealifiedModel:
    """A real :class:`Model` equivalent to a (possibly complex) one.

    ``.model`` is the embedded real model (block sizes doubled) — run any
    solver on it; ``encode_x``/``decode_x`` convert solver state tuples.
    The real trajectory is the exact image of the complex trajectory the
    reference would produce (tested in ``tests/test_realify.py``).
    """

    def __init__(self, model: Model) -> None:
        self.original = model
        functions = [realify_objective(f) for f in model.functions]
        conds = []
        for (i, j) in model.pairs:
            # Model stores E[(i2,i1)]=E1, E[(i1,i2)]=E2 with i=i2>j=i1
            # (problem.py); rebuild conditions in the same pair order.
            conds.append((j, i, realify_matrix(model.E[(i, j)]),
                          realify_matrix(model.E[(j, i)])))
        self.model = Model(functions, conds)

    def encode_x(self, x: Sequence) -> Tuple:
        return tuple(encode(jnp.asarray(x_)) for x_ in x)

    def decode_x(self, x: Sequence) -> Tuple:
        return tuple(decode(jnp.asarray(x_)) for x_ in x)

    encode = staticmethod(encode)
    decode = staticmethod(decode)


def realify_model(model: Model) -> RealifiedModel:
    return RealifiedModel(model)
