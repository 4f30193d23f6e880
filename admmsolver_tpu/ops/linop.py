"""Structured linear operators, resolved at trace time.

This is the JAX counterpart of the reference's structured-matrix
algebra (``/root/reference/src/admmsolver/matrix.py:9-513``).  The key design
difference: the reference dispatches on *runtime* Python types with NumPy
values; here the **structure** (dense / diagonal / scaled identity /
Kronecker-with-identity) is a static property fixed when the operator is
built, while the **values** are JAX arrays that may be traced.  Every
operator is a registered pytree, so operators can be closed over by ``jit``,
carried through ``lax.scan`` / ``lax.while_loop``, and ``vmap``-ed.

All structure-preserving rewrites of the reference are reproduced as pure
trace-time dispatch:

* rectangular scaled-identity / diagonal with truncate-or-zero-pad matvec
  semantics (``matrix.py:255-295,429-448``),
* ``A ⊗ I`` (``PartialDiagonalMatrix``) matvec via reshape + tensordot on the
  leading axis (``matrix.py:367-401``) — a single matmul,
* structure-preserving matmul/add dispatch, including the collapse of
  ``Diagonal @ KroneckerI`` / ``Diagonal + KroneckerI`` to Kronecker form
  when the diagonal is blockwise constant (``matrix.py:283-291,461-468``);
  data-dependent collapses only fire when values are concrete (setup time),
  under tracing they fall back to dense,
* ``inv`` per structure (``matrix.py:77-78,155-158,223-226,330-331``).

Extras with no reference counterpart: ``gram()`` (A†A with
structure), ``effective_diagonal()`` (used by the diagonal-only proxes), and
batched trailing-dimension matvecs mapped onto a single ``dot_general``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

Scalar = Union[float, complex, np.floating, np.complexfloating]

__all__ = [
    "MatrixBase",
    "DenseMatrix",
    "DiagonalMatrix",
    "ScaledIdentityMatrix",
    "PartialDiagonalMatrix",
    "InterleavedComplexDiagonalMatrix",
    "BandedMatrix",
    "TridiagFactor",
    "tridiag_cr_factor",
    "tridiag_cr_solve",
    "identity",
    "asmatrixtype",
    "matrix_hash",
]

#: Precision of every contraction on the solve path.  An f32 product at
#: DEFAULT precision may run in TF32 on the GPU (about three decimal
#: digits), which corrupts the shifted-quadratic solve and flips
#: penalty-adaptation decisions.  Read at trace time, so a negative
#: control can lower it.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def _concrete(x) -> Optional[np.ndarray]:
    """Return a concrete ndarray view of ``x``, or None if ``x`` is traced."""
    if isinstance(x, jax.core.Tracer):
        return None
    try:
        return np.asarray(x)
    except Exception:  # pragma: no cover - defensive
        return None


def _match_precision(c, ref_dtype):
    """Cast ``c`` to the precision (f32 vs f64) of ``ref_dtype``, keeping
    its real/complex kind.

    Policy: operator values follow the *state* dtype.  Shared operators
    are stored at setup precision (typically f64); when the solver runs a
    reduced-precision phase, their application must not silently promote
    the whole graph back to f64.  Casts of concrete operands are
    constant-folded by XLA.
    """
    c = jnp.asarray(c)
    rdt = np.dtype(ref_dtype).type(0).real.dtype
    if np.issubdtype(c.dtype, np.complexfloating):
        tgt = np.complex64 if rdt == np.float32 else np.complex128
    elif np.issubdtype(c.dtype, np.floating):
        tgt = rdt
    else:
        return c
    return c.astype(tgt) if c.dtype != tgt else c


def _is_scalar(x) -> bool:
    if isinstance(x, (int, float, complex, np.floating, np.complexfloating, np.integer)):
        return True
    if isinstance(x, (jnp.ndarray, np.ndarray, jax.core.Tracer)):
        return getattr(x, "ndim", None) == 0
    return False


def _asarray(x):
    return x if isinstance(x, (jnp.ndarray, jax.core.Tracer)) else jnp.asarray(x)


def inv_qr(a):
    """General matrix inverse via QR + triangular solve.

    LU-free replacement for ``jnp.linalg.inv``, written for a backend
    without f64 LU; whether it still beats LU on the GPU is open
    (ROADMAP).  A⁻¹ = R⁻¹ Q†.
    """
    q, r = jnp.linalg.qr(a)
    return jax.scipy.linalg.solve_triangular(r, q.conj().T, lower=False)


def _mm_small(a, b):
    """Batched small matmul as a broadcast multiply + reduction.

    For batched *small* matmuls (``(B,n,n) @ (B,n,k)``, n ≲ 64) the
    elementwise form fuses with its neighbours instead of launching a
    batched tiny GEMM; whether it wins against the GPU's batched GEMM
    is open (ROADMAP).  Shapes ``(..., m, n) @ (..., n, k) → (..., m,
    k)``; broadcasting over leading dims.
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def inv_hpd_schur(d):
    """Hermitian-positive-definite inverse, unrolled at trace time.

    Recursive 2×2-block Schur-complement inversion: with ``M = [[A, B],
    [B†, C]]`` and ``S = C − B† A⁻¹ B`` (both HPD for HPD ``M``),

        M⁻¹ = [[A⁻¹ + W S⁻¹ W†,  −W S⁻¹],
               [−S⁻¹ W†,          S⁻¹  ]],    W = A⁻¹ B.

    The recursion is fully unrolled in Python — NO data-dependent control
    flow — so unlike ``jax.scipy.linalg.cho_factor`` it compiles to
    straight-line elementwise code, with no per-call loop overhead, and
    keeps full working-precision accuracy (numerically equivalent to an
    unpivoted block LDL — fine for the HPD operands the ADMM factor path
    produces).  Works batched or unbatched (leading dims broadcast).
    Intended for n ≲ 128; larger blocks should use the Cholesky path.
    """
    n = d.shape[-1]
    if n == 1:
        return 1.0 / d
    if n == 2:
        a = d[..., 0:1, 0:1]
        b = d[..., 0:1, 1:2]
        bh = d[..., 1:2, 0:1]
        c = d[..., 1:2, 1:2]
        det = a * c - b * bh
        row0 = jnp.concatenate([c, -b], axis=-1)
        row1 = jnp.concatenate([-bh, a], axis=-1)
        return jnp.concatenate([row0, row1], axis=-2) / det
    n1 = n // 2
    A = d[..., :n1, :n1]
    B = d[..., :n1, n1:]
    C = d[..., n1:, n1:]
    iA = inv_hpd_schur(A)
    W = _mm_small(iA, B)
    S = C - _mm_small(B.conj().swapaxes(-1, -2), W)
    iS = inv_hpd_schur(S)
    WiS = _mm_small(W, iS)
    TL = iA + _mm_small(WiS, W.conj().swapaxes(-1, -2))
    TR = -WiS
    BL = TR.conj().swapaxes(-1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, iS], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _roundrobin_schedule(n: int):
    """Circle-method round-robin: n-1 rounds of n/2 disjoint pairs
    covering every (p, q) pair exactly once per sweep (n even)."""
    arr = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([(arr[i], arr[n - 1 - i]) for i in range(n // 2)])
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return rounds


def jacobi_eigh(a, sweeps: Optional[int] = None, sort: bool = True):
    """Batched real-symmetric eigendecomposition, unrolled parallel-order
    Jacobi.

    Same idea as :func:`inv_hpd_schur`, aimed at ``jnp.linalg.eigh``:
    a library eigh traced through ``vmap`` inside a solver
    ``while_loop`` body need not lower to the batched routine it is
    standalone.  This version is straight-line elementwise code with a
    FIXED schedule — per sweep, n−1
    round-robin rounds each rotating n/2 DISJOINT pivots simultaneously
    as full-width elementwise math (no scatters, no data-dependent
    control flow), unrolled at trace time — so it lowers identically
    anywhere it is traced and under any batching.

    ``a``: (..., n, n) real symmetric (the full matrix is read;
    symmetrize first if needed).  Returns ``(evals, evecs)`` with
    ``evals`` ascending per lane when ``sort=True`` (matching
    ``jnp.linalg.eigh``) and ``a ≈ evecs @ diag(evals) @ evecs.T``.
    Dispatch: n ≤ 16 unrolls the schedule at trace time (this
    function's body); 17 ≤ n ≤ 256 uses the scan-rolled schedule
    (:func:`_jacobi_eigh_scan` — same per-round math, O(1) trace);
    n > 256 raises (use ``jnp.linalg.eigh`` standalone).  Replaces the
    reference's per-slice ``np.linalg.eigh`` loop
    (``objectivefunc.py:320-327``) on the PSD prox path.
    """
    if jnp.iscomplexobj(a):
        # The rotation angle below (arctan2) silently takes real parts;
        # complex-Hermitian inputs need jnp.linalg.eigh (or the realify
        # embedding, see ops.prox.psd_project).
        raise TypeError("jacobi_eigh supports real symmetric input only; "
                        "use jnp.linalg.eigh for complex Hermitian blocks")
    n = a.shape[-1]
    if n > 16:
        # Larger blocks use the scan-rolled schedule: identical per-round
        # math, O(1) trace size (the unrolled trace below would be
        # sweeps·(n−1) rounds).  Beyond 256, standalone jnp.linalg.eigh
        # is the right tool.
        if n <= 256:
            return _jacobi_eigh_scan(a, sweeps=sweeps, sort=sort)
        raise ValueError(f"jacobi_eigh is limited to n <= 256, got n={n};"
                         " use jnp.linalg.eigh")
    if n == 1:
        w = a[..., 0]
        v = jnp.ones_like(a)
        return w, v
    odd = n % 2 == 1
    if odd:
        # Pad with a decoupled dummy dimension whose diagonal STRICTLY
        # dominates every eigenvalue (1 + Σ|a|), so every rotation
        # pairing the dummy sees a_pq = 0 and a_qq − a_pp > 0 →
        # θ = atan2(0, +)/2 = 0 exactly: the dummy never mixes or swaps
        # and is sliced back off as the literal last row/column.
        big = 1.0 + jnp.sum(jnp.abs(a), axis=(-2, -1), keepdims=True)
        zcol = jnp.zeros(a.shape[:-1] + (1,), dtype=a.dtype)
        a = jnp.concatenate([a, zcol], axis=-1)
        last = jnp.concatenate(
            [jnp.zeros(a.shape[:-2] + (1, n), dtype=a.dtype),
             jnp.broadcast_to(big, a.shape[:-2] + (1, 1))], axis=-1)
        a = jnp.concatenate([a, last], axis=-2)
        n += 1
    if sweeps is None:
        # quadratically convergent after ~3 sweeps; validated to ~n*eps
        # reconstruction error in tests/test_linop.py
        sweeps = 8 if n <= 8 else 10
    m = n // 2
    v = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)

    # Trace-time permutation bookkeeping: `order[i]` = original label at
    # physical position i.  Each round permutes the basis so its pairs
    # sit at positions (2i, 2i+1); V accumulates the permutations too,
    # so no un-permute is needed at the end.
    order = list(range(n))
    for sweep in range(sweeps):
        for pairs in _roundrobin_schedule(n):
            desired = [lab for pq in pairs for lab in pq]
            pos = {lab: i for i, lab in enumerate(order)}
            perm = np.asarray([pos[lab] for lab in desired])
            order = desired
            a = jnp.take(jnp.take(a, perm, axis=-1), perm, axis=-2)
            v = jnp.take(v, perm, axis=-1)

            blk = a.reshape(a.shape[:-2] + (m, 2, m, 2))
            d = jnp.diagonal(blk, axis1=-4, axis2=-2)  # (..., 2, 2, m)
            app, aqq = d[..., 0, 0, :], d[..., 1, 1, :]
            apq = d[..., 0, 1, :]
            # θ zeroing a'pq: tan 2θ = 2 a_pq / (a_qq − a_pp); atan2 is
            # branch-free and safe at a_pq = 0.  Fold to the INNER root
            # |θ| ≤ π/4 (the zeroing angles form a π/2 family): large-
            # angle roots act as diagonal swaps, which stall the
            # parallel ordering in a permutation cycle instead of
            # converging (classical Jacobi convergence needs |θ| ≤ π/4).
            th = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)  # (..., m)
            th = th - jnp.where(jnp.abs(th) > np.pi / 4,
                                jnp.sign(th) * (np.pi / 2), 0.0)
            c, s = jnp.cos(th), jnp.sin(th)

            def rot_cols(x, c=c, s=s):
                # x ← x @ blockdiag(G_i), G = [[c, s], [−s, c]]
                xc = x.reshape(x.shape[:-1] + (m, 2))
                cc = c[..., None, :]
                ss = s[..., None, :]
                x0, x1 = xc[..., 0], xc[..., 1]
                return jnp.stack(
                    [x0 * cc - x1 * ss, x0 * ss + x1 * cc],
                    axis=-1).reshape(x.shape)

            a = rot_cols(a)
            # rows: same coefficients applied to row pairs
            ar = a.reshape(a.shape[:-2] + (m, 2, n))
            cc = c[..., :, None]
            ss = s[..., :, None]
            r0, r1 = ar[..., 0, :], ar[..., 1, :]
            a = jnp.stack([r0 * cc - r1 * ss, r0 * ss + r1 * cc],
                          axis=-2).reshape(a.shape[:-2] + (n, n))
            v = rot_cols(v)

    # physical positions hold permuted labels; restore original label
    # order so evecs[i, :] corresponds to input coordinate i
    inv = np.argsort(np.asarray(order))
    a = jnp.take(jnp.take(a, inv, axis=-1), inv, axis=-2)
    v = jnp.take(v, inv, axis=-1)
    if odd:
        n -= 1
        a = a[..., :n, :n]
        v = v[..., :n, :n]
    w = jnp.diagonal(a, axis1=-2, axis2=-1)
    if sort:
        o = jnp.argsort(w, axis=-1)
        w = jnp.take_along_axis(w, o, axis=-1)
        v = jnp.take_along_axis(v, o[..., None, :], axis=-1)
    return w, v


def _jacobi_eigh_scan(a, sweeps: Optional[int] = None, sort: bool = True):
    """Scan-rolled parallel-order Jacobi for 16 < n <= 256.

    Same per-round math as the unrolled :func:`jacobi_eigh` (n/2 disjoint
    Givens rotations on contiguous position pairs, full-width elementwise
    code), but the round-robin schedule is driven by a
    ``lax.fori_loop`` instead of a trace-time unroll.  This works because
    the circle-method schedule has a FIXED inter-round relabeling: with
    the matrix kept in the "paired" layout (round pairs at positions
    (2i, 2i+1)), moving from any round's layout to the next is the SAME
    static permutation ``pi`` — verified for every even n, including the
    wraparound from the last round of a sweep back to the first.  The
    loop body is therefore identical each round (rotate pairs, permute
    by ``pi``: static gathers + elementwise math, no data-dependent
    control flow), giving an O(1) trace that stays loop-body-safe under
    vmap inside the solver ``while_loop`` — the regime where XLA's eigh
    degrades ~1000× (benches/sdp_ablate2.py).  Extends the PSD prox past
    the round-3 n <= 16 ceiling (reference projects arbitrary slice
    sizes, ``objectivefunc.py:322-327``).
    """
    n = a.shape[-1]
    odd = n % 2 == 1
    if odd:
        # decoupled strictly-dominant dummy dimension (see jacobi_eigh)
        big = 1.0 + jnp.sum(jnp.abs(a), axis=(-2, -1), keepdims=True)
        zcol = jnp.zeros(a.shape[:-1] + (1,), dtype=a.dtype)
        a = jnp.concatenate([a, zcol], axis=-1)
        last = jnp.concatenate(
            [jnp.zeros(a.shape[:-2] + (1, n), dtype=a.dtype),
             jnp.broadcast_to(big, a.shape[:-2] + (1, 1))], axis=-1)
        a = jnp.concatenate([a, last], axis=-2)
        n += 1
    if sweeps is None:
        # Quadratic convergence: measured reconstruction error vs sweeps
        # on random symmetric batches (rounds 4-5) — f32 converges to
        # its eps by 6-8 sweeps at n = 32..256; f64 by 8 at n <= 64, 9
        # at n <= 128, 10 at n <= 256; defaults carry +1 margin
        # (validated to ~n·eps in tests/test_linop.py).  Sweep count is
        # the scan path's whole cost, so this is a direct lever on the
        # in-loop prox.
        f32 = jnp.finfo(a.dtype).bits <= 32
        if f32:
            sweeps = 8 if n <= 64 else 9
        else:
            sweeps = (9 if n <= 32 else
                      10 if n <= 128 else 11)
    m = n // 2

    # Round-0 paired layout and the fixed inter-round permutation.
    arr = list(range(n))
    d0 = [lab for i in range(m) for lab in (arr[i], arr[n - 1 - i])]
    arr1 = [arr[0], arr[-1]] + arr[1:-1]
    d1 = [lab for i in range(m) for lab in (arr1[i], arr1[n - 1 - i])]
    pos0 = {lab: i for i, lab in enumerate(d0)}
    pi = np.asarray([pos0[lab] for lab in d1])
    P0 = np.asarray(d0)

    a = jnp.take(jnp.take(a, P0, axis=-1), P0, axis=-2)
    v = jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), a.shape)
    v = jnp.take(v, P0, axis=-1)  # rows: original labels; cols: paired

    def round_body(_, av):
        a, v = av
        blk = a.reshape(a.shape[:-2] + (m, 2, m, 2))
        d = jnp.diagonal(blk, axis1=-4, axis2=-2)  # (..., 2, 2, m)
        app, aqq = d[..., 0, 0, :], d[..., 1, 1, :]
        apq = d[..., 0, 1, :]
        # inner-root angle |θ| <= π/4 (see jacobi_eigh)
        th = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)
        th = th - jnp.where(jnp.abs(th) > np.pi / 4,
                            jnp.sign(th) * (np.pi / 2), 0.0)
        c, s = jnp.cos(th), jnp.sin(th)

        def rot_cols(x):
            xc = x.reshape(x.shape[:-1] + (m, 2))
            cc = c[..., None, :]
            ss = s[..., None, :]
            x0, x1 = xc[..., 0], xc[..., 1]
            return jnp.stack(
                [x0 * cc - x1 * ss, x0 * ss + x1 * cc],
                axis=-1).reshape(x.shape)

        a = rot_cols(a)
        ar = a.reshape(a.shape[:-2] + (m, 2, n))
        cc = c[..., :, None]
        ss = s[..., :, None]
        r0, r1 = ar[..., 0, :], ar[..., 1, :]
        a = jnp.stack([r0 * cc - r1 * ss, r0 * ss + r1 * cc],
                      axis=-2).reshape(a.shape[:-2] + (n, n))
        v = rot_cols(v)
        # advance to the next round's paired layout (static gathers)
        a = jnp.take(jnp.take(a, pi, axis=-1), pi, axis=-2)
        v = jnp.take(v, pi, axis=-1)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps * (n - 1), round_body, (a, v))
    # the wraparound permutation returns layout to d0 after each full
    # sweep; undo the initial pairing permutation
    inv = np.argsort(P0)
    a = jnp.take(jnp.take(a, inv, axis=-1), inv, axis=-2)
    v = jnp.take(v, inv, axis=-1)
    if odd:
        n -= 1
        a = a[..., :n, :n]
        v = v[..., :n, :n]
    w = jnp.diagonal(a, axis1=-2, axis2=-1)
    if sort:
        o = jnp.argsort(w, axis=-1)
        w = jnp.take_along_axis(w, o, axis=-1)
        v = jnp.take_along_axis(v, o[..., None, :], axis=-1)
    return w, v


def svd_via_gram(x, eigh_fn=None):
    """Thin SVD of ``(..., m, n)`` real matrices via a symmetric
    eigendecomposition of the SMALLER Gram matrix.

    ``U, s, Vh`` with ``x ≈ U @ diag(s) @ Vh``, ``s`` descending —
    the layout of ``jnp.linalg.svd(x, full_matrices=False)``.  GEMM-based
    replacement for the library SVD inside compiled solver loops: two
    GEMMs plus one symmetric eigh of the min(m, n)-sized Gram, which for
    min(m, n) <= 64 is the loop-body-safe :func:`jacobi_eigh`.

    Accuracy: squaring the spectrum floors small singular values at
    ``~sqrt(eps)·s_max``; exactly the region the nuclear-norm
    soft-threshold (its only engine consumer,
    ``NuclearNormPenalty.prox_diag``) zeroes anyway.  Null-space columns
    divide by 1 instead of their ~0 singular value (see ``_safe_div``) — their contribution is annihilated by the
    thresholded singular values.
    """
    if jnp.iscomplexobj(x):
        raise TypeError("svd_via_gram supports real input only")
    m, n = x.shape[-2], x.shape[-1]
    if eigh_fn is None:
        eigh_fn = (jacobi_eigh if min(m, n) <= 256
                   else jnp.linalg.eigh)
    hi = MATMUL_PRECISION
    xt = x.swapaxes(-1, -2)
    # Null-direction divisor: a fixed floor near finfo.tiny**0.5
    # (~1.5e-154 in f64) underflows any f64 arithmetic with an f32
    # exponent range and flushes to zero -> 0/0 = NaN on the very first
    # ADMM iteration (x = 0 -> all-zero prox input).  Instead, divide
    # null directions by 1: their
    # numerators are ~0 anyway and the thresholded singular values
    # annihilate the columns.  eps-scaled cutoff stays well inside the
    # emulation's representable range.
    def _safe_div(num, s):
        smax = jnp.max(s, axis=-1, keepdims=True)
        cut = jnp.asarray(np.finfo(np.dtype(x.dtype)).eps,
                          x.dtype) * jnp.maximum(smax, 1.0)
        return num / jnp.where(s > cut, s, 1.0)[..., None, :]

    if n <= m:
        g = jnp.matmul(xt, x, precision=hi)              # (n, n)
        w, V = eigh_fn(g)                                # ascending
        w = w[..., ::-1]
        V = V[..., ::-1]
        s = jnp.sqrt(jnp.maximum(w, 0.0))
        U = _safe_div(jnp.matmul(x, V, precision=hi), s)
        return U, s, V.swapaxes(-1, -2)
    g = jnp.matmul(x, xt, precision=hi)                  # (m, m)
    w, U = eigh_fn(g)
    w = w[..., ::-1]
    U = U[..., ::-1]
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    Vh = jnp.matmul(_safe_div(U, s).swapaxes(-1, -2), x, precision=hi)
    return U, s, Vh


class MatrixBase:
    """Abstract structured operator.

    Mirrors the reference interface (``matrix.py:9-60``): ``@ + - *``, ``.T``,
    ``conj``/``conjugate``, ``inv``, ``asmatrix``, ``hash``, plus the
    (misnamed in the reference) squareness test ``is_diagonal``.
    """

    shape: Tuple[int, int]
    ndim: int = 2

    # -- structure queries -------------------------------------------------
    def is_diagonal(self) -> bool:
        # Reference semantics: actually tests squareness (matrix.py:16-17).
        return self.shape[0] == self.shape[1]

    is_square = is_diagonal

    # -- conversions -------------------------------------------------------
    def asmatrix(self):
        raise NotImplementedError

    to_dense = asmatrix

    # -- algebra -----------------------------------------------------------
    def __neg__(self) -> "MatrixBase":
        return self * (-1.0)

    def __sub__(self, other) -> "MatrixBase":
        return self + (-other)

    def __add__(self, other) -> "MatrixBase":
        return add(self, other)

    def __radd__(self, other) -> "MatrixBase":
        return add(other, self)

    def __mul__(self, other) -> "MatrixBase":
        if not _is_scalar(other):
            return NotImplemented
        return self._scale(other)

    __rmul__ = __mul__

    def __matmul__(self, other):
        if isinstance(other, (np.ndarray, jnp.ndarray, jax.core.Tracer)):
            return self.matvec(other)
        if isinstance(other, MatrixBase):
            return matmul(self, other)
        return NotImplemented

    def _scale(self, c) -> "MatrixBase":
        raise NotImplementedError

    def matvec(self, v):
        """Apply to a vector / batched RHS (trailing batch dims)."""
        raise NotImplementedError

    def conjugate(self) -> "MatrixBase":
        raise NotImplementedError

    conj = conjugate

    @property
    def T(self) -> "MatrixBase":
        raise NotImplementedError

    @property
    def H(self) -> "MatrixBase":
        """Conjugate transpose (adjoint)."""
        return self.conjugate().T

    def inv(self) -> "MatrixBase":
        raise NotImplementedError

    def gram(self) -> "MatrixBase":
        """A† A, keeping structure where possible."""
        return matmul(self.H, self)

    def effective_diagonal(self):
        """Diagonal vector if this operator acts as a (full) diagonal.

        Mirrors the diagonal extraction at ``objectivefunc.py:302-309``.
        Returns None when no diagonal interpretation exists.
        """
        return None

    def hash(self) -> int:
        raise NotImplementedError


# =====================================================================
# Concrete structures
# =====================================================================


@jax.tree_util.register_pytree_node_class
class DenseMatrix(MatrixBase):
    """Dense 2-D operator (reference ``matrix.py:63-121``)."""

    def __init__(self, matrix) -> None:
        matrix = _asarray(matrix)
        assert matrix.ndim == 2, matrix.shape
        self.data = matrix
        self.shape = tuple(matrix.shape)

    def tree_flatten(self):
        return (self.data,), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        obj = object.__new__(cls)
        obj.data = children[0]
        obj.shape = shape
        return obj

    def asmatrix(self):
        return self.data

    to_dense = asmatrix

    def hash(self) -> int:
        return matrix_hash(np.asarray(self.data))

    def _scale(self, c) -> "DenseMatrix":
        return DenseMatrix(self.data * c)

    @property
    def T(self) -> "DenseMatrix":
        return DenseMatrix(self.data.T)

    def conjugate(self) -> "DenseMatrix":
        return DenseMatrix(self.data.conj())

    conj = conjugate

    def inv(self) -> "DenseMatrix":
        return DenseMatrix(inv_qr(self.data))

    def gram(self) -> "DenseMatrix":
        d = self.data
        return DenseMatrix(d.conj().T @ d)

    def matvec(self, v):
        v = _asarray(v)
        return jnp.tensordot(_match_precision(self.data, v.dtype), v,
                             axes=((1,), (0,)),
                             precision=MATMUL_PRECISION)

    def effective_diagonal(self):
        return None


@jax.tree_util.register_pytree_node_class
class ScaledIdentityMatrix(MatrixBase):
    """c·I, possibly rectangular (zero off the main diagonal).

    Reference: ``matrix.py:124-194``.  ``coeff`` may be a traced 0-d array,
    which is what makes the ADMM penalty ``mu`` a carried scalar instead of a
    hash-keyed cache key.
    """

    def __init__(self, shape: Union[int, Tuple[int, int]], coeff) -> None:
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape), int(shape))
        else:
            shape = (int(shape[0]), int(shape[1]))
        assert _is_scalar(coeff), type(coeff)
        self.shape = shape
        self.coeff = coeff

    def tree_flatten(self):
        return (self.coeff,), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        obj = object.__new__(cls)
        obj.coeff = children[0]
        obj.shape = shape
        return obj

    def hash(self) -> int:
        return matrix_hash(self.coeff)

    def asmatrix(self):
        return _asarray(self.coeff) * jnp.eye(self.shape[0], self.shape[1])

    to_dense = asmatrix

    def _scale(self, c) -> "ScaledIdentityMatrix":
        return ScaledIdentityMatrix(self.shape, self.coeff * c)

    @property
    def T(self) -> "ScaledIdentityMatrix":
        return ScaledIdentityMatrix((self.shape[1], self.shape[0]), self.coeff)

    def conjugate(self) -> "ScaledIdentityMatrix":
        c = self.coeff
        if isinstance(c, (jnp.ndarray, jax.core.Tracer)):
            c = jnp.conjugate(c)
        else:
            c = np.conjugate(c).item() if np.iscomplexobj(c) else c
        return ScaledIdentityMatrix(self.shape, c)

    conj = conjugate

    def inv(self) -> "ScaledIdentityMatrix":
        if not self.is_square():
            raise RuntimeError("A rectangular matrix is not invertible!")
        return ScaledIdentityMatrix(self.shape, 1.0 / self.coeff)

    @property
    def diagonals(self):
        if not self.is_square():
            raise RuntimeError("Diagonals of a rectangular matrix is ill defined!")
        return jnp.full(self.shape[0], self.coeff)

    def to_diagonal_matrix(self) -> "DiagonalMatrix":
        k = min(self.shape)
        return DiagonalMatrix(_asarray(self.coeff) * jnp.ones(k), self.shape)

    def gram(self) -> MatrixBase:
        n, m = self.shape
        c2 = jnp.real(jnp.conjugate(self.coeff) * self.coeff)
        if n >= m:
            return ScaledIdentityMatrix((m, m), c2)
        return DiagonalMatrix(jnp.concatenate([jnp.full(n, c2), jnp.zeros(m - n)]), (m, m))

    def matvec(self, v):
        v = _asarray(v)
        n, m = self.shape
        assert v.shape[0] == m, (self.shape, v.shape)
        if n == m:
            return _match_precision(self.coeff, v.dtype) * v
        return self.to_diagonal_matrix().matvec(v)

    def effective_diagonal(self):
        if not self.is_square():
            return None
        return jnp.full(self.shape[0], self.coeff)


@jax.tree_util.register_pytree_node_class
class DiagonalMatrix(MatrixBase):
    """Diagonal operator with optional rectangular shape.

    Rectangular semantics = truncate/zero-pad, matching
    ``matrix.py:197-298,429-448``.
    """

    def __init__(self, diagonals, shape: Optional[Tuple[int, int]] = None) -> None:
        diagonals = _asarray(diagonals)
        assert diagonals.ndim == 1
        if shape is None:
            shape = (diagonals.shape[0], diagonals.shape[0])
        else:
            shape = (int(shape[0]), int(shape[1]))
        assert min(shape) == diagonals.shape[0], (shape, diagonals.shape)
        self._diagonals = diagonals
        self.shape = shape

    def tree_flatten(self):
        return (self._diagonals,), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        obj = object.__new__(cls)
        obj._diagonals = children[0]
        obj.shape = shape
        return obj

    @property
    def diagonals(self):
        return self._diagonals

    def hash(self) -> int:
        return matrix_hash(np.asarray(self._diagonals))

    def asmatrix(self):
        k = self._diagonals.shape[0]
        out = jnp.zeros(self.shape, dtype=self._diagonals.dtype)
        return out.at[jnp.arange(k), jnp.arange(k)].set(self._diagonals)

    to_dense = asmatrix

    def _scale(self, c) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals * c, self.shape)

    @property
    def T(self) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals, (self.shape[1], self.shape[0]))

    def conjugate(self) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals.conj(), self.shape)

    conj = conjugate

    def inv(self) -> "DiagonalMatrix":
        if not self.is_square():
            raise RuntimeError("Must be a square matrix!")
        return DiagonalMatrix(1.0 / self._diagonals, self.shape)

    def gram(self) -> "DiagonalMatrix":
        n, m = self.shape
        d2 = jnp.real(jnp.conjugate(self._diagonals) * self._diagonals)
        if d2.shape[0] < m:
            d2 = jnp.concatenate([d2, jnp.zeros(m - d2.shape[0], dtype=d2.dtype)])
        return DiagonalMatrix(d2, (m, m))

    def matvec(self, v):
        v = _asarray(v)
        n = self.shape[0]
        assert v.shape[0] == self.shape[1], (self.shape, v.shape)
        k = min(self._diagonals.shape[0], v.shape[0])
        d = _match_precision(self._diagonals[:k], v.dtype)
        scaled = d.reshape((k,) + (1,) * (v.ndim - 1)) * v[:k]
        if n == k:
            return scaled
        pad = [(0, n - k)] + [(0, 0)] * (v.ndim - 1)
        return jnp.pad(scaled, pad)

    def effective_diagonal(self):
        if not self.is_square():
            return None
        return self._diagonals

    def __str__(self) -> str:
        return "DiagonalMatrix: " + str(self._diagonals)


@jax.tree_util.register_pytree_node_class
class PartialDiagonalMatrix(MatrixBase):
    """Kronecker product ``A ⊗ I_rest`` stored as the small factor A.

    Reference: ``matrix.py:301-401``.  The matvec reshapes the operand to
    ``(A.cols, rest, batch)`` and contracts the leading axis — one large
    matmul over the flattened trailing axes.
    """

    def __init__(self, matrix, rest_dims: tuple) -> None:
        matrix = asmatrixtype(matrix)
        self.matrix = matrix
        self.rest_dims = tuple(int(r) for r in rest_dims)
        rest = int(np.prod(self.rest_dims)) if self.rest_dims else 1
        self._rest = rest
        self.shape = (matrix.shape[0] * rest, matrix.shape[1] * rest)

    def tree_flatten(self):
        return (self.matrix,), (self.rest_dims, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.matrix = children[0]
        obj.rest_dims = aux[0]
        obj.shape = aux[1]
        obj._rest = int(np.prod(aux[0])) if aux[0] else 1
        return obj

    def hash(self) -> int:
        return self.matrix.hash()

    def asmatrix(self):
        small = self.matrix.asmatrix()
        eye = jnp.eye(self._rest, dtype=small.dtype)
        return jnp.einsum("IJ,ij->IiJj", small, eye).reshape(self.shape)

    to_dense = asmatrix

    def _scale(self, c) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix * c, self.rest_dims)

    @property
    def T(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.T, self.rest_dims)

    def conjugate(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.conjugate(), self.rest_dims)

    conj = conjugate

    def inv(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.inv(), self.rest_dims)

    def gram(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.gram(), self.rest_dims)

    def matvec(self, v):
        """(A ⊗ I) v; v may carry trailing batch dims (matrix.py:367-401)."""
        v = _asarray(v)
        rest = self._rest
        small = self.matrix
        lead = small.shape[0] * rest
        out_shape = (lead,) + v.shape[1:]
        # (m*rest, batch...) -> (m, rest*batch)
        vr = v.reshape(small.shape[1], -1)
        if isinstance(small, ScaledIdentityMatrix):
            res = _match_precision(small.coeff, vr.dtype) * vr
        elif isinstance(small, DiagonalMatrix):
            res = small.matvec(vr)
        else:
            res = jnp.tensordot(_match_precision(small.asmatrix(), vr.dtype),
                                vr, axes=((1,), (0,)),
                                precision=MATMUL_PRECISION)
        return res.reshape(out_shape)

    def effective_diagonal(self):
        inner = self.matrix.effective_diagonal()
        if inner is None:
            return None
        return jnp.repeat(inner, self._rest)


@jax.tree_util.register_pytree_node_class
class InterleavedComplexDiagonalMatrix(MatrixBase):
    """Real interleaved embedding of a complex diagonal matrix.

    ``diag(a + ib)`` acting on interleaved (Re, Im) coordinates
    (:mod:`admmsolver_tpu.models.realify`) is the real block-diagonal
    matrix with 2×2 blocks ``[[a, -b], [b, a]]`` per entry.  Stored as the
    two real vectors ``re``/``im`` so complex couplings in realified models
    keep an O(n) matvec and — crucially — a *diagonal* Gram:
    ``R(D)† R(D) = diag(|d|²) ⊗ I₂``, which the diagonal-penalty proxes
    (L1 / NonNegative / PSD) require.  Densifying instead (as round 1 did)
    loses the diagonal interpretation and makes such models unsolvable —
    the complex reference handles them fine (E†E stays diagonal,
    ``/root/reference/src/admmsolver/matrix.py:255-295``).

    The matrix is REAL: ``conjugate()`` is the identity; ``T`` maps to the
    embedding of the conjugate diagonal (blocks transpose to
    ``[[a, b], [-b, a]]``).
    """

    def __init__(self, re, im) -> None:
        re = _asarray(re)
        im = _asarray(im)
        assert re.ndim == 1 and re.shape == im.shape, (re.shape, im.shape)
        self.re = re
        self.im = im
        self.shape = (2 * re.shape[0], 2 * re.shape[0])

    def tree_flatten(self):
        return (self.re, self.im), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        obj = object.__new__(cls)
        obj.re, obj.im = children
        obj.shape = shape
        return obj

    def hash(self) -> int:
        return hash((matrix_hash(np.asarray(self.re)),
                     matrix_hash(np.asarray(self.im))))

    def asmatrix(self):
        n = self.re.shape[0]
        out = jnp.zeros(self.shape, dtype=self.re.dtype)
        idx = jnp.arange(n)
        out = out.at[2 * idx, 2 * idx].set(self.re)
        out = out.at[2 * idx + 1, 2 * idx + 1].set(self.re)
        out = out.at[2 * idx, 2 * idx + 1].set(-self.im)
        out = out.at[2 * idx + 1, 2 * idx].set(self.im)
        return out

    to_dense = asmatrix

    def _scale(self, c) -> "InterleavedComplexDiagonalMatrix":
        # Scalar multiply by a REAL scalar (the embedded matrix is real).
        return InterleavedComplexDiagonalMatrix(self.re * c, self.im * c)

    @property
    def T(self) -> "InterleavedComplexDiagonalMatrix":
        return InterleavedComplexDiagonalMatrix(self.re, -self.im)

    def conjugate(self) -> "InterleavedComplexDiagonalMatrix":
        return self  # real-valued matrix

    conj = conjugate

    def inv(self) -> "InterleavedComplexDiagonalMatrix":
        mod2 = self.re * self.re + self.im * self.im
        return InterleavedComplexDiagonalMatrix(self.re / mod2,
                                                -self.im / mod2)

    def gram(self) -> "MatrixBase":
        mod2 = self.re * self.re + self.im * self.im
        return DiagonalMatrix(jnp.repeat(mod2, 2))

    def matvec(self, v):
        v = _asarray(v)
        assert v.shape[0] == self.shape[1], (self.shape, v.shape)
        n = self.re.shape[0]
        vr = v.reshape((n, 2) + v.shape[1:])
        bshape = (n,) + (1,) * (v.ndim - 1)
        a = _match_precision(self.re, v.dtype).reshape(bshape)
        b = _match_precision(self.im, v.dtype).reshape(bshape)
        out_re = a * vr[:, 0] - b * vr[:, 1]
        out_im = b * vr[:, 0] + a * vr[:, 1]
        return jnp.stack([out_re, out_im], axis=1).reshape(v.shape)

    def effective_diagonal(self):
        im = _concrete(self.im)
        if im is not None and not np.any(np.asarray(im)):
            return jnp.repeat(self.re, 2)
        return None


# =====================================================================
# Dispatch: matmul
# =====================================================================


def _shift_fill(vec, s: int, out_len: int):
    """``out[j] = vec[j - s]`` where defined, zero elsewhere (static
    slicing + pad; the band-algebra workhorse)."""
    lo = max(0, s)
    hi = min(out_len, vec.shape[0] + s)
    if hi <= lo:
        return jnp.zeros((out_len,) + vec.shape[1:], dtype=vec.dtype)
    seg = vec[lo - s:hi - s]
    pad = [(lo, out_len - hi)] + [(0, 0)] * (vec.ndim - 1)
    return jnp.pad(seg, pad)


@jax.tree_util.register_pytree_node_class
class BandedMatrix(MatrixBase):
    """Banded operator stored as its diagonals — O(bandwidth · n) memory.

    No reference counterpart as a *type*; it carries the structure-
    exploitation ethos of the reference's matrix layer
    (``matrix.py:301-401``) to stencil couplings (TV differences,
    smoothness regularizers, ``utils.second_deriv_prj``) whose dense
    Gram would be O(N²): with banded operators the ``Model`` precompute
    ``EcE2 = D†D`` stays banded (band algebra below), and the ADMM
    factor path solves the resulting tridiagonal systems by cyclic
    reduction (:func:`tridiag_cr_factor`) in O(N log N) — no dense
    N × N operator or factor ever materializes.

    Storage: ``offsets`` — static, sorted, unique ints; ``bands`` of
    shape ``(len(offsets), M)`` with ``bands[k, i] = A[i, i + offsets[k]]``
    (row-indexed).  INVARIANT: positions whose column ``i + o`` falls
    outside ``[0, N)`` are stored as zero — every constructor below
    maintains it, and the band algebra relies on it.
    """

    def __init__(self, offsets, bands,
                 shape: Optional[Tuple[int, int]] = None) -> None:
        offsets = tuple(int(o) for o in offsets)
        assert len(set(offsets)) == len(offsets), offsets
        assert tuple(sorted(offsets)) == offsets, offsets
        bands = _asarray(bands)
        assert bands.ndim == 2 and bands.shape[0] == len(offsets), \
            (bands.shape, offsets)
        if shape is None:
            shape = (bands.shape[1], bands.shape[1])
        shape = (int(shape[0]), int(shape[1]))
        assert bands.shape[1] == shape[0], (bands.shape, shape)
        self.offsets = offsets
        self.bands = bands
        self.shape = shape
        # enforce the out-of-range-is-zero invariant on concrete values;
        # traced bands are trusted (internal callers maintain it)
        cb = _concrete(bands)
        if cb is not None:
            M, N = shape
            for k, o in enumerate(offsets):
                lo = max(0, -o)
                hi = min(M, N - o)
                assert not (np.any(cb[k, :lo]) or np.any(cb[k, hi:])), (
                    f"band at offset {o} has nonzero entries outside the "
                    f"valid row range [{lo}, {hi})")

    @staticmethod
    def from_dense(a, offsets=None) -> "BandedMatrix":
        """Extract bands from a (concrete) dense matrix; ``offsets``
        defaults to every nonzero diagonal."""
        a = np.asarray(a)
        M, N = a.shape
        if offsets is None:
            offsets = [o for o in range(-M + 1, N)
                       if np.any(np.diagonal(a, o))]
            if not offsets:
                offsets = [0]
        bands = np.zeros((len(offsets), M), a.dtype)
        for k, o in enumerate(sorted(int(o) for o in offsets)):
            lo = max(0, -o)
            hi = min(M, N - o)
            if hi > lo:
                bands[k, lo:hi] = np.diagonal(a, o)
        return BandedMatrix(sorted(int(o) for o in offsets), bands,
                            (M, N))

    def tree_flatten(self):
        return (self.bands,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.offsets, obj.shape = aux
        obj.bands = children[0]
        return obj

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets)

    def hash(self) -> int:
        return hash((self.offsets, self.shape,
                     matrix_hash(np.asarray(self.bands))))

    def asmatrix(self):
        M, N = self.shape
        out = jnp.zeros((M, N), dtype=self.bands.dtype)
        for k, o in enumerate(self.offsets):
            lo = max(0, -o)
            hi = min(M, N - o)
            if hi > lo:
                i = jnp.arange(lo, hi)
                out = out.at[i, i + o].set(self.bands[k, lo:hi])
        return out

    to_dense = asmatrix

    def _scale(self, c) -> "BandedMatrix":
        return BandedMatrix(self.offsets, self.bands * c, self.shape)

    def conjugate(self) -> "BandedMatrix":
        return BandedMatrix(self.offsets, self.bands.conj(), self.shape)

    conj = conjugate

    @property
    def T(self) -> "BandedMatrix":
        # T[j, j - o] = A[j - o, j]: the band at offset -o, row-shifted
        M, N = self.shape
        offs = tuple(sorted(-o for o in self.offsets))
        pos = {o: k for k, o in enumerate(self.offsets)}
        rows = [_shift_fill(self.bands[pos[-o]], -o, N) for o in offs]
        return BandedMatrix(offs, jnp.stack(rows), (N, M))

    def inv(self) -> MatrixBase:
        """Dense inverse — banded inverses are dense; only sensible for
        small N (the factor path never calls this: tridiagonal systems
        go through :func:`tridiag_cr_factor`)."""
        if not self.is_square():
            raise RuntimeError("Must be a square matrix!")
        return DenseMatrix(inv_qr(self.asmatrix()))

    def matvec(self, v):
        v = _asarray(v)
        M, N = self.shape
        assert v.shape[0] == N, (self.shape, v.shape)
        out = None
        for k, o in enumerate(self.offsets):
            lo = max(0, -o)
            hi = min(M, N - o)
            if hi <= lo:
                continue
            band = _match_precision(self.bands[k, lo:hi], v.dtype)
            seg = band.reshape((hi - lo,) + (1,) * (v.ndim - 1)) \
                * v[lo + o:hi + o]
            pad = [(lo, M - hi)] + [(0, 0)] * (v.ndim - 1)
            term = jnp.pad(seg, pad)
            out = term if out is None else out + term
        if out is None:
            out = jnp.zeros((M,) + v.shape[1:], dtype=v.dtype)
        return out

    def effective_diagonal(self):
        if not self.is_square():
            return None
        if self.offsets == (0,):
            return self.bands[0]
        # off-diagonal bands that are concretely zero don't spoil it
        for k, o in enumerate(self.offsets):
            if o == 0:
                continue
            cb = _concrete(self.bands[k])
            if cb is None or np.any(np.asarray(cb)):
                return None
        return self.bands[self.offsets.index(0)]

    def _matmul_banded(self, b: "BandedMatrix") -> "BandedMatrix":
        """(A @ B) stays banded: C[i, i+oa+ob] += A[i, i+oa]·B[i+oa, ·].

        Relies on the stored-zero invariant: out-of-range B entries are
        zero, so boundary terms vanish without masking."""
        M = self.shape[0]
        terms: dict = {}
        for ka, oa in enumerate(self.offsets):
            for kb, ob in enumerate(b.offsets):
                o = oa + ob
                t = self.bands[ka] * _shift_fill(b.bands[kb], -oa, M)
                terms[o] = t if o not in terms else terms[o] + t
        offs = tuple(sorted(terms))
        return BandedMatrix(offs, jnp.stack([terms[o] for o in offs]),
                            (M, b.shape[1]))

    def __str__(self) -> str:
        return f"BandedMatrix(offsets={self.offsets}, shape={self.shape})"


@jax.tree_util.register_pytree_node_class
class TridiagFactor:
    """Cyclic-reduction factorization of a tridiagonal system.

    The batched answer to "solve (alpha·A†A + mu·D†D + ...) x = b when the
    operator is tridiagonal": a dense inverse would be O(N²) memory and
    O(N³) refactor (the engine's path for dense quadratic blocks), and
    the classic Thomas algorithm is a length-N sequential recurrence —
    poison for a vector machine.  Cyclic reduction eliminates the odd
    rows level by level: log2(N) levels, each a handful of full-width
    elementwise multiplies + static strided slices (no
    data-dependent control flow), O(N) total work per solve and O(N)
    factor state.  Stable without pivoting for the SPD systems the ADMM
    factor path produces.  Unrolled over levels at trace time (N is
    static), batched/vmapped transparently (all ops are elementwise on
    the row axis).

    Built by :func:`tridiag_cr_factor`; apply with ``factor @ rhs``
    (the factor-protocol convention, ``_apply_B``).
    """

    def __init__(self, levels, d_final, n: int, sizes) -> None:
        self.levels = tuple(levels)
        self.d_final = d_final
        self.n = int(n)
        # pre-padding row count of each level (static): the backward
        # pass trims each reconstructed level to it
        self.sizes = tuple(int(m) for m in sizes)

    def tree_flatten(self):
        return (self.levels, self.d_final), (self.n, self.sizes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.levels, obj.d_final = children
        obj.n, obj.sizes = aux
        return obj

    def __matmul__(self, rhs):
        return tridiag_cr_solve(self, rhs)


def _cr_prev(x, fill=0.0):
    """x shifted down one: out[j] = x[j-1], out[0] = fill."""
    pad = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x[:-1], pad, constant_values=fill)


def _cr_next(x, fill=0.0):
    """x shifted up one: out[j] = x[j+1], out[-1] = fill."""
    pad = [(0, 1)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x[1:], pad, constant_values=fill)


def _tridiag_cr_factor_impl(dl, d, du) -> TridiagFactor:
    dl, d, du = _asarray(dl), _asarray(d), _asarray(du)
    n = d.shape[0]
    # mask the never-used corner entries so they can't pollute level 0
    dl = dl.at[0].set(0.0) if n else dl
    du = du.at[n - 1].set(0.0) if n else du
    levels = []
    sizes = []
    while d.shape[0] > 1:
        m = d.shape[0]
        sizes.append(m)
        if m % 2:
            # decoupled identity padding row keeps every level even
            one = jnp.ones(1, dtype=d.dtype)
            zero = jnp.zeros(1, dtype=d.dtype)
            d = jnp.concatenate([d, one])
            dl = jnp.concatenate([dl, zero])
            du = jnp.concatenate([du, zero])
            m += 1
        d_e, d_o = d[0::2], d[1::2]
        dl_e, dl_o = dl[0::2], dl[1::2]
        du_e, du_o = du[0::2], du[1::2]
        alpha = dl_e / _cr_prev(d_o, fill=1.0)
        beta = du_e / d_o
        d_new = d_e - alpha * _cr_prev(du_o) - beta * dl_o
        dl_new = -alpha * _cr_prev(dl_o)
        du_new = -beta * du_o
        levels.append((alpha, beta, dl_o, d_o, du_o))
        dl, d, du = dl_new, d_new, du_new
    return TridiagFactor(levels, d, n, sizes)


def _tridiag_cr_solve_impl(factor: TridiagFactor, rhs):
    rhs = _asarray(rhs)
    assert rhs.shape[0] == factor.n, (rhs.shape, factor.n)
    # Precision follows the state dtype (CLAUDE.md invariant): f64-stored
    # bands (e.g. D†D built from numpy f64) must not promote an
    # f32-phase rhs to emulated f64.  Constant-folded by XLA.
    factor = jax.tree_util.tree_map(
        lambda a: _match_precision(a, rhs.dtype), factor)
    extra = (1,) * (rhs.ndim - 1)

    b = rhs
    b_odds = []
    for alpha, beta, dl_o, d_o, du_o in factor.levels:
        if b.shape[0] % 2:
            pad = [(0, 1)] + [(0, 0)] * (b.ndim - 1)
            b = jnp.pad(b, pad)
        b_e, b_o = b[0::2], b[1::2]
        b_odds.append(b_o)
        r = lambda x: x.reshape(x.shape + extra) if x.ndim == 1 else x
        b = b_e - r(alpha) * _cr_prev(b_o) - r(beta) * b_o

    x = b / (factor.d_final.reshape(factor.d_final.shape + extra)
             if factor.d_final.ndim == 1 else factor.d_final)
    for (alpha, beta, dl_o, d_o, du_o), b_o, m_orig in zip(
            reversed(factor.levels), reversed(b_odds),
            reversed(factor.sizes)):
        r = lambda x_: x_.reshape(x_.shape + extra) if x_.ndim == 1 else x_
        # x of kept (even) rows is `x`; eliminated odd rows recover as
        # x_o = (b_o - dl_o x_prev_even - du_o x_next_even) / d_o
        x_o = (b_o - r(dl_o) * x - r(du_o) * _cr_next(x)) / r(d_o)
        m2 = x.shape[0] + x_o.shape[0]
        out = jnp.zeros((m2,) + x.shape[1:], dtype=x.dtype)
        out = out.at[0::2].set(x)
        out = out.at[1::2].set(x_o)
        x = out[:m_orig]
    return x


# Public entry points run the cascade UNDER JIT even when called
# eagerly: this build's XLA:CPU eager (op-by-op) path intermittently
# corrupts the heap on the pad/strided-update sequence the cascade
# emits (malloc/free aborts, reproduced round 4; the jitted program is
# stable and is the only path the engine uses anyway).  Under an outer
# jit/vmap the wrapper inlines.
_tridiag_cr_factor_jit = jax.jit(_tridiag_cr_factor_impl)
_tridiag_cr_solve_jit = jax.jit(_tridiag_cr_solve_impl)


def tridiag_cr_factor(dl, d, du) -> TridiagFactor:
    """Precompute the cyclic-reduction cascade for ``T x = b``.

    ``dl[i] = T[i, i-1]`` (``dl[0]`` ignored/zero), ``d[i] = T[i, i]``,
    ``du[i] = T[i, i+1]`` (``du[-1]`` ignored/zero); each ``(n,)``.
    The cascade (per-level α, β and the eliminated rows' coefficients)
    depends only on the matrix, so it is computed once per penalty
    update; :func:`tridiag_cr_solve` then runs the O(N) forward/backward
    passes per right-hand side.
    """
    return _tridiag_cr_factor_jit(_asarray(dl), _asarray(d), _asarray(du))


def tridiag_cr_solve(factor: TridiagFactor, rhs):
    """Solve with a precomputed :class:`TridiagFactor`.

    ``rhs``: ``(n,)`` or ``(n, *trailing)`` (row axis first, matching
    the matvec convention of this module)."""
    return _tridiag_cr_solve_jit(factor, _asarray(rhs))


def matmul(a: MatrixBase, b: MatrixBase) -> MatrixBase:
    """Structure-preserving a @ b (reference dispatch outcomes)."""
    assert a.shape[1] == b.shape[0], (a.shape, b.shape)

    # Normalize ScaledIdentity on the left to Diagonal (matrix.py:184-187),
    # keeping exact SI fast paths first.
    if isinstance(a, ScaledIdentityMatrix) and isinstance(b, ScaledIdentityMatrix) \
            and a.is_square() and b.is_square():
        return ScaledIdentityMatrix(a.shape, a.coeff * b.coeff)
    if isinstance(a, ScaledIdentityMatrix) and a.is_square():
        # Square c·I on the left is a scalar multiply; this reproduces every
        # reference dispatch outcome for SI @ X (matrix.py:184-187) without
        # materializing the diagonal.
        return b._scale(a.coeff)
    if isinstance(a, ScaledIdentityMatrix):
        return matmul(a.to_diagonal_matrix(), b)

    if isinstance(a, InterleavedComplexDiagonalMatrix):
        if isinstance(b, InterleavedComplexDiagonalMatrix):
            # Complex-diagonal product in real arithmetic.  When the
            # product is concretely real (e.g. the Hermitian Gram
            # R(D)† R(D) in the Model's EcE precompute) collapse to a
            # plain diagonal so penalty structure survives; the collapse
            # fires only on concrete values, like the other blockwise
            # checks in this module.
            re = a.re * b.re - a.im * b.im
            im = a.re * b.im + a.im * b.re
            cim = _concrete(im)
            if cim is not None and not np.any(np.asarray(cim)):
                return DiagonalMatrix(jnp.repeat(re, 2))
            return InterleavedComplexDiagonalMatrix(re, im)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return a._scale(b.coeff)
        return DenseMatrix(a.matvec(b.asmatrix()))

    if isinstance(a, DenseMatrix):
        if isinstance(b, ScaledIdentityMatrix):
            return matmul(a, b.to_diagonal_matrix())
        if isinstance(b, DiagonalMatrix):
            # Column scaling with truncate/pad (matrix.py:109-116).
            k = min(b.shape)
            out = jnp.zeros((a.shape[0], b.shape[1]),
                            dtype=jnp.result_type(a.data.dtype, b.diagonals.dtype))
            out = out.at[:, :k].set(a.data[:, :k] * b.diagonals[None, :])
            return DenseMatrix(out)
        return DenseMatrix(a.data @ b.asmatrix())

    if isinstance(a, DiagonalMatrix):
        if isinstance(b, ScaledIdentityMatrix):
            return matmul(a, b.to_diagonal_matrix())
        if isinstance(b, DenseMatrix):
            # Row scaling with truncate/pad.
            k = min(a.shape)
            out = jnp.zeros((a.shape[0], b.shape[1]),
                            dtype=jnp.result_type(a.diagonals.dtype, b.data.dtype))
            out = out.at[:k, :].set(a.diagonals[:, None] * b.data[:k, :])
            return DenseMatrix(out)
        if isinstance(b, DiagonalMatrix):
            out_shape = (a.shape[0], b.shape[1])
            k = min(a.diagonals.shape[0], b.diagonals.shape[0])
            prod = a.diagonals[:k] * b.diagonals[:k]
            size = min(out_shape)
            if prod.shape[0] < size:
                prod = jnp.concatenate([prod, jnp.zeros(size - k, dtype=prod.dtype)])
            return DiagonalMatrix(prod, out_shape)
        if isinstance(b, PartialDiagonalMatrix):
            # Collapse to Kronecker form when blockwise constant
            # (matrix.py:283-291); only decidable with concrete values.
            cd = _concrete(a.diagonals)
            if cd is not None and a.is_square():
                blocks = cd.reshape(b.matrix.shape[0], -1)
                if np.allclose(blocks, blocks[:, :1]):
                    scaled = matmul(
                        DiagonalMatrix(jnp.asarray(blocks[:, 0])), _as_dense(b.matrix))
                    return PartialDiagonalMatrix(scaled, b.rest_dims)
            return DenseMatrix(a.matvec(b.asmatrix()))
        if isinstance(b, BandedMatrix) and a.is_square():
            # row scaling keeps bands
            return BandedMatrix(b.offsets,
                                b.bands * a.diagonals[None, :],
                                b.shape)
        return DenseMatrix(a.matvec(b.asmatrix()))

    if isinstance(a, BandedMatrix):
        if isinstance(b, BandedMatrix):
            return a._matmul_banded(b)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return a._scale(b.coeff)
        if isinstance(b, DiagonalMatrix) and b.is_square():
            # column scaling: band at offset o picks up d[i + o]
            M = a.shape[0]
            rows = [a.bands[k] * _shift_fill(b.diagonals, -o, M)
                    for k, o in enumerate(a.offsets)]
            return BandedMatrix(a.offsets, jnp.stack(rows), a.shape)
        return DenseMatrix(a.asmatrix() @ b.asmatrix())

    if isinstance(a, PartialDiagonalMatrix):
        if isinstance(b, PartialDiagonalMatrix) and a.rest_dims == b.rest_dims:
            return PartialDiagonalMatrix(matmul(a.matrix, b.matrix), a.rest_dims)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return PartialDiagonalMatrix(a.matrix * b.coeff, a.rest_dims)
        return DenseMatrix(a.matvec(b.asmatrix()))

    return DenseMatrix(a.asmatrix() @ b.asmatrix())


def _as_dense(m: MatrixBase) -> DenseMatrix:
    return m if isinstance(m, DenseMatrix) else DenseMatrix(m.asmatrix())


# =====================================================================
# Dispatch: add
# =====================================================================


def add(a: MatrixBase, b: MatrixBase) -> MatrixBase:
    """Structure-preserving a + b (reference ``matrix.py:453-513``)."""
    assert isinstance(a, MatrixBase) and isinstance(b, MatrixBase), (type(a), type(b))
    assert a.shape == b.shape, (a.shape, b.shape)

    for x, y in ((a, b), (b, a)):
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, ScaledIdentityMatrix):
            return ScaledIdentityMatrix(x.shape, x.coeff + y.coeff)
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, DiagonalMatrix):
            if x.is_square():
                return DiagonalMatrix(_asarray(x.coeff) + y.diagonals, y.shape)
            return add(x.to_diagonal_matrix(), y)
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, PartialDiagonalMatrix):
            if x.is_square():
                inner = add(
                    ScaledIdentityMatrix(y.matrix.shape[0], x.coeff), y.matrix)
                return PartialDiagonalMatrix(inner, y.rest_dims)
        if isinstance(x, DiagonalMatrix) and isinstance(y, DiagonalMatrix):
            return DiagonalMatrix(x.diagonals + y.diagonals, x.shape)
        if isinstance(x, DiagonalMatrix) and isinstance(y, PartialDiagonalMatrix):
            # Collapse when blockwise constant (matrix.py:461-468).
            eff = y.matrix.effective_diagonal()
            if eff is not None and x.is_square():
                return add(x, DiagonalMatrix(jnp.repeat(eff, y._rest), x.shape))
            cd = _concrete(x.diagonals)
            if cd is not None and x.is_square():
                blocks = cd.reshape(y.matrix.shape[0], -1)
                if np.allclose(blocks, blocks[:, :1]):
                    inner = add(DiagonalMatrix(jnp.asarray(blocks[:, 0])), y.matrix)
                    return PartialDiagonalMatrix(inner, y.rest_dims)
        if isinstance(x, InterleavedComplexDiagonalMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix):
            return InterleavedComplexDiagonalMatrix(x.re + y.re,
                                                    x.im + y.im)
        if isinstance(x, ScaledIdentityMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix):
            if x.is_square():
                return InterleavedComplexDiagonalMatrix(
                    y.re + _asarray(x.coeff), y.im)
        if isinstance(x, DiagonalMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix):
            # Valid in structured form only when the diagonal is constant
            # over each (Re, Im) pair — concrete-value check, as above.
            cd = _concrete(x.diagonals)
            if cd is not None and x.is_square():
                blocks = np.asarray(cd).reshape(-1, 2)
                if np.allclose(blocks[:, 0], blocks[:, 1]):
                    return InterleavedComplexDiagonalMatrix(
                        y.re + jnp.asarray(blocks[:, 0]), y.im)
        if isinstance(x, PartialDiagonalMatrix) and isinstance(y, PartialDiagonalMatrix):
            if x.rest_dims == y.rest_dims:
                return PartialDiagonalMatrix(add(x.matrix, y.matrix), x.rest_dims)
            break
        if isinstance(x, BandedMatrix) and isinstance(y, BandedMatrix):
            offs = tuple(sorted(set(x.offsets) | set(y.offsets)))
            px = {o: k for k, o in enumerate(x.offsets)}
            py = {o: k for k, o in enumerate(y.offsets)}
            M = x.shape[0]
            z = jnp.zeros(M, dtype=jnp.result_type(x.bands.dtype,
                                                   y.bands.dtype))
            rows = [(x.bands[px[o]] if o in px else z)
                    + (y.bands[py[o]] if o in py else z) for o in offs]
            return BandedMatrix(offs, jnp.stack(rows), x.shape)
        if isinstance(x, BandedMatrix) and x.is_square() and (
                isinstance(y, ScaledIdentityMatrix)
                or isinstance(y, DiagonalMatrix)):
            dvec = (jnp.broadcast_to(_asarray(y.coeff), (x.shape[0],))
                    if isinstance(y, ScaledIdentityMatrix)
                    else y.diagonals)
            # Promote like the dense fallback (result_type), never
            # downcast the diagonal to the band dtype.
            rdt = jnp.result_type(x.bands.dtype, dvec.dtype)
            bands0 = x.bands.astype(rdt)
            dvec = dvec.astype(rdt)
            if 0 in x.offsets:
                k = x.offsets.index(0)
                bands = bands0.at[k].add(dvec)
                return BandedMatrix(x.offsets, bands, x.shape)
            offs = tuple(sorted(x.offsets + (0,)))
            px = {o: k for k, o in enumerate(x.offsets)}
            rows = [bands0[px[o]] if o in px else dvec for o in offs]
            return BandedMatrix(offs, jnp.stack(rows), x.shape)

    return DenseMatrix(a.asmatrix() + b.asmatrix())


# =====================================================================
# Helpers
# =====================================================================


def identity(n, dtype=np.float64) -> ScaledIdentityMatrix:
    """Identity as a scaled-identity operator (matrix.py:404-408)."""
    return ScaledIdentityMatrix(int(n), dtype(1.0))


def matrix_hash(a) -> int:
    """Hash of concrete matrix content (matrix.py:411-418).

    Only meaningful for concrete values; the engine does not use hashes
    for caching (refactorization follows a static schedule instead), this
    exists for API parity and host-side memoization.
    """
    if isinstance(a, MatrixBase):
        return a.hash()
    c = _concrete(a)
    if c is None:
        raise TypeError("matrix_hash of a traced value is undefined")
    if c.ndim == 0:
        return hash(complex(c))
    return hash(c.tobytes())


def asmatrixtype(a) -> MatrixBase:
    """Coerce 2-D arrays to DenseMatrix (matrix.py:421-426)."""
    if isinstance(a, MatrixBase):
        return a
    a = _asarray(a)
    assert a.ndim == 2
    return DenseMatrix(a)


def _vecprod(v1, v2, size: int):
    """Elementwise product truncated to the shorter vector and zero-padded
    on the right to ``size`` (rectangular-diagonal product semantics,
    matrix.py:429-439)."""
    v1, v2 = _asarray(v1), _asarray(v2)
    k = min(v1.shape[0], v2.shape[0])
    return _pad_by_zero(v1[:k] * v2[:k], size)


def _pad_by_zero(arr, size: int):
    """Right-pad a vector with zeros to ``size`` (matrix.py:442-448)."""
    arr = _asarray(arr)
    assert arr.shape[0] <= size
    if arr.shape[0] == size:
        return arr
    return jnp.concatenate(
        [arr, jnp.zeros(size - arr.shape[0], dtype=arr.dtype)])
