"""Structured-operator tests: every op checked against the dense oracle
(reference idiom #2, ``/root/reference/test/test_matrix.py``)."""
import numpy as np
import jax.numpy as jnp
import pytest

from admmsolver_tpu.ops.linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    PartialDiagonalMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
    matmul,
)


def _randn_cmplx(rng, *shape):
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _dense(m):
    return np.asarray(m.asmatrix())


def test_matmul_tall():
    rng = np.random.RandomState(100)
    n1, n2, n3 = 12, 12, 4
    left = [
        DiagonalMatrix(jnp.ones(n1)),
        ScaledIdentityMatrix(n1, 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 3, 3), rest_dims=(4,)),
        DenseMatrix(_randn_cmplx(rng, n1, n2)),
    ]
    right = [
        DenseMatrix(_randn_cmplx(rng, n2, n3)),
        ScaledIdentityMatrix((n2, n3), 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 3, 1), rest_dims=(4,)),
    ]
    for l in left:
        for r in right:
            lr = l @ r
            assert isinstance(lr, MatrixBase)
            np.testing.assert_allclose(
                _dense(lr), _dense(l) @ _dense(r), atol=1e-12)


def test_matmul_wide():
    rng = np.random.RandomState(100)
    n1, n2, n3 = 4, 12, 12
    left = [
        DenseMatrix(_randn_cmplx(rng, n1, n2)),
        PartialDiagonalMatrix(_randn_cmplx(rng, 1, 3), rest_dims=(4,)),
    ]
    right = [
        DiagonalMatrix(jnp.ones(n3)),
        ScaledIdentityMatrix(n3, 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 3, 3), rest_dims=(4,)),
        DenseMatrix(_randn_cmplx(rng, n2, n3)),
    ]
    for l in left:
        for r in right:
            lr = l @ r
            assert isinstance(lr, MatrixBase)
            np.testing.assert_allclose(
                _dense(lr), _dense(l) @ _dense(r), atol=1e-12)


def test_scale_transpose_conj():
    rng = np.random.RandomState(100)
    n1, n2 = 4, 12
    mats = [
        DiagonalMatrix(jnp.ones(n1)),
        DiagonalMatrix(jnp.ones(n1), shape=(n1, n2)),
        ScaledIdentityMatrix(n1, 1 + 1j),
        ScaledIdentityMatrix((n1, n2), 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 3, 3), rest_dims=(4,)),
        DenseMatrix(_randn_cmplx(rng, n1, n2)),
    ]
    c = 1 + 0.1j
    for m in mats:
        np.testing.assert_allclose(_dense(c * m), c * _dense(m), atol=1e-12)
        np.testing.assert_allclose(_dense(m.T), _dense(m).T, atol=1e-12)
        np.testing.assert_allclose(_dense(m.conj()), _dense(m).conj(),
                                   atol=1e-12)
        np.testing.assert_allclose(_dense(-m), -_dense(m), atol=1e-12)
        np.testing.assert_allclose(_dense(m.H), _dense(m).conj().T,
                                   atol=1e-12)


def test_add_all_pairs():
    rng = np.random.RandomState(100)
    n = 2
    mats = [
        DiagonalMatrix(jnp.ones(n)),
        ScaledIdentityMatrix(n, 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, n, n), (1, 1)),
        DenseMatrix(_randn_cmplx(rng, n, n)),
    ]
    for a in mats:
        for b in mats:
            s = a + b
            assert isinstance(s, MatrixBase)
            np.testing.assert_allclose(
                _dense(s), _dense(a) + _dense(b), atol=1e-12)
            d = a - b
            np.testing.assert_allclose(
                _dense(d), _dense(a) - _dense(b), atol=1e-12)


def test_add_diagonal_partial_collapses():
    """Blockwise-constant Diagonal + KroneckerI stays Kronecker
    (reference matrix.py:461-468)."""
    rng = np.random.RandomState(100)
    n = 3
    d = rng.randn(n)
    diags = np.repeat(d, 4)
    a = DiagonalMatrix(jnp.asarray(diags))
    b = PartialDiagonalMatrix(_randn_cmplx(rng, n, n), (2, 2))
    ab = a + b
    assert isinstance(ab, PartialDiagonalMatrix)
    np.testing.assert_allclose(_dense(ab), _dense(a) + _dense(b), atol=1e-12)


def test_matmul_diagonal_partial_collapses():
    """Blockwise-constant Diagonal @ KroneckerI stays Kronecker
    (reference matrix.py:283-291)."""
    rng = np.random.RandomState(100)
    n = 3
    diags = np.repeat(rng.randn(n), 4)
    a = DiagonalMatrix(jnp.asarray(diags))
    b = PartialDiagonalMatrix(_randn_cmplx(rng, n, n), (2, 2))
    ab = a @ b
    assert isinstance(ab, PartialDiagonalMatrix)
    np.testing.assert_allclose(_dense(ab), _dense(a) @ _dense(b), atol=1e-12)


def test_partial_partial_add_matmul():
    rng = np.random.RandomState(100)
    n = 3
    a = PartialDiagonalMatrix(_randn_cmplx(rng, n, n), (2, 2))
    b = PartialDiagonalMatrix(_randn_cmplx(rng, n, n), (2, 2))
    ab = a + b
    assert isinstance(ab, PartialDiagonalMatrix)
    np.testing.assert_allclose(_dense(ab), _dense(a) + _dense(b), atol=1e-12)
    ab = matmul(a, b)
    assert isinstance(ab, PartialDiagonalMatrix)
    np.testing.assert_allclose(_dense(ab), _dense(a) @ _dense(b), atol=1e-12)


def test_inv():
    rng = np.random.RandomState(100)
    n = 4
    mats = [
        DiagonalMatrix(jnp.ones(n)),
        ScaledIdentityMatrix(n, 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 2, 2), (2,)),
        DenseMatrix(_randn_cmplx(rng, n, n)),
    ]
    for m in mats:
        im = m.inv()
        assert isinstance(im, MatrixBase)
        np.testing.assert_allclose(
            _dense(im) @ _dense(m), np.identity(n), rtol=0, atol=1e-12)


def test_inv_rectangular_raises():
    with pytest.raises(RuntimeError):
        ScaledIdentityMatrix((2, 4), 1.0).inv()
    with pytest.raises(RuntimeError):
        DiagonalMatrix(jnp.ones(2), (2, 4)).inv()


def test_matvec_square():
    rng = np.random.RandomState(100)
    n = 4
    mats = [
        DiagonalMatrix(jnp.ones(n)),
        ScaledIdentityMatrix(n, 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 2, 2), (2,)),
        PartialDiagonalMatrix(ScaledIdentityMatrix(2, 1.0), (2,)),
        DenseMatrix(_randn_cmplx(rng, n, n)),
    ]
    vec = np.ones(n)
    for m in mats:
        mv = m @ vec
        assert not isinstance(mv, MatrixBase)
        np.testing.assert_allclose(np.asarray(mv), _dense(m) @ vec,
                                   atol=1e-12)


@pytest.mark.parametrize("n,m", [(2, 4), (4, 2)])
def test_matvec_rectangular(n, m):
    rng = np.random.RandomState(100)
    mats = [
        DiagonalMatrix(jnp.ones(min(n, m)), shape=(n, m)),
        ScaledIdentityMatrix((n, m), 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, n // 2, m // 2), (2,)),
        PartialDiagonalMatrix(
            DiagonalMatrix(jnp.asarray(_randn_cmplx(rng, min(n // 2, m // 2))),
                           (n // 2, m // 2)),
            (2,)),
        DenseMatrix(_randn_cmplx(rng, n, m)),
    ]
    vec = np.ones(m)
    for mat in mats:
        mv = mat @ vec
        np.testing.assert_allclose(np.asarray(mv), _dense(mat) @ vec,
                                   atol=1e-12)


@pytest.mark.parametrize("n,m", [(2, 4), (4, 2)])
def test_batched_matvec(n, m):
    """Trailing batch dims ride through every structure
    (reference test_matrix.py:213-233)."""
    rng = np.random.RandomState(100)
    nbatch = 3
    mats = [
        DiagonalMatrix(jnp.ones(min(n, m)), shape=(n, m)),
        ScaledIdentityMatrix((n, m), 1 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, n // 2, m // 2), (2,)),
        PartialDiagonalMatrix(
            DiagonalMatrix(jnp.asarray(_randn_cmplx(rng, min(n // 2, m // 2))),
                           (n // 2, m // 2)),
            (2,)),
        DenseMatrix(_randn_cmplx(rng, n, m)),
    ]
    vec = _randn_cmplx(rng, m, nbatch)
    for mat in mats:
        mv = mat @ vec
        np.testing.assert_allclose(np.asarray(mv), _dense(mat) @ vec,
                                   atol=1e-12)


def test_matmul_rectangular_diagonals():
    rng = np.random.RandomState(100)
    a = DiagonalMatrix(jnp.asarray(rng.randn(2)), shape=(4, 2))
    b = DiagonalMatrix(jnp.asarray(rng.randn(2)), shape=(2, 4))
    ab = a @ b
    assert isinstance(ab, DiagonalMatrix)
    ab_ref = np.zeros(4)
    ab_ref[:2] = np.asarray(a.diagonals) * np.asarray(b.diagonals)
    np.testing.assert_allclose(np.asarray(ab.diagonals), ab_ref)


def test_identity_and_coercion():
    e = identity(3)
    assert isinstance(e, ScaledIdentityMatrix)
    np.testing.assert_allclose(_dense(e), np.eye(3))
    d = asmatrixtype(np.ones((2, 2)))
    assert isinstance(d, DenseMatrix)
    assert asmatrixtype(d) is d


def test_matrix_hash():
    a = np.arange(4.0)
    assert matrix_hash(a) == matrix_hash(a.copy())
    assert matrix_hash(2.0) == matrix_hash(2.0)
    m = DiagonalMatrix(jnp.ones(3))
    assert m.hash() == DiagonalMatrix(jnp.ones(3)).hash()


def test_gram():
    rng = np.random.RandomState(100)
    mats = [
        DenseMatrix(_randn_cmplx(rng, 4, 6)),
        DiagonalMatrix(jnp.asarray(_randn_cmplx(rng, 2)), (2, 4)),
        DiagonalMatrix(jnp.asarray(_randn_cmplx(rng, 2)), (4, 2)),
        ScaledIdentityMatrix((6, 4), 2 + 1j),
        ScaledIdentityMatrix((4, 6), 2 + 1j),
        PartialDiagonalMatrix(_randn_cmplx(rng, 3, 2), (2,)),
    ]
    for m in mats:
        g = m.gram()
        np.testing.assert_allclose(
            _dense(g), _dense(m).conj().T @ _dense(m), atol=1e-12)


def test_effective_diagonal():
    d = DiagonalMatrix(jnp.arange(1.0, 4.0))
    np.testing.assert_allclose(np.asarray(d.effective_diagonal()),
                               [1, 2, 3])
    s = ScaledIdentityMatrix(3, 2.0)
    np.testing.assert_allclose(np.asarray(s.effective_diagonal()),
                               [2, 2, 2])
    k = PartialDiagonalMatrix(ScaledIdentityMatrix(2, 3.0), (2,))
    np.testing.assert_allclose(np.asarray(k.effective_diagonal()),
                               [3, 3, 3, 3])
    k2 = PartialDiagonalMatrix(DiagonalMatrix(jnp.asarray([1.0, 2.0])), (3,))
    np.testing.assert_allclose(np.asarray(k2.effective_diagonal()),
                               [1, 1, 1, 2, 2, 2])
    assert DenseMatrix(jnp.ones((2, 2))).effective_diagonal() is None
    assert ScaledIdentityMatrix((2, 3), 1.0).effective_diagonal() is None


def test_vecprod_pad():
    """Rectangular-diagonal helpers (reference test_matrix.py:247-257)."""
    from admmsolver_tpu.ops.linop import _pad_by_zero, _vecprod

    np.testing.assert_allclose(
        np.asarray(_vecprod(np.ones(1), np.ones(2), 3)), [1, 0, 0])
    np.testing.assert_allclose(
        np.asarray(_pad_by_zero(np.ones(1), 3)), [1, 0, 0])


def test_inv_qr():
    """LU-free general inverse (QR + triangular solve)."""
    from admmsolver_tpu.ops.linop import inv_qr

    rng = np.random.RandomState(0)
    for a in [rng.randn(5, 5), _randn_cmplx(rng, 4, 4)]:
        np.testing.assert_allclose(np.asarray(inv_qr(a)) @ a, np.eye(len(a)),
                                   atol=1e-10)


def test_pytree_roundtrip():
    """Operators survive jit boundaries as pytrees with static structure."""
    import jax

    rng = np.random.RandomState(0)
    ops = [
        DenseMatrix(rng.randn(3, 3)),
        DiagonalMatrix(jnp.ones(2), (2, 4)),
        ScaledIdentityMatrix((3, 3), 2.0),
        PartialDiagonalMatrix(rng.randn(2, 2), (3,)),
    ]
    for op in ops:
        leaves, treedef = jax.tree_util.tree_flatten(op)
        op2 = jax.tree_util.tree_unflatten(treedef, leaves)
        np.testing.assert_allclose(_dense(op2), _dense(op))

    @jax.jit
    def apply(op, v):
        return op @ v

    v = jnp.ones(3)
    np.testing.assert_allclose(
        np.asarray(apply(ops[0], v)), _dense(ops[0]) @ np.asarray(v))


def test_inv_hpd_schur():
    """Unrolled Schur-block HPD inverse == np.linalg.inv, batched and
    unbatched, all sizes through the recursion's base cases, badly
    scaled diagonals included (the SpM factor regime)."""
    from admmsolver_tpu.ops.linop import inv_hpd_schur

    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 5, 8, 30, 33, 64):
        Q = rng.randn(n, n)
        M = Q @ Q.T + n * np.eye(n)
        got = np.asarray(inv_hpd_schur(jnp.asarray(M)))
        np.testing.assert_allclose(got, np.linalg.inv(M), rtol=1e-10,
                                   atol=1e-12)
    # batched, with decaying diagonal scaling (IR singular values) and
    # per-lane shifts
    n, B = 30, 7
    D = np.diag(np.exp(-np.linspace(0, 20, n)))
    Q = rng.randn(n, n) * 0.1
    P = Q @ Q.T
    mus = np.logspace(-4, 3, B)
    Ms = np.stack([D + m * np.eye(n) + 0.5 * P for m in mus])
    got = np.asarray(inv_hpd_schur(jnp.asarray(Ms)))
    want = np.linalg.inv(Ms)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-9)
    # complex Hermitian
    n = 12
    Z = rng.randn(n, n) + 1j * rng.randn(n, n)
    M = Z @ Z.conj().T + n * np.eye(n)
    got = np.asarray(inv_hpd_schur(jnp.asarray(M)))
    np.testing.assert_allclose(got, np.linalg.inv(M), rtol=1e-9,
                               atol=1e-12)


class TestInterleavedComplexDiagonal:
    """Real interleaved embedding of complex diagonals (realify support)."""

    def _make(self, rng, n=6):
        from admmsolver_tpu.ops.linop import InterleavedComplexDiagonalMatrix

        d = rng.randn(n) + 1j * rng.randn(n)
        op = InterleavedComplexDiagonalMatrix(d.real.copy(), d.imag.copy())
        return d, op

    def test_matvec_matches_dense(self):
        rng = np.random.RandomState(0)
        d, op = self._make(rng)
        R = np.asarray(op.asmatrix())
        v = rng.randn(12)
        np.testing.assert_allclose(np.asarray(op @ v), R @ v, atol=1e-13)
        vb = rng.randn(12, 3)  # trailing batch dims
        np.testing.assert_allclose(np.asarray(op @ vb), R @ vb, atol=1e-13)

    def test_transpose_conj_inv(self):
        rng = np.random.RandomState(1)
        d, op = self._make(rng)
        R = np.asarray(op.asmatrix())
        np.testing.assert_allclose(np.asarray(op.T.asmatrix()), R.T)
        # the embedded matrix is real: conjugate is the identity
        np.testing.assert_allclose(np.asarray(op.conjugate().asmatrix()), R)
        np.testing.assert_allclose(np.asarray(op.inv().asmatrix()),
                                   np.linalg.inv(R), atol=1e-12)

    def test_hermitian_gram_collapses_to_diagonal(self):
        from admmsolver_tpu.ops.linop import (DiagonalMatrix, matmul)

        rng = np.random.RandomState(2)
        d, op = self._make(rng)
        g = matmul(op.conjugate().T, op)
        assert isinstance(g, DiagonalMatrix)
        np.testing.assert_allclose(np.asarray(g.diagonals),
                                   np.repeat(np.abs(d) ** 2, 2), atol=1e-13)
        assert g.effective_diagonal() is not None
        # .gram() shortcut agrees
        np.testing.assert_allclose(np.asarray(op.gram().diagonals),
                                   np.repeat(np.abs(d) ** 2, 2), atol=1e-13)

    def test_product_and_add_dispatch(self):
        from admmsolver_tpu.ops.linop import (
            InterleavedComplexDiagonalMatrix, ScaledIdentityMatrix, add,
            matmul)

        rng = np.random.RandomState(3)
        d1, op1 = self._make(rng)
        d2, op2 = self._make(rng)
        p = matmul(op1, op2)
        assert isinstance(p, InterleavedComplexDiagonalMatrix)
        np.testing.assert_allclose(
            np.asarray(p.asmatrix()),
            np.asarray(op1.asmatrix()) @ np.asarray(op2.asmatrix()),
            atol=1e-13)
        s = add(op1, op2)
        assert isinstance(s, InterleavedComplexDiagonalMatrix)
        np.testing.assert_allclose(
            np.asarray(s.asmatrix()),
            np.asarray(op1.asmatrix()) + np.asarray(op2.asmatrix()))
        si = ScaledIdentityMatrix(op1.shape[0], 0.7)
        s2 = add(si, op1)
        assert isinstance(s2, InterleavedComplexDiagonalMatrix)
        np.testing.assert_allclose(
            np.asarray(s2.asmatrix()),
            0.7 * np.eye(op1.shape[0]) + np.asarray(op1.asmatrix()))

    def test_effective_diagonal_only_when_real(self):
        rng = np.random.RandomState(4)
        d, op = self._make(rng)
        assert op.effective_diagonal() is None  # genuinely complex
        from admmsolver_tpu.ops.linop import InterleavedComplexDiagonalMatrix

        re_only = InterleavedComplexDiagonalMatrix(
            d.real.copy(), np.zeros_like(d.real))
        np.testing.assert_allclose(np.asarray(re_only.effective_diagonal()),
                                   np.repeat(d.real, 2))

    def test_pytree_roundtrip(self):
        import jax

        rng = np.random.RandomState(5)
        _, op = self._make(rng)
        leaves, treedef = jax.tree_util.tree_flatten(op)
        op2 = jax.tree_util.tree_unflatten(treedef, leaves)
        np.testing.assert_allclose(np.asarray(op2.asmatrix()),
                                   np.asarray(op.asmatrix()))


class TestJacobiEigh:
    """Unrolled cyclic Jacobi vs LAPACK (the PSD-prox eigh replacement;
    XLA's eigh degrades ~1000x under vmap inside solver loop bodies —
    benches/sdp_ablate2.py)."""

    def _sym(self, rng, b, n):
        A = rng.randn(b, n, n)
        return A + A.swapaxes(-1, -2)

    def test_matches_lapack(self):
        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(0)
        for n in (2, 3, 5, 8, 16):
            A = self._sym(rng, 32, n)
            w, v = jacobi_eigh(jnp.asarray(A))
            w0 = np.linalg.eigvalsh(A)
            np.testing.assert_allclose(np.asarray(w), w0,
                                       rtol=0, atol=1e-12)
            V = np.asarray(v)
            recon = np.einsum("bij,bj,blj->bil", V, np.asarray(w), V)
            np.testing.assert_allclose(recon, A, rtol=0, atol=1e-12)
            orth = np.einsum("bji,bjk->bik", V, V)
            np.testing.assert_allclose(orth, np.broadcast_to(
                np.eye(n), orth.shape), rtol=0, atol=1e-12)

    def test_f32_and_multidim_batch(self):
        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(1)
        # n=8 with a multi-dim batch, and n=16 (the top of the supported
        # envelope) — both must hold f32 accuracy at the fixed sweep
        # budget.
        for A in (self._sym(rng, 24, 8).reshape(4, 6, 8, 8),
                  self._sym(rng, 16, 16)):
            w, v = jacobi_eigh(jnp.asarray(A, jnp.float32))
            w0 = np.linalg.eigvalsh(A)
            scale = np.abs(w0).max()
            np.testing.assert_allclose(np.asarray(w), w0,
                                       rtol=0, atol=3e-5 * scale)
            V = np.asarray(v, np.float64)
            recon = np.einsum("...ij,...j,...lj->...il", V,
                              np.asarray(w, np.float64), V)
            np.testing.assert_allclose(recon, A, rtol=0,
                                       atol=3e-5 * scale)

    def test_rejects_complex_and_large_n(self):
        import pytest

        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(5)
        H = rng.randn(2, 4, 4) + 1j * rng.randn(2, 4, 4)
        H = H + H.conj().swapaxes(-1, -2)
        with pytest.raises(TypeError):
            jacobi_eigh(jnp.asarray(H))
        big = self._sym(rng, 2, 257)
        with pytest.raises(ValueError):
            jacobi_eigh(jnp.asarray(big))

    def test_scanned_path_matches_lapack(self):
        """n = 17..256 takes the scan-rolled schedule (_jacobi_eigh_scan)
        — full f64 accuracy at the default sweep budget.  The >64 sizes
        are the round-5 envelope extension (reference handles arbitrary
        slice sizes, objectivefunc.py:322-327)."""
        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(7)
        for n in (17, 32, 33, 48, 64, 96, 128, 256):
            A = self._sym(rng, 8, n)
            w, v = jacobi_eigh(jnp.asarray(A))
            w0 = np.linalg.eigvalsh(A)
            scale = np.abs(w0).max()
            np.testing.assert_allclose(np.asarray(w), w0,
                                       rtol=0, atol=1e-12 * scale)
            V = np.asarray(v)
            recon = np.einsum("bij,bj,blj->bil", V, np.asarray(w), V)
            np.testing.assert_allclose(recon, A, rtol=0,
                                       atol=1e-12 * scale)
            orth = np.einsum("bji,bjk->bik", V, V)
            np.testing.assert_allclose(orth, np.broadcast_to(
                np.eye(n), orth.shape), rtol=0, atol=1e-12)

    def test_scanned_path_f32_and_vmap(self):
        import jax

        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(8)
        A = self._sym(rng, 6, 32)
        w, v = jacobi_eigh(jnp.asarray(A, jnp.float32))
        w0 = np.linalg.eigvalsh(A)
        scale = np.abs(w0).max()
        np.testing.assert_allclose(np.asarray(w), w0, rtol=0,
                                   atol=5e-5 * scale)
        # identical results when traced under jit+vmap (loop-body-safe)
        w_vm, _ = jax.jit(jax.vmap(lambda m: jacobi_eigh(m)))(
            jnp.asarray(A))
        w_ref, _ = jacobi_eigh(jnp.asarray(A))
        np.testing.assert_allclose(np.asarray(w_vm), np.asarray(w_ref),
                                   rtol=0, atol=1e-13)

    def test_svd_via_gram_matches_numpy(self):
        from admmsolver_tpu.ops.linop import svd_via_gram

        rng = np.random.RandomState(9)
        for (m, n) in ((40, 30), (30, 40), (20, 20), (64, 48)):
            x = rng.randn(5, m, n)
            x[0] = np.outer(rng.randn(m), rng.randn(n))  # rank-1 lane
            U, s, Vh = svd_via_gram(jnp.asarray(x))
            rec = np.asarray(jnp.matmul(U * s[..., None, :], Vh))
            np.testing.assert_allclose(rec, x, rtol=0, atol=1e-12)
            sref = np.linalg.svd(x, compute_uv=False)
            # Gram squaring floors small singular values at sqrt(eps)
            np.testing.assert_allclose(np.asarray(s), sref, rtol=0,
                                       atol=2e-6 * sref.max())

    def test_svd_via_gram_soft_threshold_matches_xla_svd(self):
        """The engine use case: singular-value soft-threshold through
        the Gram route equals the exact-SVD construction (the sqrt(eps)
        floor sits inside the threshold dead zone)."""
        from admmsolver_tpu.ops.linop import svd_via_gram

        rng = np.random.RandomState(10)
        x = rng.randn(4, 12, 9)
        tau = 0.3
        U, s, Vh = svd_via_gram(jnp.asarray(x))
        got = np.asarray(jnp.matmul(
            U * jnp.maximum(s - tau, 0.0)[..., None, :], Vh))
        U0, s0, Vh0 = np.linalg.svd(x, full_matrices=False)
        want = (U0 * np.maximum(s0 - tau, 0.0)[..., None, :]) @ Vh0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

    def test_under_vmap_and_jit(self):
        import jax

        from admmsolver_tpu.ops.linop import jacobi_eigh

        rng = np.random.RandomState(2)
        A = self._sym(rng, 12, 4)
        w_ref, _ = jacobi_eigh(jnp.asarray(A))
        w_vm, _ = jax.jit(jax.vmap(lambda m: jacobi_eigh(m)))(
            jnp.asarray(A))
        np.testing.assert_allclose(np.asarray(w_vm), np.asarray(w_ref),
                                   rtol=0, atol=1e-13)

    def test_psd_project_uses_jacobi_matching_reference_semantics(self):
        """psd_project (lower-triangle symmetrization) is unchanged by the
        Jacobi swap: compare against the explicit LAPACK construction."""
        from admmsolver_tpu.ops.prox import psd_project

        rng = np.random.RandomState(3)
        shape, axis = (6, 6, 5), 2
        x = rng.randn(int(np.prod(shape)))
        got = np.asarray(psd_project(jnp.asarray(x), shape, axis))
        x3 = np.moveaxis(x.reshape(shape), axis, 0)
        out = np.empty_like(x3)
        for i, sl in enumerate(x3):
            w, v = np.linalg.eigh(sl, UPLO="L")
            out[i] = (v * np.maximum(w, 0.0)) @ v.T
        want = np.moveaxis(out, 0, axis).ravel()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    def test_psd_project_lowering_has_no_dot(self):
        """Structure lock: the small-n f64 PSD projection lowers without
        dot_general/dot ops — the V diag(w) V^T rebuild is a
        broadcast-multiply + reduction that fuses with its neighbours,
        not a batched tiny contraction.  (Gathers from the Jacobi
        permutations stay.)
        """
        import jax

        from admmsolver_tpu.ops.prox import psd_project

        shape, axis = (4, 4, 7), 2
        x = jnp.zeros(int(np.prod(shape)), jnp.float64)
        hlo = jax.jit(
            lambda v: psd_project(v, shape, axis)
        ).lower(x).as_text()
        assert "dot_general" not in hlo and " dot(" not in hlo

    def test_psd_project_large_slices_match_lapack(self):
        """n = 32/64 slices route through the scan-rolled Jacobi (the
        round-3 ceiling was n = 16; reference projects any slice size,
        objectivefunc.py:322-327)."""
        from admmsolver_tpu.ops.prox import psd_project

        rng = np.random.RandomState(11)
        for n in (32, 64, 128):
            shape, axis = (n, n, 3), 2
            x = rng.randn(int(np.prod(shape)))
            got = np.asarray(psd_project(jnp.asarray(x), shape, axis))
            x3 = np.moveaxis(x.reshape(shape), axis, 0)
            out = np.empty_like(x3)
            for i, sl in enumerate(x3):
                w, v = np.linalg.eigh(sl, UPLO="L")
                out[i] = (v * np.maximum(w, 0.0)) @ v.T
            want = np.moveaxis(out, 0, axis).ravel()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)

    def test_psd_project_complex_hermitian_via_realify_embedding(self):
        """Complex Hermitian slices (n <= 128 since round 5) project
        through the real 2n x 2n embedding — all-real arithmetic,
        matching the per-slice complex LAPACK construction the
        reference runs (objectivefunc.py:322-327)."""
        from admmsolver_tpu.ops.prox import psd_project

        rng = np.random.RandomState(12)
        for n in (4, 12, 24, 80):
            shape, axis = (n, n, 3), 2
            x = (rng.randn(int(np.prod(shape)))
                 + 1j * rng.randn(int(np.prod(shape))))
            got = np.asarray(psd_project(jnp.asarray(x), shape, axis))
            x3 = np.moveaxis(x.reshape(shape), axis, 0)
            out = np.empty_like(x3)
            for i, sl in enumerate(x3):
                w, v = np.linalg.eigh(sl, UPLO="L")
                out[i] = (v * np.maximum(w, 0.0)) @ v.conj().T
            want = np.moveaxis(out, 0, axis).ravel()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


class TestBandedMatrix:
    """BandedMatrix algebra vs dense oracle (SURVEY idiom 2) and the
    cyclic-reduction tridiagonal factor."""

    def _fwd_diff(self, N):
        D = np.zeros((N - 1, N))
        i = np.arange(N - 1)
        D[i, i] = -1.0
        D[i, i + 1] = 1.0
        return D

    def test_roundtrip_matvec_transpose(self):
        from admmsolver_tpu.ops.linop import BandedMatrix

        rng = np.random.RandomState(0)
        Dd = self._fwd_diff(11)
        D = BandedMatrix.from_dense(Dd)
        assert D.offsets == (0, 1)
        np.testing.assert_allclose(np.asarray(D.asmatrix()), Dd)
        v = rng.randn(11)
        np.testing.assert_allclose(np.asarray(D @ v), Dd @ v, atol=1e-14)
        h = rng.randn(10)
        np.testing.assert_allclose(np.asarray(D.T @ h), Dd.T @ h,
                                   atol=1e-14)
        np.testing.assert_allclose(np.asarray(D.T.asmatrix()), Dd.T)
        # trailing batch dims
        vb = rng.randn(11, 3)
        np.testing.assert_allclose(np.asarray(D @ vb), Dd @ vb,
                                   atol=1e-14)

    def test_band_algebra_matches_dense(self):
        from admmsolver_tpu.ops.linop import (BandedMatrix,
                                              DiagonalMatrix,
                                              ScaledIdentityMatrix, add,
                                              matmul)

        rng = np.random.RandomState(1)
        Dd = self._fwd_diff(9)
        D = BandedMatrix.from_dense(Dd)
        G = matmul(D.conjugate().T, D)
        assert isinstance(G, BandedMatrix) and G.offsets == (-1, 0, 1)
        Gd = Dd.T @ Dd
        np.testing.assert_allclose(np.asarray(G.asmatrix()), Gd,
                                   atol=1e-14)
        # gram() through the dispatch
        np.testing.assert_allclose(np.asarray(D.gram().asmatrix()), Gd,
                                   atol=1e-14)
        # scale + add SI / Diagonal stays banded
        A2 = add(G * 0.7, ScaledIdentityMatrix(9, 0.5))
        assert isinstance(A2, BandedMatrix)
        np.testing.assert_allclose(np.asarray(A2.asmatrix()),
                                   0.7 * Gd + 0.5 * np.eye(9),
                                   atol=1e-14)
        dvec = rng.rand(9) + 1.0
        A3 = add(G, DiagonalMatrix(dvec))
        assert isinstance(A3, BandedMatrix)
        np.testing.assert_allclose(np.asarray(A3.asmatrix()),
                                   Gd + np.diag(dvec), atol=1e-14)
        # diagonal row/column scaling stays banded
        np.testing.assert_allclose(
            np.asarray(matmul(DiagonalMatrix(dvec), G).asmatrix()),
            np.diag(dvec) @ Gd, atol=1e-14)
        np.testing.assert_allclose(
            np.asarray(matmul(G, DiagonalMatrix(dvec)).asmatrix()),
            Gd @ np.diag(dvec), atol=1e-14)
        # banded + banded with different offset sets stays banded
        E = np.zeros((8, 9))
        E[np.arange(8), np.arange(8)] = dvec[:8]        # offset 0 only
        B2 = add(D * 2.0, BandedMatrix.from_dense(E))
        assert isinstance(B2, BandedMatrix)
        np.testing.assert_allclose(np.asarray(B2.asmatrix()),
                                   2.0 * Dd + E, atol=1e-14)

    def test_tridiag_cr_solve_matches_lapack(self):
        from admmsolver_tpu.ops.linop import tridiag_cr_factor

        rng = np.random.RandomState(2)
        for n in (1, 2, 3, 5, 8, 33, 100, 257):
            dl = np.r_[0.0, rng.randn(n - 1)] if n > 1 else np.zeros(1)
            du = np.r_[rng.randn(n - 1), 0.0] if n > 1 else np.zeros(1)
            d = np.abs(rng.randn(n)) + 2.0 + np.abs(dl) + np.abs(du)
            T = np.diag(d)
            if n > 1:
                T += np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
            f = tridiag_cr_factor(dl, d, du)
            b = rng.randn(n)
            np.testing.assert_allclose(np.asarray(f @ jnp.asarray(b)),
                                       np.linalg.solve(T, b),
                                       atol=1e-10)
            B = rng.randn(n, 4)
            np.testing.assert_allclose(np.asarray(f @ jnp.asarray(B)),
                                       np.linalg.solve(T, B),
                                       atol=1e-10)

    def test_tridiag_cr_vmapped(self):
        import jax

        from admmsolver_tpu.ops.linop import tridiag_cr_factor

        rng = np.random.RandomState(3)
        n, B = 37, 6
        dls = np.zeros((B, n))
        dls[:, 1:] = 0.3 * rng.randn(B, n - 1)
        dus = np.zeros((B, n))
        dus[:, :-1] = dls[:, 1:]
        ds = np.abs(rng.randn(B, n)) + 2.0
        bs = rng.randn(B, n)
        out = jax.jit(jax.vmap(
            lambda dl, d, du, b: tridiag_cr_factor(dl, d, du) @ b))(
            jnp.asarray(dls), jnp.asarray(ds), jnp.asarray(dus),
            jnp.asarray(bs))
        for k in range(B):
            T = np.diag(ds[k]) + np.diag(dls[k, 1:], -1) + \
                np.diag(dus[k, :-1], 1)
            np.testing.assert_allclose(np.asarray(out[k]),
                                       np.linalg.solve(T, bs[k]),
                                       atol=1e-10)


class TestPrecisionFollowsState:
    """Round-4 advisor regressions: factor/operator application must
    follow the rhs (state) dtype — f64-stored values must not promote an
    f32 phase (CLAUDE.md invariant)."""

    def test_tridiag_solve_matches_rhs_dtype(self):
        import jax.numpy as jnp
        from admmsolver_tpu.ops.linop import tridiag_cr_factor

        n = 17
        rng = np.random.RandomState(3)
        d = 4.0 + rng.rand(n)          # numpy f64 bands
        dl = -rng.rand(n)
        du = -rng.rand(n)
        fac = tridiag_cr_factor(dl, d, du)
        rhs32 = jnp.asarray(rng.randn(n), jnp.float32)
        out = fac @ rhs32
        assert out.dtype == jnp.float32, out.dtype
        # and f64 rhs still gets the full-precision solve
        rhs64 = jnp.asarray(rng.randn(n), jnp.float64)
        assert (fac @ rhs64).dtype == jnp.float64

    def test_banded_plus_diagonal_promotes(self):
        import jax.numpy as jnp
        from admmsolver_tpu.ops.linop import (BandedMatrix,
                                              DiagonalMatrix, add)

        n = 8
        rng = np.random.RandomState(4)
        Dd = np.zeros((n, n), np.float32)
        Dd[np.arange(n), np.arange(n)] = rng.rand(n).astype(np.float32)
        Dd[np.arange(n - 1), np.arange(1, n)] = 1.0
        Bm = BandedMatrix.from_dense(jnp.asarray(Dd))
        dv = jnp.asarray(rng.rand(n), jnp.float64)
        out = add(Bm, DiagonalMatrix(dv))
        assert isinstance(out, BandedMatrix)
        assert out.bands.dtype == jnp.float64
        np.testing.assert_allclose(
            np.asarray(out.asmatrix()),
            Dd.astype(np.float64) + np.diag(np.asarray(dv)), rtol=1e-6)
        # missing-diagonal case (no 0 offset) promotes too
        off = BandedMatrix((1,), Bm.bands[1:2].astype(jnp.float32),
                           (n, n))
        out2 = add(off, DiagonalMatrix(dv))
        assert out2.bands.dtype == jnp.float64


class TestSignPolynomialProjection:
    """psd_project_sign: eigendecomposition-free PSD projection (pure
    GEMMs; the round-5 unbounded-slice-size path)."""

    def test_matches_lapack_with_tiny_eigenvalues(self):
        from admmsolver_tpu.ops.prox import psd_project_sign

        for n in (70, 128, 200):
            rng = np.random.RandomState(n)
            K = 4
            X = rng.randn(K, n, n)
            X = (X + X.transpose(0, 2, 1)) / 2
            # plant near-zero eigenvalues (the sign iteration's hard
            # region; their projection error is bounded by |lam|)
            w, v = np.linalg.eigh(X[0])
            w[:5] = np.array([-1e-14, -1e-9, 1e-12, 1e-7, -1e-5]) \
                * np.abs(w).max()
            X[0] = (v * w) @ v.T
            got = np.asarray(psd_project_sign(jnp.asarray(X)))
            want = np.empty_like(X)
            for i, sl in enumerate(X):
                wv, vv = np.linalg.eigh(sl)
                want[i] = (vv * np.maximum(wv, 0.0)) @ vv.T
            scale = float(np.linalg.norm(X, axis=(1, 2)).max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-11 * scale)
            # f32: floor ~1e-5 relative to the Frobenius norm
            got32 = np.asarray(psd_project_sign(
                jnp.asarray(X, jnp.float32)), np.float64)
            np.testing.assert_allclose(got32, want, rtol=0,
                                       atol=5e-5 * scale)

    def test_zero_and_definite_slices(self):
        from admmsolver_tpu.ops.prox import psd_project_sign

        rng = np.random.RandomState(1)
        n = 80
        Q = rng.randn(n, n)
        pos = Q @ Q.T / n                 # already PSD -> unchanged
        X = np.stack([np.zeros((n, n)), pos, -pos])
        got = np.asarray(psd_project_sign(jnp.asarray(X)))
        np.testing.assert_allclose(got[0], 0.0, atol=0)
        np.testing.assert_allclose(got[1], pos, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[2], 0.0, rtol=0, atol=1e-12)

    def test_psd_project_dispatches_to_sign_above_jacobi(self):
        """The public psd_project routes real n > JACOBI_MAX_N (and
        complex slices whose realified size exceeds it) through the
        sign path, matching the per-slice LAPACK construction."""
        import pytest as _pytest

        from admmsolver_tpu.ops import prox as prox_mod
        from admmsolver_tpu.ops.prox import psd_project

        assert prox_mod.JACOBI_MAX_N == 64
        assert prox_mod.USE_SIGN_ABOVE_JACOBI is False
        mp = _pytest.MonkeyPatch()
        # force the sign dispatch
        mp.setattr(prox_mod, "USE_SIGN_ABOVE_JACOBI", "always")
        rng = np.random.RandomState(2)
        n = 100
        shape, axis = (n, n, 2), 2
        x = rng.randn(int(np.prod(shape)))
        got = np.asarray(psd_project(jnp.asarray(x), shape, axis))
        x3 = np.moveaxis(x.reshape(shape), axis, 0)
        out = np.empty_like(x3)
        for i, sl in enumerate(x3):
            w, v = np.linalg.eigh(sl, UPLO="L")
            out[i] = (v * np.maximum(w, 0.0)) @ v.T
        want = np.moveaxis(out, 0, axis).ravel()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        # complex n=80 -> realified 160 > 64 -> sign path
        xc = (rng.randn(80 * 80 * 2)
              + 1j * rng.randn(80 * 80 * 2))
        gotc = np.asarray(psd_project(jnp.asarray(xc), (80, 80, 2), 2))
        x3c = np.moveaxis(xc.reshape(80, 80, 2), 2, 0)
        outc = np.empty_like(x3c)
        for i, sl in enumerate(x3c):
            w, v = np.linalg.eigh(sl, UPLO="L")
            outc[i] = (v * np.maximum(w, 0.0)) @ v.conj().T
        wantc = np.moveaxis(outc, 0, 2).ravel()
        np.testing.assert_allclose(gotc, wantc, rtol=0, atol=1e-9)
        mp.undo()
        # default dispatch: exact eigh (no floor)
        got_cpu = np.asarray(psd_project(jnp.asarray(x), shape, axis))
        np.testing.assert_allclose(got_cpu, want, rtol=0, atol=1e-11)


def test_svt_sign_edge_cases():
    """SVD-free soft-threshold: zero input, tau=0, tau beyond the
    spectrum, batched per-lane tau."""
    from admmsolver_tpu.ops.prox import svt_sign

    rng = np.random.RandomState(3)
    m, n = 96, 80
    X = rng.randn(m, n)
    smax = np.linalg.svd(X, compute_uv=False)[0]
    # zero matrix -> zero
    z = np.asarray(svt_sign(jnp.zeros((2, m, n)), 0.3))
    assert np.all(z == 0.0)
    # tau = 0 -> identity (to the sign floor)
    np.testing.assert_allclose(np.asarray(svt_sign(jnp.asarray(X), 0.0)),
                               X, rtol=0, atol=1e-10 * smax)
    # tau > smax -> zero
    big = np.asarray(svt_sign(jnp.asarray(X), 2.0 * smax))
    np.testing.assert_allclose(big, 0.0, rtol=0, atol=1e-10 * smax)
    # batched per-lane tau
    Xs = np.stack([X, X])
    taus = np.array([0.1 * smax, 0.5 * smax])
    got = np.asarray(svt_sign(jnp.asarray(Xs), jnp.asarray(taus)))
    U, S, Vh = np.linalg.svd(X, full_matrices=False)
    for i, t in enumerate(taus):
        want = (U * np.maximum(S - t, 0.0)) @ Vh
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=1e-11 * smax)
