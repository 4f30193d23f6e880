"""Complex→real embedding: exact trajectory isomorphism.

The realified model must reproduce the complex ADMM trajectory — both
ours and the reference's (``/root/reference/src/admmsolver``) — bit-for-
tolerance: solutions, duals, penalties, and residual histories.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from admmsolver_tpu import (
    ConstrainedLeastSquares,
    DenseMatrix,
    DiagonalMatrix,
    L1Regularizer,
    LeastSquares,
    Model,
    NonNegativePenalty,
    PartialDiagonalMatrix,
    ScaledIdentityMatrix,
    SimpleOptimizer,
    identity,
    realify_model,
)
from admmsolver_tpu.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu.models.realify import decode, encode, realify_matrix
from admmsolver_tpu.parallel import BatchedSolver


def _randn_cmplx(rng, *shape):
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def test_encode_decode_roundtrip():
    rng = np.random.RandomState(0)
    v = _randn_cmplx(rng, 7)
    np.testing.assert_allclose(np.asarray(decode(encode(v))), v)
    vb = _randn_cmplx(rng, 3, 5)
    np.testing.assert_allclose(np.asarray(decode(encode(vb))), vb)
    # real input: imaginary lanes are zero
    r = encode(rng.randn(4))
    assert np.all(np.asarray(r)[1::2] == 0)


@pytest.mark.parametrize("op_factory,n", [
    (lambda rng: DenseMatrix(rng.randn(4, 6)), 6),
    (lambda rng: DenseMatrix(_randn_cmplx(rng, 4, 6)), 6),
    (lambda rng: DiagonalMatrix(rng.randn(5)), 5),
    (lambda rng: DiagonalMatrix(_randn_cmplx(rng, 5)), 5),
    (lambda rng: DiagonalMatrix(rng.randn(3), (6, 3)), 3),
    (lambda rng: DiagonalMatrix(rng.randn(3), (3, 6)), 6),
    (lambda rng: ScaledIdentityMatrix(5, 2.5), 5),
    (lambda rng: ScaledIdentityMatrix(5, 1.0 + 2.0j), 5),
    (lambda rng: ScaledIdentityMatrix((7, 4), 0.5), 4),
    (lambda rng: PartialDiagonalMatrix(
        DenseMatrix(rng.randn(3, 3)), (2,)), 6),
])
def test_realify_matrix_equivalence(op_factory, n):
    """R(M) encode(v) == encode(M v) for every operator structure."""
    rng = np.random.RandomState(42)
    op = op_factory(rng)
    R = realify_matrix(op)
    assert R.shape == (2 * op.shape[0], 2 * op.shape[1])
    v = _randn_cmplx(rng, n)
    got = np.asarray(R @ encode(v))
    want = np.asarray(encode(np.asarray(op.asmatrix()) @ v))
    np.testing.assert_allclose(got, want, atol=1e-12)
    # structure: real ops stay non-dense
    if not np.iscomplexobj(np.asarray(op.asmatrix())):
        assert not (isinstance(R, DenseMatrix)), type(R)


def _complex_bp_model(rng, M=8, N=16, alpha=0.15):
    A = _randn_cmplx(rng, M, N)
    x_true = np.zeros(N, dtype=complex)
    x_true[rng.choice(N, 3, replace=False)] = _randn_cmplx(rng, 3)
    y = A @ x_true
    model = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(alpha, N)],
        [(1, 0, identity(N), identity(N))])
    return model


def test_complex_trajectory_isomorphism():
    """Realified solve == complex solve, iteration for iteration, through
    penalty-update boundaries."""
    rng = np.random.RandomState(3)
    model = _complex_bp_model(rng)
    re = realify_model(model)

    oc = SimpleOptimizer(model)
    oc.solve(130, interval_update_mu=50, rtol=0)
    orr = SimpleOptimizer(re.model)
    orr.solve(130, interval_update_mu=50, rtol=0)

    for xc, xr in zip(oc.x, re.decode_x(orr.x)):
        np.testing.assert_allclose(np.asarray(xr), np.asarray(xc),
                                   atol=1e-10)
    np.testing.assert_allclose(orr._primal_residual, oc._primal_residual,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(orr._dual_residual, oc._dual_residual,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(orr.mu), np.asarray(oc.mu))


def test_realified_matches_reference_complex(ref):
    """Realified trajectory == the REFERENCE's complex trajectory."""
    rid = ref.mat.identity
    RL1, RLS = ref.obj.L1Regularizer, ref.obj.LeastSquares
    RModel, ROpt = ref.opt.Model, ref.opt.SimpleOptimizer

    rng = np.random.RandomState(7)
    M, N, alpha = 6, 12, 0.2
    A = _randn_cmplx(rng, M, N)
    y = _randn_cmplx(rng, M)

    rm = RModel([RLS(1.0, A, y), RL1(alpha, N)],
                [(1, 0, rid(N), rid(N))])
    ro = ROpt(rm)
    ro.solve(120)

    model = Model([LeastSquares(1.0, A, y), L1Regularizer(alpha, N)],
                  [(1, 0, identity(N), identity(N))])
    re = realify_model(model)
    o = SimpleOptimizer(re.model)
    o.solve(120)

    for xr, xc in zip(re.decode_x(o.x), ro.x):
        np.testing.assert_allclose(np.asarray(xr), np.asarray(xc),
                                   atol=1e-10)
    np.testing.assert_allclose(o._primal_residual, ro._primal_residual,
                               rtol=1e-8, atol=1e-12)


def test_realified_spectral_structure():
    """A realified real-A least-squares block keeps the spectral solve
    path: its Gram is G ⊗ I_2 and the eigensystem is of the small G."""
    rng = np.random.RandomState(1)
    A = rng.randn(5, 9)  # real wide
    y = _randn_cmplx(rng, 5)  # complex data
    # build via realify on a full model to exercise realify_objective
    model = Model(
        [LeastSquares(1.0, A.astype(complex), y), L1Regularizer(0.1, 9)],
        [(1, 0, identity(9), identity(9))])
    re = realify_model(model)
    f0 = re.model.functions[0]
    inner = f0._spectral_inner()
    assert inner is not None and inner[1] == 2
    assert inner[0].shape == (9, 9)
    # wide real A: thin path through the embedding too
    assert f0._get_eig_thin() is not False
    fac = f0.make_factors(ScaledIdentityMatrix(18, 0.8))
    v = _randn_cmplx(rng, 9)
    got = np.asarray(f0._apply_B(fac, encode(v)))
    want = np.asarray(encode(
        np.linalg.solve(A.T @ A + 0.8 * np.eye(9), v)))
    np.testing.assert_allclose(got, want, atol=1e-11)


def test_realified_spm_three_block():
    """The SpM workload (3-block: constrained LS + L1 + nonneg) with
    complex Matsubara-like data: realified trajectory == complex."""
    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(nl=12, nw=25)
    rng = np.random.RandomState(5)
    g = g + 1e-3j * rng.randn(g.size)  # force genuinely complex data
    model = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    re = realify_model(model)

    oc = SimpleOptimizer(model, mu=0.1)
    oc.solve(150, rtol=0)
    orr = SimpleOptimizer(re.model, mu=0.1)
    orr.solve(150, rtol=0)

    for xc, xr in zip(oc.x, re.decode_x(orr.x)):
        np.testing.assert_allclose(np.asarray(xr), np.asarray(xc),
                                   atol=1e-9)
    np.testing.assert_allclose(orr._primal_residual, oc._primal_residual,
                               rtol=1e-7, atol=1e-12)


def test_realified_batched_solver():
    """Batched realified solves (the real-arithmetic path for complex
    workloads):
    every lane matches its single-instance complex solve."""
    rng = np.random.RandomState(9)
    M, N, B = 6, 10, 4
    A = _randn_cmplx(rng, M, N)
    ys = _randn_cmplx(rng, B, M)
    model = Model(
        [LeastSquares(1.0, A, ys[0]), L1Regularizer(0.3, N)],
        [(1, 0, identity(N), identity(N))])
    re = realify_model(model)

    bs = BatchedSolver(re.model)
    res = bs.solve({(0, "y"): np.stack([np.asarray(encode(y))
                                        for y in ys])},
                   niter=80, rtol=0, record_residuals=False)
    for b in range(B):
        mb = Model([LeastSquares(1.0, A, ys[b]), L1Regularizer(0.3, N)],
                   [(1, 0, identity(N), identity(N))])
        ob = SimpleOptimizer(mb)
        ob.solve(80, rtol=0)
        got = np.asarray(decode(res.x[0][b]))
        np.testing.assert_allclose(got, np.asarray(ob.x[0]), atol=1e-9)


def test_realified_complex_diagonal_coupling():
    """A genuinely complex diagonal coupling must keep a diagonal EcE in
    the realified model (round-1 densified it, breaking the separable
    prox): realified trajectory == complex trajectory."""
    from admmsolver_tpu.ops.linop import InterleavedComplexDiagonalMatrix

    rng = np.random.RandomState(11)
    M, N = 6, 8
    A = _randn_cmplx(rng, M, N)
    y = _randn_cmplx(rng, M)
    E = DiagonalMatrix(jnp.asarray(
        _randn_cmplx(rng, N) + 2.0))  # complex, well-conditioned
    model = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(0.2, N)],
        [(1, 0, E, identity(N))])
    re = realify_model(model)
    # structure: the embedded coupling is NOT dense
    emb = re.model.E[(0, 1)]
    assert isinstance(emb, InterleavedComplexDiagonalMatrix), type(emb)

    oc = SimpleOptimizer(model)
    oc.solve(120, rtol=0)
    orr = SimpleOptimizer(re.model)
    orr.solve(120, rtol=0)
    for xc, xr in zip(oc.x, re.decode_x(orr.x)):
        np.testing.assert_allclose(np.asarray(xr), np.asarray(xc),
                                   atol=1e-9)
    np.testing.assert_allclose(orr._primal_residual, oc._primal_residual,
                               rtol=1e-7, atol=1e-12)


def test_realified_complex_scaled_identity_coupling():
    """Complex scaled-identity couplings stay structured too."""
    from admmsolver_tpu.ops.linop import InterleavedComplexDiagonalMatrix

    op = ScaledIdentityMatrix(5, 1.0 - 0.5j)
    R = realify_matrix(op)
    assert isinstance(R, InterleavedComplexDiagonalMatrix)
    rng = np.random.RandomState(0)
    v = _randn_cmplx(rng, 5)
    np.testing.assert_allclose(
        np.asarray(R @ encode(v)),
        np.asarray(encode((1.0 - 0.5j) * v)), atol=1e-13)


def test_realify_partial_diagonal_complex_dtype_inner():
    """A real-valued but complex-dtype PartialDiagonalMatrix inner must be
    cast to real dtype in the realified operator (ADVICE round 1)."""
    import jax

    rng = np.random.RandomState(2)
    inner = DenseMatrix(jnp.asarray(rng.randn(3, 3).astype(complex)))
    op = PartialDiagonalMatrix(inner, (2,))
    R = realify_matrix(op)
    for leaf in jax.tree_util.tree_leaves(R):
        assert not np.issubdtype(np.asarray(leaf).dtype,
                                 np.complexfloating), R


def test_complex_model_solves_natively_without_realify():
    """A complex model solves as complex128 state on the CPU (no guard,
    no realify step) and lands where its realified embedding does."""
    from admmsolver_tpu import SimpleOptimizer as Opt

    rng = np.random.RandomState(13)
    model = _complex_bp_model(rng)
    o = Opt(model)
    o.solve(150)
    assert np.iscomplexobj(np.asarray(o.x[0]))
    bs = BatchedSolver(model)
    assert np.issubdtype(bs.dtype, np.complexfloating)
    # explicit complex dtype on a real model is accepted as well
    real_model = Model(
        [LeastSquares(1.0, np.random.RandomState(0).randn(4, 6),
                      np.zeros(4)), L1Regularizer(0.1, 6)],
        [(1, 0, identity(6), identity(6))])
    r = BatchedSolver(real_model).solve(
        {(0, "y"): np.zeros((2, 4))}, niter=3, dtype="complex128")
    assert np.iscomplexobj(np.asarray(r.x[0]))
    # same fixed point as the realified embedding
    re = realify_model(model)
    orr = Opt(re.model)
    orr.solve(150)
    for xc, xr in zip(o.x, re.decode_x(orr.x)):
        np.testing.assert_allclose(np.asarray(xr), np.asarray(xc),
                                   atol=1e-10)
