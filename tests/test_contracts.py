"""Static contract checks and explicit-cast discipline (round-4).

* Blockwise-uniform penalty contracts (GroupL1Regularizer /
  NuclearNormPenalty) are verified at ``ADMMPlan`` build time from the
  concrete coupling diagonals — a wrong coupling raises at construction,
  not a silent wrong prox under jit.
* The fused fast paths reject L1 offsets they cannot apply.
* Complex initial state into a real-dtype batched solve is explicit:
  zero-imag accepted (reference init convention, ``optimizer.py:151``),
  nonzero-imag raises.
"""
import warnings

import numpy as np
import pytest

from admmsolver_tpu import (GroupL1Regularizer, L1Regularizer,
                            LeastSquares, Model, NonNegativePenalty,
                            NuclearNormPenalty, SimpleOptimizer, identity)
from admmsolver_tpu.ops.linop import DiagonalMatrix
from admmsolver_tpu.optimizer import ADMMPlan
from admmsolver_tpu.parallel import BatchedSolver


def _ls(rng, M, N):
    A = rng.randn(M, N)
    return LeastSquares(1.0, A, A @ rng.randn(N))


def test_group_l1_nonuniform_coupling_raises_at_build():
    rng = np.random.RandomState(0)
    N = 8
    d = DiagonalMatrix(np.arange(1.0, N + 1.0))  # non-uniform within groups
    m = Model([_ls(rng, 6, N), GroupL1Regularizer(1.0, 4, 2)],
              [(1, 0, d, identity(N))])
    with pytest.raises(ValueError, match="constant within each group"):
        ADMMPlan(m)


def test_group_l1_groupwise_uniform_coupling_ok():
    rng = np.random.RandomState(1)
    N = 8
    # constant within each group of 4, different across groups: allowed
    d = DiagonalMatrix(np.r_[np.full(4, 2.0), np.full(4, 3.0)])
    m = Model([_ls(rng, 6, N), GroupL1Regularizer(1.0, 4, 2)],
              [(1, 0, d, identity(N))])
    ADMMPlan(m)  # must not raise


def test_nuclear_norm_nonuniform_coupling_raises_at_build():
    rng = np.random.RandomState(2)
    mn = 6
    d = DiagonalMatrix(np.r_[np.ones(3), 2 * np.ones(3)])
    m = Model([_ls(rng, 5, mn), NuclearNormPenalty(1.0, (2, 3))],
              [(1, 0, d, identity(mn))])
    with pytest.raises(ValueError, match="constant within each group"):
        ADMMPlan(m)


def test_nuclear_norm_scaled_identity_coupling_ok():
    rng = np.random.RandomState(3)
    mn = 6
    m = Model([_ls(rng, 5, mn), NuclearNormPenalty(1.0, (2, 3))],
              [(1, 0, 2.0 * identity(mn).to_diagonal_matrix(),
                identity(mn))])
    ADMMPlan(m)  # scaled identity is uniform


def test_fused_two_block_rejects_l1_offset():
    from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver

    rng = np.random.RandomState(4)
    N, M = 8, 4
    A = rng.randn(M, N)
    m = Model(
        [LeastSquares(1.0, A, A @ rng.randn(N)),
         L1Regularizer(0.1, N, offset=rng.randn(N))],
        [(1, 0, identity(N), identity(N))])
    with pytest.raises(ValueError, match="offset"):
        FusedTwoBlockSolver(m)


def test_fused_spm_rejects_l1_offset():
    from admmsolver_tpu.parallel.fused_spm import FusedSpMSolver

    rng = np.random.RandomState(5)
    nl, nw = 6, 9
    A = np.diag(rng.rand(nl) + 0.5)
    P = rng.randn(nw, nl)
    m = Model(
        [LeastSquares(1.0, A, rng.randn(nl)),
         L1Regularizer(0.1, nl, offset=rng.randn(nl)),
         NonNegativePenalty(nw)],
        [(1, 0, identity(nl), identity(nl)),
         (0, 2, P, identity(nw))])
    with pytest.raises(ValueError, match="offset"):
        FusedSpMSolver(m)


def _bp(rng, M=5, N=8):
    A = rng.randn(M, N)
    y = A @ rng.randn(N)
    return Model([LeastSquares(1.0, A, y), L1Regularizer(0.1, N)],
                 [(1, 0, identity(N), identity(N))])


def test_complex_zero_imag_x0_accepted_without_warning():
    rng = np.random.RandomState(6)
    bs = BatchedSolver(_bp(rng))
    x0 = tuple(np.zeros((2, 8), dtype=np.complex128) for _ in range(2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any ComplexWarning -> failure
        res = bs.solve({(0, "alpha"): np.ones(2)}, x0=x0, niter=5)
    assert res.x[0].dtype == np.float64


def test_complex_nonzero_imag_x0_raises():
    rng = np.random.RandomState(7)
    bs = BatchedSolver(_bp(rng))
    x0 = [np.zeros((2, 8), dtype=np.complex128) for _ in range(2)]
    x0[0] = x0[0] + 1j
    with pytest.raises(TypeError, match="imaginary"):
        bs.solve({(0, "alpha"): np.ones(2)}, x0=tuple(x0), niter=5)


def test_fused_spm_mixed_validates_record_residuals_and_overrides():
    from admmsolver_tpu.models.applications import (spm_model,
                                                    synthetic_spm_data)
    from admmsolver_tpu.parallel.fused_spm import FusedSpMSolver

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=8, nw=17,
                                                    noise=1e-4)
    model = spm_model(s, np.asarray(g), prj_sum, prj_w, alpha_l1=1e-3)
    fs = FusedSpMSolver(model)
    ys = np.broadcast_to(np.asarray(g), (4, len(np.asarray(g)))).copy()
    with pytest.raises(ValueError, match="stride must be >= 1"):
        fs.solve_mixed({(0, "y"): ys}, niter_low=4, niter=4,
                       record_residuals=0)
    # round 5: fused paths validate against their own supported set
    # (stricter than the engine's batch_fields — see _FUSED_OV_KEYS)
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve_mixed({(0, "nope"): ys}, niter_low=4, niter=4)


def test_fused_spm_done0_lanes_frozen():
    from admmsolver_tpu.models.applications import (spm_model,
                                                    synthetic_spm_data)
    from admmsolver_tpu.parallel.fused_spm import FusedSpMSolver

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=8, nw=17,
                                                    noise=1e-4)
    g = np.asarray(g)
    model = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    fs = FusedSpMSolver(model)
    ys = np.broadcast_to(g, (4, g.size)).copy()
    done0 = np.array([False, True, False, True])
    r = fs.solve({(0, "y"): ys}, niter=30, mu0=0.1, done0=done0)
    its = np.asarray(r.iterations)
    assert its[1] == 0 and its[3] == 0
    assert its[0] > 0 and its[2] > 0
    # frozen lanes keep their (zero) initial state
    assert np.all(np.asarray(r.x[0])[1] == 0)


def test_fused_two_block_done0_lanes_frozen():
    from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver

    rng = np.random.RandomState(8)
    N, M, B = 8, 4, 4
    A = rng.randn(M, N)
    m = Model(
        [LeastSquares(1.0, A, A @ rng.randn(N)), L1Regularizer(0.1, N)],
        [(1, 0, identity(N), identity(N))])
    fs = FusedTwoBlockSolver(m)
    ys = rng.randn(B, M)
    done0 = np.array([True, False, False, False])
    r = fs.solve({(0, "y"): ys}, niter=30, done0=done0)
    its = np.asarray(r.iterations)
    assert its[0] == 0 and np.all(its[1:] > 0)
