"""admmsolver_tpu — a batched multi-block ADMM solver framework in JAX.

Covers the problem class of the reference implementation
(SpM-lab/admmsolver, ``/root/reference/src/admmsolver``): minimize
``sum_k F_k(x_k)`` subject to pairwise linear equality couplings
``E1 @ x_i1 = E2 @ x_i2`` via multi-block ADMM with a Gauss–Seidel sweep,
adaptive penalty updates, and residual-based convergence checks — rebuilt
on JAX/XLA for accelerators (today an NVIDIA GPU): static trace-time
structure dispatch, jitted ``lax.while_loop`` solve loops,
chunk-scheduled refactorization instead of hash-keyed caches,
first-class ``vmap`` batching over problem instances, and mesh sharding
with collective convergence reductions.
"""

__version__ = "0.1.0"
__license__ = "MIT"

from .ops.linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    PartialDiagonalMatrix,
    BandedMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
)
from .models.objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    GroupL1Regularizer,
    HuberLoss,
    NonNegativePenalty,
    NuclearNormPenalty,
    BoxProjectionPenalty,
    SemiPositiveDefinitePenalty,
)
from .models.problem import EqualityCondition, Model, Problem
from .models.realify import RealifiedModel, realify_model
from .optimizer import SimpleOptimizer
from .config import ADMMConfig


def enable_x64() -> None:
    """Enable float64/complex128 globally (reference-parity precision).

    The reference runs complex128 end-to-end (``optimizer.py:151``); call
    this (or set ``JAX_ENABLE_X64=1``) before building problems when you
    need 1e-10-class residuals.  f32 problems and the mixed-precision
    recipe (``BatchedSolver.solve_mixed``) trade accuracy for speed.
    """
    import jax

    jax.config.update("jax_enable_x64", True)
