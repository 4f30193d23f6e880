"""The ADMM engine: Gauss–Seidel multi-block ADMM compiled with XLA.

JAX counterpart of the reference's ``SimpleOptimizer``
(``/root/reference/src/admmsolver/optimizer.py:121-341``).  Design:

* The constraint graph, matrix structures, and block order are resolved in
  Python at trace time (:class:`ADMMPlan`); the whole solve loop is ONE
  ``jax.lax.while_loop`` inside ``jit`` — no host round-trips per iteration.
* The reference's hash-keyed factorization cache
  (``objectivefunc.py:89-96``) becomes a *static schedule*: factorizations
  are recomputed exactly when the penalty ``mu`` may change (every
  ``interval_update_mu`` iterations, ``optimizer.py:319-320``), via
  ``lax.cond`` in the single-instance driver and at chunk boundaries in the
  batched driver (:mod:`admmsolver_tpu.parallel.batch`).
* The per-pair coupling products ``E x`` are computed once per iteration and
  shared between the dual update, the residual norms, the convergence
  predicate, and the adaptive-penalty decision — the reference recomputes
  them three times per iteration (``optimizer.py:238-247,259-273,283-294``).
* Residual histories live in fixed-length device buffers written with
  dynamic-index updates; the host-side wrapper trims them afterwards.

Semantics preserved exactly (see SURVEY.md §2.4/§3.2): Gauss–Seidel sweep
order and sign conventions (``optimizer.py:183-207``), dual ascent
(``optimizer.py:334-341``), absolute summed residuals
(``optimizer.py:251-274``), per-pair relative convergence test including its
0/0→NaN→"not converged" behavior (``optimizer.py:232-249``), and
residual-balancing mu adaptation with clamping (``optimizer.py:277-299``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import ADMMConfig
from .models.problem import Model
from .ops.linop import MatrixBase, ScaledIdentityMatrix, add

__all__ = ["ADMMPlan", "SimpleOptimizer"]


def _norm(v):
    return jnp.linalg.norm(v)


class ADMMPlan:
    """Trace-time specialization of a :class:`Model` for the ADMM loop.

    Holds the static structure: the ordered pair list, per-block Gauss–Seidel
    coupling terms, per-block penalty composition, and the per-pair residual
    operators.  All heavy values are jnp arrays closed over by the jitted
    functions; only ``x``, ``h``, ``mu``, and the factorization pytrees flow
    through the compiled graph.
    """

    def __init__(self, model: Model) -> None:
        self.model = model
        self._run_cache: Dict = {}
        self.nblocks = model.num_func
        self.pairs: List[Tuple[int, int]] = model.pairs
        self.pair_index: Dict[Tuple[int, int], int] = {
            p: idx for idx, p in enumerate(self.pairs)}
        self.npairs = len(self.pairs)
        self.pair_sizes = [model.E[(i, j)].shape[0] for (i, j) in self.pairs]
        self.block_sizes = [f.size_x for f in model.functions]

        # Per-block k: terms of h_k (optimizer.py:175-207).  Each term is
        # (pair_idx, sign, E[i,k]^H, EcE[(k,i)], partner i, E[(k,i)],
        # E[(i,k)]); sign +1 for i < k, -1 for i > k.  The last two
        # operators (partner's and own constraint maps) feed the
        # over-relaxation path only; the plain sweep uses the combined
        # EcE product.
        self.hk_terms: List[List[Tuple]] = []
        # Per-block k: penalty terms (pair_idx, EcE2[(i,k)])
        # (optimizer.py:209-230).
        self.mu_terms: List[List[Tuple[int, MatrixBase]]] = []
        # For diagonal-penalty blocks: (pair_idx, effective diagonal vector).
        self.mu_diag_terms: List[Optional[List[Tuple[int, jnp.ndarray]]]] = []

        for k in range(self.nblocks):
            terms = []
            muterms = []
            for i in range(self.nblocks):
                if i == k or (k, i) not in model.E:
                    continue
                pair = (k, i) if i < k else (i, k)
                sign = 1.0 if i < k else -1.0
                terms.append((self.pair_index[pair], sign,
                              model.E[(i, k)].conjugate().T,
                              model.EcE[(k, i)], i,
                              model.E[(k, i)], model.E[(i, k)]))
                muterms.append((self.pair_index[pair], model.EcE2[(i, k)]))
            self.hk_terms.append(terms)
            self.mu_terms.append(muterms)

            f = model.functions[k]
            if f.needs_diagonal_mu:
                if not muterms:
                    raise ValueError(
                        f"Block {k} ({type(f).__name__}) requires a diagonal "
                        "penalty but has no couplings (reference would raise "
                        "at objectivefunc.py:190-192)")
                diag_terms = []
                for p_idx, ece2 in muterms:
                    d = ece2.effective_diagonal()
                    if d is None:
                        raise TypeError(
                            f"Penalty structure {type(ece2).__name__} for "
                            f"block {k} has no diagonal interpretation "
                            "(reference assert at objectivefunc.py:187,296)")
                    diag_terms.append((p_idx, d))
                self._check_uniform_mu(k, f, diag_terms)
                self.mu_diag_terms.append(diag_terms)
            else:
                self.mu_diag_terms.append(None)

        # Residual operators per pair p=(i,j): E[(i,j)] acts on x_j,
        # E[(j,i)] acts on x_i (optimizer.py:251-274).
        self.E_ij = [model.E[(i, j)] for (i, j) in self.pairs]
        self.E_ji = [model.E[(j, i)] for (i, j) in self.pairs]

    def _check_uniform_mu(self, k, f, diag_terms) -> None:
        """Statically verify blockwise-uniform penalty contracts.

        GroupL1Regularizer/NuclearNormPenalty prox closed forms require
        the effective diagonal penalty to be constant within each group
        of ``f.uniform_mu_group`` entries.  The runtime penalty is
        ``Σ_p mu[p] · d_p`` with per-pair SCALAR ``mu[p]``, so uniformity
        of each concrete coupling diagonal ``d_p`` is exactly equivalent
        — and decidable here, at plan-build time, where the structure is
        static (same spirit as the ``needs_diagonal_mu`` trace-time
        errors above).  A non-uniform coupling raises at construction
        instead of silently producing a wrong prox under jit.
        """
        from .ops.linop import _concrete

        g = getattr(f, "uniform_mu_group", None)
        if not g or g <= 1:
            return
        for _p_idx, d in diag_terms:
            dc = _concrete(d)
            if dc is None:
                continue  # traced coupling: can't decide; contract stands
            dv = np.broadcast_to(np.asarray(dc), (f.size_x,))
            dg = dv.reshape(-1, g)
            if not np.allclose(dg, dg[:, :1]):
                raise ValueError(
                    f"block {k} ({type(f).__name__}) requires a penalty "
                    f"constant within each group of {g} entries, but its "
                    "coupling produces a non-uniform effective diagonal; "
                    "couple this block through identity/ScaledIdentity "
                    "operators")

    # ------------------------------------------------------------------
    # Pure functions of the iteration (all batchable / vmappable)
    # ------------------------------------------------------------------
    def compute_factors(self, mu, functions=None):
        """Per-block factorizations for the current penalties.

        ``mu``: (npairs,) array.  Expensive (O(N^3) per dense quadratic
        block) — called only at penalty-update boundaries, which makes the
        reference's hash cache (objectivefunc.py:89-96) a static schedule.
        ``functions`` optionally overrides the block objectives (the
        batched runtime passes per-instance clones).
        """
        with jax.named_scope("admm/refactor"):
            factors = []
            for k, f in enumerate(functions or self.model.functions):
                if not f.is_quadratic:
                    factors.append(())
                    continue
                if self.mu_terms[k]:
                    mu_op = None
                    for p_idx, ece2 in self.mu_terms[k]:
                        term = ece2 * mu[p_idx]
                        mu_op = term if mu_op is None else add(mu_op, term)
                else:
                    mu_op = ScaledIdentityMatrix(f.size_x, 0.0)
                factors.append(f.make_factors(mu_op))
            return tuple(factors)

    def mu_diag(self, k: int, mu):
        """Effective diagonal penalty for block k (objectivefunc.py:296-310)."""
        from .ops.linop import _match_precision

        terms = self.mu_diag_terms[k]
        out = None
        for p_idx, d in terms:
            t = mu[p_idx] * _match_precision(d, mu.dtype)
            out = t if out is None else out + t
        return out

    def sweep(self, x, h, mu, factors, update_h: bool, functions=None,
              relax: float = 1.0):
        """One Gauss–Seidel sweep + dual ascent (optimizer.py:322-341).

        Returns (x_new, h_new, pair_products) where pair_products caches the
        per-pair coupling matvecs for the fused residual computation.

        ``relax`` != 1.0 enables over-relaxation (no reference
        counterpart; ``ADMMConfig.relax``): in every pair, the EARLIER-
        updated member's constraint image is replaced by ``relax * (E_kj
        x_j_new) + (1 - relax) * (E_jk x_k_prev)`` in the later block's
        subproblem and in the dual ascent.  At any constraint-feasible
        point the two images coincide, so fixed points — and hence the
        solutions the oracle tests pin — are exactly preserved; the
        branch is STATIC (relax is an ADMMConfig field), so the default
        1.0 compiles the byte-identical reference sweep.
        """
        relax_on = float(relax) != 1.0
        if relax_on and self.npairs != 1:
            # Over-relaxation theory is 2-block; on multi-pair Gauss-
            # Seidel sweeps the relaxed images conflict and the
            # iteration stalls short of tolerance (measured round 5:
            # both the SpM star topology and a 3-block chain plateau at
            # ~1e-4 with relax=1.3..1.7 while relax=1.0 converges).
            # Static structure -> fail at trace time, not silently.
            raise ValueError(
                "relax != 1.0 is supported for single-pair (2-block) "
                f"models only; this model has {self.npairs} pairs")
        x_new = list(x)
        for k, f in enumerate(functions or self.model.functions):
            # named scopes label the per-block prox phases in jax.profiler
            # traces (utils.telemetry.trace) — free at runtime.
            with jax.named_scope(f"admm/block{k}_{type(f).__name__}"):
                terms = self.hk_terms[k]
                if terms:
                    hk = None
                    for p_idx, sign, EikH, EcE_ki, i, E_ki, E_ik in terms:
                        # Gauss–Seidel: partners i<k already updated this
                        # sweep.
                        xi = x_new[i]
                        if relax_on and i < k:
                            # relaxed partner image: mix with this
                            # block's own previous image
                            r = (relax * (E_ki @ xi)
                                 + (1.0 - relax) * (E_ik @ x[k]))
                            t = sign * (EikH @ h[p_idx]) \
                                - mu[p_idx] * (EikH @ r)
                        else:
                            t = sign * (EikH @ h[p_idx]) \
                                - mu[p_idx] * (EcE_ki @ xi)
                        hk = t if hk is None else hk + t
                else:
                    hk = jnp.zeros(f.size_x, dtype=x[k].dtype)

                if f.is_quadratic:
                    xk = f.prox_with_factors(factors[k], hk)
                elif f.needs_diagonal_mu:
                    xk = f.prox_diag(hk, self.mu_diag(k, mu))
                else:
                    xk = f.solve(hk, None)
                x_new[k] = jnp.asarray(xk, dtype=x[k].dtype)

        # Shared per-pair products: p1 = E_ij x_j, p2 = E_ji x_i.
        with jax.named_scope("admm/dual_ascent"):
            p1s, p2s = [], []
            for idx, (i, j) in enumerate(self.pairs):
                p1s.append(self.E_ij[idx] @ x_new[j])
                p2s.append(self.E_ji[idx] @ x_new[i])

            h_new = list(h)
            if update_h:
                for idx, (i, j) in enumerate(self.pairs):
                    # h[i,j] += mu * (E[j,i] x_i - E[i,j] x_j)
                    # (optimizer.py:334-341); under relaxation the
                    # earlier member's (j's) image is the same relaxed
                    # mix the later block's subproblem consumed.
                    p1 = p1s[idx]
                    if relax_on:
                        p1 = (relax * p1
                              + (1.0 - relax) * (self.E_ji[idx] @ x[i]))
                    h_new[idx] = h[idx] + mu[idx] * (p2s[idx] - p1)

        return tuple(x_new), tuple(h_new), (p1s, p2s)

    def pair_residuals(self, x_new, x_old, mu, pair_products=None):
        """Per-pair primal/dual residual norms and convergence flags.

        Fuses the reference's ``residual()`` / ``check_convergence()`` /
        ``update_mu()`` recomputations (optimizer.py:232-299) into one pass.
        Returns (primal_norms, dual_norms, conv_flags) as lists of scalars.
        """
        if pair_products is None:
            p1s = [self.E_ij[idx] @ x_new[j]
                   for idx, (i, j) in enumerate(self.pairs)]
            p2s = [self.E_ji[idx] @ x_new[i]
                   for idx, (i, j) in enumerate(self.pairs)]
        else:
            p1s, p2s = pair_products

        primal_norms, dual_norms, convs = [], [], []
        with jax.named_scope("admm/residuals"):
            for idx, (i, j) in enumerate(self.pairs):
                p1, p2 = p1s[idx], p2s[idx]
                d_primal = p1 - p2
                # dual residual: mu * E[j,i] @ E[i,j] @ (x_j - x_j_old)
                d_dual = mu[idx] * (self.E_ji[idx] @ (
                    self.E_ij[idx] @ (x_new[j] - x_old[j])))
                dual1 = mu[idx] * (self.E_ji[idx] @ p1)
                dual2 = dual1 - d_dual
                pn = _norm(d_primal)
                dn = _norm(d_dual)
                primal_norms.append(pn)
                dual_norms.append(dn)
                convs.append((pn / jnp.maximum(_norm(p1), _norm(p2)),
                              dn / jnp.maximum(_norm(dual1),
                                               _norm(dual2))))
        return primal_norms, dual_norms, convs

    def updated_mu(self, mu, primal_norms, dual_norms,
                   fact_incr, th_change, max_mu):
        """Residual-balancing penalty adaptation (optimizer.py:277-299)."""
        pn = jnp.stack(primal_norms)
        dn = jnp.stack(dual_norms)
        mu_new = jnp.where(pn > th_change * dn, mu * fact_incr, mu)
        mu_new = jnp.where(dn > th_change * pn, mu_new / fact_incr, mu_new)
        return jnp.minimum(mu_new, max_mu)

    def iteration(self, carry, buf_idx, global_it, cfg: ADMMConfig, tols,
                  functions=None, compute_residuals: bool = True):
        """One reference iteration of ``solve()`` (optimizer.py:310-320):
        sweep → fused residuals/convergence → scheduled mu update.

        ``carry`` = (x, x_prev, h, mu, factors, done, count, primal_buf,
        dual_buf).  ``buf_idx`` indexes the residual buffers; ``global_it``
        drives the penalty-update schedule (they differ in the per-iteration
        callback driver).  Pure and scalar-per-problem: the batched driver
        vmaps it.  Returns (carry', do_mu) — the caller decides how to
        refactorize.
        """
        rtol, atol = tols
        x, x_prev, h, mu, factors, done, count, pbuf, dbuf = carry
        active = jnp.logical_not(done)

        x_new, h_new, prods = self.sweep(
            x, h, mu, factors, cfg.update_h, functions,
            relax=cfg.relax)

        if not compute_residuals:
            # Sweep-only iteration (the chunked-checks fast mode: residual
            # norms, convergence, penalty adaptation, and history recording
            # all happen on the chunk-boundary iteration instead).
            x_out = tuple(jnp.where(active, a, b) for a, b in zip(x_new, x))
            xp_out = tuple(jnp.where(active, a, b)
                           for a, b in zip(x, x_prev))
            h_out = tuple(jnp.where(active, a, b) for a, b in zip(h_new, h))
            count = count + active.astype(count.dtype)
            carry_out = (x_out, xp_out, h_out, mu, factors, done, count,
                         pbuf, dbuf)
            return carry_out, jnp.array(False)

        primal_norms, dual_norms, convs = self.pair_residuals(
            x_new, x, mu, prods)

        if self.npairs:
            primal = functools.reduce(jnp.add, primal_norms)
            dual = functools.reduce(jnp.add, dual_norms)
            # NaN (0/0) and Inf (x/0) both fail `< rtol`, matching the
            # reference's float semantics at optimizer.py:244-247.
            conv = jnp.array(True)
            for rp, rd in convs:
                conv = conv & (rp < rtol) & (rd < rtol)
            # Optional absolute-residual stop (engine extension beyond the
            # reference; atol=0 disables it and preserves exact reference
            # semantics).  Used for "time-to-1e-10" targets.
            conv = conv | ((primal < atol) & (dual < atol))
        else:
            primal = jnp.asarray(0.0)
            dual = jnp.asarray(0.0)
            conv = jnp.array(True)

        # Freeze finished lanes (no-op for the single-instance driver,
        # which exits the loop instead).
        x_out = tuple(jnp.where(active, a, b) for a, b in zip(x_new, x))
        xp_out = tuple(jnp.where(active, a, b) for a, b in zip(x, x_prev))
        h_out = tuple(jnp.where(active, a, b) for a, b in zip(h_new, h))
        pbuf = pbuf.at[buf_idx].set(jnp.where(active, primal, pbuf[buf_idx]))
        dbuf = dbuf.at[buf_idx].set(jnp.where(active, dual, dbuf[buf_idx]))
        count = count + active.astype(count.dtype)
        done_new = done | conv

        # mu update fires on the reference schedule (optimizer.py:319-320):
        # after iterations 0, interval, 2*interval, ... and never after the
        # converging iteration (the reference returns first).
        is_boundary = (global_it % cfg.interval_update_mu) == 0
        do_mu = is_boundary & jnp.logical_not(done_new)
        if self.npairs:
            mu_adapted = self.updated_mu(
                mu, primal_norms, dual_norms,
                cfg.fact_incr, cfg.th_change, cfg.max_mu)
            mu_out = jnp.where(do_mu, mu_adapted, mu)
        else:
            mu_out = mu

        carry_out = (x_out, xp_out, h_out, mu_out, factors, done_new, count,
                     pbuf, dbuf)
        return carry_out, do_mu

    # ------------------------------------------------------------------
    # Single-instance jitted driver
    # ------------------------------------------------------------------
    def _compiled_run(self, cfg: ADMMConfig, record: bool = True):
        """Jitted full solve: while_loop with early exit and lax.cond
        refactorization at penalty boundaries.

        Cached per plan instance (NOT ``functools.lru_cache`` on the
        method, which pins the plan and its closed-over operator arrays
        process-wide — a leak for λ-scan drivers that build many
        solvers)."""
        key = (cfg, record)
        cached = self._run_cache.get(key)
        if cached is not None:
            return cached
        run = self._build_run(cfg, record)
        if len(self._run_cache) >= 32:
            self._run_cache.pop(next(iter(self._run_cache)))
        self._run_cache[key] = run
        return run

    def _build_run(self, cfg: ADMMConfig, record: bool):
        hist = cfg.niter if record else 1

        def run(x, h, mu, tols, it_offset):
            factors = self.compute_factors(mu)
            rdtype = jnp.zeros(()).dtype
            pbuf = jnp.full(hist, jnp.nan, dtype=rdtype)
            dbuf = jnp.full(hist, jnp.nan, dtype=rdtype)
            carry0 = (x, x, h, mu, factors, jnp.array(False),
                      jnp.array(0, dtype=jnp.int32), pbuf, dbuf)

            def cond(state):
                it, carry = state
                done = carry[5]
                return (it < cfg.niter) & jnp.logical_not(done)

            def body(state):
                it, carry = state
                carry, do_mu = self.iteration(
                    carry, jnp.minimum(it, hist - 1), it + it_offset,
                    cfg, tols)
                (x_, xp_, h_, mu_, factors_, done_, count_,
                 pb_, db_) = carry
                factors_ = jax.lax.cond(
                    do_mu,
                    lambda m: self.compute_factors(m),
                    lambda m: factors_,
                    mu_)
                return (it + 1,
                        (x_, xp_, h_, mu_, factors_, done_, count_,
                         pb_, db_))

            _, carry = jax.lax.while_loop(
                cond, body, (jnp.array(0, jnp.int32), carry0))
            x, xp, h, mu, _, done, count, pbuf, dbuf = carry
            return x, xp, h, mu, done, count, pbuf, dbuf

        return jax.jit(run)

    def is_complex(self) -> bool:
        """True when any operator/objective data is complex.

        Drives the default state dtype: the reference is complex128
        unconditionally (optimizer.py:151,159), but for real-valued
        problems a real state is semantically identical (every reference
        prox keeps real data real) and 2× cheaper.
        """
        leaves = []
        for op in self.model.E.values():
            leaves.extend(jax.tree_util.tree_leaves(op))
        for f in self.model.functions:
            for v in vars(f).values():
                leaves.extend(
                    x for x in jax.tree_util.tree_leaves(v)
                    if hasattr(x, "dtype"))
        return any(np.issubdtype(np.asarray(l).dtype, np.complexfloating)
                   for l in leaves if hasattr(l, "dtype"))

    def default_dtype(self):
        base = np.complex128 if self.is_complex() else np.float64
        return jax.dtypes.canonicalize_dtype(base)

    def make_initial_state(self, x0=None, mu0: float = 1.0, dtype=None):
        """Initial primal/dual state (optimizer.py:141-160)."""
        if dtype is None:
            dtype = self.default_dtype()
        if x0 is not None:
            assert len(x0) == self.nblocks
            for k, x_ in enumerate(x0):
                assert self.model.functions[k].size_x == np.size(x_)
            x = tuple(jnp.asarray(x_) for x_ in x0)
        else:
            x = tuple(jnp.zeros(n, dtype=dtype) for n in self.block_sizes)
        h = tuple(jnp.zeros(s, dtype=dtype) for s in self.pair_sizes)
        mu = jnp.full(self.npairs, float(mu0))
        return x, h, mu


class SimpleOptimizer:
    """Reference-compatible front end over the jitted engine.

    Mirrors the public surface of the reference ``SimpleOptimizer``
    (``optimizer.py:121-341``): ``solve``, ``one_sweep``, ``residual``,
    ``update_mu``, ``check_convergence``, ``__call__``, ``.x``, and the
    ``_primal_residual`` / ``_dual_residual`` histories.
    """

    def __init__(self, model: Model, x0=None, mu=None, max_mu: float = 1e3,
                 dtype=None) -> None:
        assert isinstance(model, Model)
        self._model = model
        self._plan = ADMMPlan(model)
        self._max_mu = float(max_mu)
        mu0 = 1.0 if mu is None else float(mu)
        self._x, self._h, self._mu = self._plan.make_initial_state(
            x0, mu0, dtype)
        self._x_old = None
        self._primal_residual: List[float] = []
        self._dual_residual: List[float] = []

    # -- reference API -----------------------------------------------------
    @property
    def x(self) -> List[jnp.ndarray]:
        return list(self._x)

    @property
    def h(self) -> List[jnp.ndarray]:
        return list(self._h)

    @property
    def mu(self) -> jnp.ndarray:
        """Per-pair penalties, ordered like ``Model.pairs``."""
        return self._mu

    @property
    def primal_residual_history(self) -> List[float]:
        """Per-iteration absolute primal residuals recorded so far (the
        reference exposes this as ``_primal_residual``,
        ``optimizer.py:162,312-314``; read e.g. by ``spm.ipynb`` cell 14)."""
        return list(self._primal_residual)

    @property
    def dual_residual_history(self) -> List[float]:
        """Per-iteration absolute dual residuals recorded so far
        (reference ``_dual_residual``, ``optimizer.py:163,312-314``)."""
        return list(self._dual_residual)

    @property
    def iterations(self) -> int:
        """Number of iterations executed across all ``solve`` calls
        (length of the recorded residual histories)."""
        return len(self._primal_residual)

    def __call__(self, x: Sequence) -> float:
        return float(np.sum([f(x_) for x_, f in
                             zip(x, self._model.functions)]))

    def solve(self, niter: int = 10000, callback=None,
              interval_update_mu: int = 100, update_h: bool = True,
              rtol: float = 1e-12, atol: float = 0.0,
              fact_incr: float = 2.0, th_change: float = 10.0,
              record_residuals: bool = True,
              relax: float = 1.0) -> None:
        """``fact_incr``/``th_change`` tune the residual-balancing penalty
        adaptation, as the reference's ``update_mu`` accepts
        (``optimizer.py:277``); ``relax`` enables over-relaxation
        (``ADMMConfig.relax`` — engine extension, default off)."""
        if niter <= 0:
            # The reference's `for iter in range(0)` is a no-op
            # (optimizer.py:310).
            return

        # rtol is a traced argument (changing it never recompiles); cfg
        # holds only the static schedule knobs.
        if callback is None:
            cfg = ADMMConfig(
                niter=int(niter),
                interval_update_mu=int(interval_update_mu),
                update_h=bool(update_h), max_mu=self._max_mu,
                fact_incr=float(fact_incr), th_change=float(th_change),
                relax=float(relax))
            run = self._plan._compiled_run(cfg, bool(record_residuals))
            x, xp, h, mu, done, count, pbuf, dbuf = run(
                self._x, self._h, self._mu, (rtol, atol),
                jnp.array(0, jnp.int32))
            n = int(count)
            self._x, self._h, self._mu = x, h, mu
            self._x_old = xp
            if record_residuals:
                self._primal_residual.extend(np.asarray(pbuf)[:n].tolist())
                self._dual_residual.extend(np.asarray(dbuf)[:n].tolist())
            return

        # Callback path: per-iteration host loop over a niter=1 compiled
        # step (reference invokes the callback every iteration,
        # optimizer.py:315-316).
        cfg1 = ADMMConfig(
            niter=1,
            interval_update_mu=int(interval_update_mu),
            update_h=bool(update_h), max_mu=self._max_mu,
            fact_incr=float(fact_incr), th_change=float(th_change),
            relax=float(relax))
        run1 = self._plan._compiled_run(cfg1)
        for it in range(int(niter)):
            x, xp, h, mu, done, count, pbuf, dbuf = run1(
                self._x, self._h, self._mu, (rtol, atol),
                jnp.array(it, jnp.int32))
            self._x, self._h, self._mu = x, h, mu
            self._x_old = xp
            self._primal_residual.append(float(pbuf[0]))
            self._dual_residual.append(float(dbuf[0]))
            callback()
            if bool(done):
                return

    def one_sweep(self, update_h: bool = True) -> None:
        """Single Gauss–Seidel sweep + dual ascent (optimizer.py:322-341)."""
        self._x_old = tuple(self._x)
        factors = self._plan.compute_factors(self._mu)
        self._x, self._h, _ = self._plan.sweep(
            self._x, self._h, self._mu, factors, update_h)

    def residual(self) -> Tuple[float, float]:
        """(primal, dual) absolute residuals (optimizer.py:251-274)."""
        if self._x_old is None:
            raise RuntimeError(
                "residual() requires a prior one_sweep() (the reference "
                "crashes here with AttributeError, optimizer.py:324)")
        pn, dn, _ = self._plan.pair_residuals(self._x, self._x_old, self._mu)
        return (float(np.sum([np.asarray(p) for p in pn])),
                float(np.sum([np.asarray(d) for d in dn])))

    def check_convergence(self, rtol: float) -> bool:
        if self._x_old is None:
            raise RuntimeError("check_convergence() requires a prior one_sweep()")
        _, _, convs = self._plan.pair_residuals(
            self._x, self._x_old, self._mu)
        ok = True
        for rp, rd in convs:
            ok = ok and bool(rp < rtol) and bool(rd < rtol)
        return ok

    def update_mu(self, fact_incr: float = 2.0,
                  th_change: float = 10.0) -> None:
        if self._x_old is None:
            raise RuntimeError("update_mu() requires a prior one_sweep()")
        pn, dn, _ = self._plan.pair_residuals(self._x, self._x_old, self._mu)
        self._mu = self._plan.updated_mu(
            self._mu, pn, dn, fact_incr, th_change, self._max_mu)
