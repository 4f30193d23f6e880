"""Batched ADMM: solve many problem instances in one compiled graph.

This is the first-class parallelism the reference leaves on the table
(SURVEY.md §2.2): independent problem instances — per-frequency SpM
problems, λ-path sweeps, many-right-hand-side compressed sensing — are
``vmap``-ed over a leading batch axis and (optionally) sharded over a
device mesh.  The reference solves one ``SimpleOptimizer`` at a time
(``/root/reference/src/admmsolver/optimizer.py:302-320``); here a batch of
thousands converges inside a single ``jit``.

Control-flow design (SURVEY.md §7 hard part #2): per-instance convergence
inside a batch means masked "converged" lanes whose state is frozen via
``where`` selects, while the loop keeps stepping until *all* lanes are done
(a global reduction — under sharding XLA turns it into a psum, so every
host agrees on the exit).  Penalty updates stay per-instance (``mu`` is a
(B, npairs) array), but their *schedule* is iteration-count based and thus
shared, so factorization refresh happens at static chunk boundaries — the
batched analogue of the reference's hash-keyed cache
(``objectivefunc.py:89-96``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ADMMConfig
from ..models.problem import Model
from ..optimizer import ADMMPlan

__all__ = ["BatchedSolver", "BatchResult"]


def _cast_like(dtype, a):
    """Cast ``a`` to the real/complex companion of ``dtype`` (floats to
    its real type, complex to its complex type) so a mixed-precision phase
    doesn't get silently re-promoted by f64 constants."""
    a = jnp.asarray(a)
    dtype = np.dtype(dtype)
    if np.issubdtype(a.dtype, np.complexfloating):
        return a.astype(np.result_type(dtype, np.complex64))
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.dtype(dtype).type(0).real.dtype)
    return a


def _to_state_dtype(a, dtype):
    """Cast user-supplied initial state to the solver state dtype.

    Complex input to a REAL-dtype solve is explicit, not silent: the
    reference initializes state as ``complex128`` zeros
    (``optimizer.py:151,159``), so all-zero-imag complex ``x0``/``h0``
    is accepted (via an explicit ``.real``), but any nonzero imaginary
    part raises instead of being discarded (NumPy's ComplexWarning class
    of bug — the dtype discipline here forbids silent casts)."""
    a = jnp.asarray(a)
    if (np.issubdtype(a.dtype, np.complexfloating)
            and not np.issubdtype(np.dtype(dtype), np.complexfloating)):
        from ..ops.linop import _concrete

        im = _concrete(a.imag)
        if im is not None and np.any(np.asarray(im) != 0):
            raise TypeError(
                "complex initial state passed to a real-dtype solve would "
                "discard its imaginary part; wrap the model with "
                "admmsolver_tpu.realify_model or pass dtype=complex")
        a = a.real
    return a.astype(dtype)


def _parse_record_residuals(record_residuals) -> Tuple[bool, int]:
    """Normalize the ``record_residuals`` knob to ``(record, stride)``.

    ``True`` → per-iteration histories; ``False`` → none; an int ``s >= 1``
    → every s-th iteration (shared by every batched/fused driver)."""
    if record_residuals is True:
        return True, 1
    if record_residuals is False:
        return False, 1
    stride = int(record_residuals)
    if stride < 1:
        raise ValueError(
            f"record_residuals stride must be >= 1, got {stride}")
    return True, stride


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BatchResult:
    """Converged batch state.

    ``x``: tuple of (B, n_k) arrays; ``h``: tuple of (B, size_p) arrays;
    ``mu``: (B, npairs); ``iterations``: (B,) per-lane executed iteration
    counts; ``converged``: (B,) bools; ``primal_residual``/
    ``dual_residual``: (B, niter) histories, NaN-padded past each lane's
    exit (mirrors the reference's per-iteration history lists,
    ``optimizer.py:312-314``).
    """

    x: Tuple[jnp.ndarray, ...]
    h: Tuple[jnp.ndarray, ...]
    mu: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    primal_residual: jnp.ndarray
    dual_residual: jnp.ndarray


class BatchedSolver:
    """Solve a batch of same-structure problems.

    ``model`` is the template: its operators (A, C, E couplings) are shared
    across the batch.  Per-instance values are supplied to :meth:`solve` as
    ``overrides``: a dict ``{(block_index, field): batched_array}`` where
    ``field`` is one of the block objective's ``batch_fields`` (e.g.
    ``{(0, "y"): y_batch, (1, "alpha"): lambdas}`` for a λ-path sweep of
    ``LS + L1``).  Heavy derived values are handled once per instance in a
    vmapped prologue (e.g. ``A†y``), so the iteration body carries only the
    per-iteration math.

    ``sharding`` (optional): a ``jax.sharding.Sharding`` for the batch
    axis; all batched state is placed with it and the compiled loop runs
    SPMD over the mesh with the convergence reduction as a collective.
    """

    def __init__(self, model: Model, dtype=None, sharding=None) -> None:
        self.model = model
        self.plan = ADMMPlan(model)
        if dtype is None:
            # real problems get a real state (see ADMMPlan.is_complex)
            dtype = self.plan.default_dtype()
        self.dtype = jnp.dtype(dtype)
        self.sharding = sharding
        self._compiled_cache: Dict = {}

    # -- parameter binding -------------------------------------------------
    def _bind(self, ov: Dict):
        """Per-instance objective clones from an override dict (unbatched
        leaves — called inside vmap)."""
        if not ov:
            return list(self.model.functions)
        updates: Dict[int, Dict] = {}
        for (k, field), val in ov.items():
            updates.setdefault(k, {})[field] = val
        return [
            f.clone_with(**updates[k]) if k in updates else f
            for k, f in enumerate(self.model.functions)
        ]

    def _validate_overrides(self, overrides: Dict,
                            allow_large_A: bool = False) -> int:
        batch = None
        for (k, field), val in overrides.items():
            f = self.model.functions[k]
            if field not in f.batch_fields:
                raise ValueError(
                    f"block {k} ({type(f).__name__}) has no batchable "
                    f"field {field!r}; available: {f.batch_fields}")
            if np.ndim(val) < 1:
                raise ValueError(
                    f"override {(k, field)} must have a leading batch "
                    f"axis, got a scalar; wrap per-instance scalars as a "
                    f"(B,) array")
            if field == "A":
                # Per-instance operators force per-lane dense factors
                # ((B, n, n) inverses via inv_hpd_schur), which grow as
                # B·n² (CLAUDE.md: no per-lane dense factor state on the
                # hot path at large B x N).  n <= 128 keeps the factor
                # state small AND inside inv_hpd_schur's straight-line
                # envelope.  ``allow_large_A`` (solve_scan) lifts the cap: the scan
                # driver keeps only one group's factors resident.
                if f.size_x > 128 and not allow_large_A:
                    raise ValueError(
                        f"per-instance A batching is limited to blocks "
                        f"with n <= 128 (block {k} has n={f.size_x}): "
                        "per-lane dense factors at larger n violate the "
                        "HBM budget; use solve_scan (amortized scan over "
                        "instances) or rowshard for large single problems")
                want = getattr(f, "_A").shape
                if tuple(np.shape(val)[1:]) != tuple(want):
                    raise ValueError(
                        f"override {(k, 'A')} must be (B, {want[0]}, "
                        f"{want[1]}) matching the template operator, got "
                        f"{np.shape(val)}")
            b = np.shape(val)[0]
            if batch is None:
                batch = b
            elif batch != b:
                raise ValueError(
                    f"inconsistent batch sizes: {batch} vs {b} for "
                    f"override {(k, field)}")
        return batch

    def _prologue_overrides(self, ov: Dict) -> Dict:
        """Precompute derived per-instance values (unbatched; vmapped).

        ``y`` overrides on (Constrained)LeastSquares blocks are converted
        to ``Acy`` (= A†y) so the loop body never recomputes the reduction.
        """
        out = dict(ov)
        for (k, field) in list(out.keys()):
            if field == "y":
                f = self.model.functions[k]
                if (k, "A") in out:
                    # A†y must use the PER-INSTANCE operator, not the
                    # template's
                    f = f.clone_with(A=out[(k, "A")])
                if hasattr(f, "_Ac"):
                    out[(k, "Acy")] = f._Ac @ jnp.asarray(out[(k, field)])
        return out

    # -- compiled batched run ---------------------------------------------
    def _compiled(self, cfg: ADMMConfig, ov_keys: tuple, record: bool,
                  chunked_checks: bool = False, record_stride: int = 1):
        # Per-instance cache (a method-level functools.lru_cache would pin
        # the solver and its operator arrays for process lifetime).
        key = (cfg, ov_keys, record, chunked_checks, record_stride)
        cached = self._compiled_cache.get(key)
        if cached is not None:
            return cached
        run = jax.jit(self._build(cfg, ov_keys, record, chunked_checks,
                                  record_stride))
        if len(self._compiled_cache) >= 32:
            self._compiled_cache.pop(next(iter(self._compiled_cache)))
        self._compiled_cache[key] = run
        return run

    def _compiled_path(self, cfg: ADMMConfig, ov_keys: tuple, record: bool,
                       chunked_checks: bool, record_stride: int):
        """One jitted program for an entire warm-started path: a
        ``lax.scan`` over groups whose body is the same chunk schedule
        :meth:`_build` compiles for a single batch.

        A host-driven group loop pays one dispatch and host round trip
        per group.  The scan body is traced once, so compile time
        matches a single-group solve.
        """
        key = ("path", cfg, ov_keys, record, chunked_checks, record_stride)
        cached = self._compiled_cache.get(key)
        if cached is not None:
            return cached
        run = self._build(cfg, ov_keys, record, chunked_checks,
                          record_stride)

        def run_path(ov_stack, x, h, mu, tols):
            def body(carry, ov_vals):
                x, h, mu = carry
                done0 = jnp.zeros(mu.shape[0], dtype=bool)
                xg, hg, mug, done, count, pbuf, dbuf = run(
                    ov_vals, x, h, mu, tols, done0)
                # warm-start the next group from this group's LAST lane
                # (nearest path value) — same rule as the host-level loop
                bc = lambda a: jnp.broadcast_to(a[-1], a.shape)
                nxt = (tuple(bc(a) for a in xg), tuple(bc(a) for a in hg),
                       bc(mug))
                return nxt, (xg, hg, mug, done, count, pbuf, dbuf)

            _, outs = jax.lax.scan(body, (x, h, mu), ov_stack)
            return outs

        jitted = jax.jit(run_path)
        if len(self._compiled_cache) >= 32:
            self._compiled_cache.pop(next(iter(self._compiled_cache)))
        self._compiled_cache[key] = jitted
        return jitted

    def _compiled_mixed(self, cfg_lo: ADMMConfig, cfg_hi: ADMMConfig,
                        ov_keys: tuple, record: bool, chunked_checks: bool,
                        record_stride: int, low_dtype):
        """One jitted program for a two-phase mixed-precision solve: the
        low-precision phase, the dtype promotion of the hand-off state,
        and the full-precision phase run back-to-back on device.  Saves
        a host round trip plus the host-side re-setup between phases."""
        key = ("mixed", cfg_lo, cfg_hi, ov_keys, record, chunked_checks,
               record_stride, jnp.dtype(low_dtype).name)
        cached = self._compiled_cache.get(key)
        if cached is not None:
            return cached
        run_lo = self._build(cfg_lo, ov_keys, record, chunked_checks,
                             record_stride)
        run_hi = self._build(cfg_hi, ov_keys, record, chunked_checks,
                             record_stride)

        def run_mixed(ov_vals, x, h, mu, tols_lo, tols_hi, done0):
            lo = lambda t: tuple(_cast_like(low_dtype, a) for a in t)
            x1, h1, mu1, done1, c1, pb1, db1 = run_lo(
                lo(ov_vals), lo(x), lo(h), _cast_like(low_dtype, mu),
                tols_lo, done0)
            # promote the hand-off state to the full-precision phase's
            # dtypes (taken from the incoming state arrays)
            x2 = tuple(a.astype(o.dtype) for a, o in zip(x1, x))
            h2 = tuple(a.astype(o.dtype) for a, o in zip(h1, h))
            mu2 = mu1.astype(mu.dtype)
            xh, hh, muh, doneh, c2, pb2, db2 = run_hi(
                ov_vals, x2, h2, mu2, tols_hi,
                jnp.zeros_like(done0))
            return xh, hh, muh, doneh, c1 + c2, pb1, db1, pb2, db2

        jitted = jax.jit(run_mixed)
        if len(self._compiled_cache) >= 32:
            self._compiled_cache.pop(next(iter(self._compiled_cache)))
        self._compiled_cache[key] = jitted
        return jitted

    def _build(self, cfg: ADMMConfig, ov_keys: tuple, record: bool,
               chunked_checks: bool, record_stride: int):
        plan = self.plan
        interval = cfg.interval_update_mu
        niter = cfg.niter

        # Static key plan: `y` overrides on quadratic blocks are replaced
        # by the prologue-derived `Acy` so the loop body never recomputes
        # A†y (keys must stay static — only values flow through vmap).
        loop_keys = []
        for key in ov_keys:
            k, field = key
            if field == "y" and hasattr(self.model.functions[k], "_Ac"):
                loop_keys.append((k, "Acy"))
            else:
                loop_keys.append(key)
        loop_keys = tuple(loop_keys)

        def prologue(ov_vals):
            d = self._prologue_overrides(dict(zip(ov_keys, ov_vals)))
            return tuple(d[k] for k in loop_keys)

        def one_iter(ov2, carry, buf_idx, git, tols):
            functions = self._bind(dict(zip(loop_keys, ov2)))
            return plan.iteration(carry, buf_idx, git, cfg, tols, functions)

        def one_iter_sweep_only(ov2, carry, git):
            functions = self._bind(dict(zip(loop_keys, ov2)))
            carry, _ = plan.iteration(carry, 0, git, cfg, (0.0, 0.0),
                                      functions, compute_residuals=False)
            return carry

        def refactor(ov2, carry):
            functions = self._bind(dict(zip(loop_keys, ov2)))
            x, xp, h, mu, _, done, count, pb, db = carry
            factors = plan.compute_factors(mu, functions)
            return (x, xp, h, mu, factors, done, count, pb, db)

        v_iter = jax.vmap(one_iter, in_axes=(0, 0, None, None, None))
        v_iter_sweep = jax.vmap(one_iter_sweep_only, in_axes=(0, 0, None))
        v_refactor = jax.vmap(refactor, in_axes=(0, 0))
        v_factors = jax.vmap(
            lambda ov2, mu: plan.compute_factors(
                mu, self._bind(dict(zip(loop_keys, ov2)))),
            in_axes=(0, 0))

        # Strided history: one slot per `record_stride` iterations (the
        # last in-window value wins).  A (B, niter) f64 buffer pair at
        # north-star scale (B=10k, niter=10k) is ~1.6 GB — strided
        # recording keeps histories affordable at scale.
        hist = ((niter + record_stride - 1) // record_stride
                if record else 1)

        def buf_slot(git):
            if not record:
                return 0
            return jnp.minimum(git // record_stride, hist - 1)

        # NOTE: returned UNjitted so _compiled_path can scan over it;
        # _compiled wraps it in jax.jit for the single-batch entry.
        def run(ov_vals, x, h, mu, tols, done0):
            B = mu.shape[0]
            # ov2: prologue-derived per-instance values, batched.
            ov2 = jax.vmap(prologue)(ov_vals) if ov_keys else ()
            factors = v_factors(ov2, mu)
            rdtype = jnp.zeros(()).dtype
            pbuf = jnp.full((B, hist), jnp.nan, dtype=rdtype)
            dbuf = jnp.full((B, hist), jnp.nan, dtype=rdtype)
            carry = (x, x, h, mu, factors, done0,
                     jnp.zeros(B, dtype=jnp.int32), pbuf, dbuf)

            def step(carry, buf_idx, git):
                carry, _ = v_iter(ov2, carry, buf_idx, git, tols)
                return carry

            # iteration 0, then refactor (mu update fires at global_it=0,
            # reference optimizer.py:319-320)
            carry = step(carry, 0, 0)
            carry = v_refactor(ov2, carry)

            def chunk_cond(state):
                it, carry = state
                done = carry[5]
                return (it < niter) & jnp.logical_not(jnp.all(done))

            def masked(new_carry, carry, skip):
                # Mask iterations past the requested budget (the last
                # chunk may overshoot niter).
                return jax.tree_util.tree_map(
                    lambda n, o: jnp.where(skip, o, n), new_carry, carry)

            def chunk_body(state):
                it, carry = state

                if chunked_checks:
                    # Sweep-only iterations; residuals/convergence/penalty
                    # only on the boundary iteration of the chunk.
                    def scan_body(carry, i):
                        git = it + i
                        new_carry = v_iter_sweep(ov2, carry, git)
                        return masked(new_carry, carry, git >= niter), None

                    carry, _ = jax.lax.scan(
                        scan_body, carry, jnp.arange(interval - 1))
                    git = it + interval - 1
                    carry = masked(step(carry, buf_slot(git), git), carry,
                                   git >= niter)
                else:
                    def scan_body(carry, i):
                        git = it + i
                        new_carry = step(carry, buf_slot(git), git)
                        return masked(new_carry, carry, git >= niter), None

                    carry, _ = jax.lax.scan(
                        scan_body, carry, jnp.arange(interval))
                carry = v_refactor(ov2, carry)
                return (it + interval, carry)

            _, carry = jax.lax.while_loop(
                chunk_cond, chunk_body,
                (jnp.array(1, jnp.int32), carry))
            x, xp, h, mu, _, done, count, pbuf, dbuf = carry
            return x, h, mu, done, count, pbuf, dbuf

        return run

    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              x0: Optional[Sequence] = None,
              h0: Optional[Sequence] = None,
              mu0=1.0,
              niter: int = 10000,
              interval_update_mu: int = 100,
              update_h: bool = True,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              record_residuals: Union[bool, int] = True,
              dtype=None,
              chunked_checks: bool = False,
              done0=None,
              recipe: str = "auto",
              relax: float = 1.0) -> BatchResult:
        """Solve the batch.  Reference-default knobs
        (``optimizer.py:302-309,277,125``); ``atol`` adds an absolute
        primal+dual residual stop (0 = off); ``fact_incr``/``th_change``
        tune the penalty adaptation as the reference's ``update_mu``
        does; ``dtype`` overrides the solver's state dtype for this call
        (mixed-precision phases); ``h0`` warm-starts the duals (resume /
        phase hand-off); ``chunked_checks=True`` evaluates residuals/
        convergence/penalty adaptation only on penalty-boundary
        iterations (throughput mode — histories have one sample per
        ``interval_update_mu`` iterations and lanes may overrun their
        convergence point by up to one interval; the default preserves
        exact per-iteration reference semantics).

        ``record_residuals``: True = per-iteration histories ((B, niter)
        f64 buffers — ~1.6 GB at B=10k, niter=10k); an int ``s`` records
        one sample per ``s`` iterations ((B, ceil(niter/s)) buffers);
        False = none.  ``done0``: optional (B,) bool mask of lanes to
        freeze from the start (parked lanes in schedulers, already-
        converged lanes on resume); frozen lanes cost no sweeps and do
        not hold up the global convergence exit.

        ``recipe``: ``"auto"`` (default) and ``"plain"`` run the
        single-phase solve (exact reference trajectory semantics);
        ``"mixed"`` runs the mixed-precision recipe (3/4 of the budget
        in f32, then a full-precision polish, :meth:`solve_mixed`).
        ``"auto"`` is the hook for a measured per-workload choice; no
        workload selects mixed yet."""
        if niter <= 0:
            raise ValueError("niter must be positive for batched solves")
        if recipe not in ("auto", "plain", "mixed"):
            raise ValueError(f"recipe must be auto|plain|mixed, {recipe!r}")
        # niter=1 cannot split into two positive phases — run plain.
        if recipe == "mixed" and niter >= 2:
            nl = 3 * niter // 4
            return self.solve_mixed(
                overrides, niter_low=max(nl, 1), niter=niter - max(nl, 1),
                # fixed-iteration runs (rtol=atol=0) burn the full f32
                # budget; convergence runs let phase 1 exit at plateau
                low_rtol=(0.0 if (rtol == 0.0 and atol == 0.0) else 1e-6),
                batch_size=batch_size, x0=x0, h0=h0, mu0=mu0,
                interval_update_mu=interval_update_mu, update_h=update_h,
                rtol=rtol, atol=atol, fact_incr=fact_incr,
                th_change=th_change, max_mu=max_mu,
                record_residuals=record_residuals,
                chunked_checks=chunked_checks, done0=done0, relax=relax,
                dtype=dtype)
        dtype = self.dtype if dtype is None else jnp.dtype(dtype)
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides)
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError(
                "batch size is undetermined: pass overrides with a leading "
                "batch axis or batch_size=")
        if batch_size is not None and batch_size != B:
            raise ValueError(f"batch_size={batch_size} != override batch {B}")

        plan = self.plan
        if x0 is not None:
            x = tuple(_to_state_dtype(x_, dtype) for x_ in x0)
            assert all(x_.shape == (B, n)
                       for x_, n in zip(x, plan.block_sizes))
        else:
            x = tuple(jnp.zeros((B, n), dtype=dtype)
                      for n in plan.block_sizes)
        if h0 is not None:
            h = tuple(_to_state_dtype(h_, dtype) for h_ in h0)
            assert all(h_.shape == (B, s)
                       for h_, s in zip(h, plan.pair_sizes))
        else:
            h = tuple(jnp.zeros((B, s), dtype=dtype)
                      for s in plan.pair_sizes)
        mu0 = _cast_like(dtype, mu0)
        if mu0.ndim == 0:
            mu = jnp.full((B, plan.npairs), mu0)
        elif mu0.ndim == 1:
            mu = jnp.broadcast_to(mu0[:, None], (B, plan.npairs))
        else:
            mu = mu0
            assert mu.shape == (B, plan.npairs)
        overrides = {k: _cast_like(dtype, v) for k, v in overrides.items()}
        if done0 is None:
            done0 = jnp.zeros(B, dtype=bool)
        else:
            done0 = jnp.asarray(done0, dtype=bool)
            assert done0.shape == (B,), done0.shape

        B_orig = B
        if self.sharding is not None:
            # Pad uneven batches to a multiple of the mesh size (padding
            # lanes replicate lane 0 and are trimmed from the result).
            ndev = getattr(self.sharding, "num_devices", 1)
            if B % ndev != 0:
                Bp = ((B + ndev - 1) // ndev) * ndev
                pad = lambda a: jnp.concatenate(
                    [a, jnp.broadcast_to(a[:1], (Bp - B,) + a.shape[1:])])
                x = tuple(pad(x_) for x_ in x)
                h = tuple(pad(h_) for h_ in h)
                mu = pad(mu)
                # padding lanes start done: they never iterate
                done0 = jnp.concatenate(
                    [done0, jnp.ones(Bp - B, dtype=bool)])
                overrides = {k: pad(jnp.asarray(v))
                             for k, v in overrides.items()}
                B = Bp
            put = lambda t: jax.device_put(t, self.sharding)
            x, h, mu, done0 = put(x), put(h), put(mu), put(done0)
            overrides = {k: put(jnp.asarray(v))
                         for k, v in overrides.items()}

        cfg = ADMMConfig(niter=int(niter),
                         interval_update_mu=int(interval_update_mu),
                         update_h=bool(update_h), max_mu=float(max_mu),
                         fact_incr=float(fact_incr),
                         th_change=float(th_change),
                         relax=float(relax))
        ov_keys = tuple(sorted(overrides.keys()))
        ov_vals = tuple(jnp.asarray(overrides[k]) for k in ov_keys)
        record, stride = _parse_record_residuals(record_residuals)
        run = self._compiled(cfg, ov_keys, record, bool(chunked_checks),
                             stride)
        x, h, mu, done, count, pbuf, dbuf = run(ov_vals, x, h, mu,
                                                (rtol, atol), done0)
        if B_orig != B:
            trim = lambda a: a[:B_orig]
            x, h = tuple(map(trim, x)), tuple(map(trim, h))
            mu, done, count = trim(mu), trim(done), trim(count)
            pbuf, dbuf = trim(pbuf), trim(dbuf)
        return BatchResult(x=x, h=h, mu=mu, iterations=count,
                           converged=done, primal_residual=pbuf,
                           dual_residual=dbuf)

    def solve_path(self,
                   field: Tuple[int, str],
                   values,
                   overrides: Optional[Dict] = None,
                   group_size: Optional[int] = None,
                   fused: bool = True,
                   **kw) -> BatchResult:
        """Warm-started regularization-path continuation.

        Splits ``values`` (e.g. a descending λ grid) into groups of
        ``group_size``; each group solves as one batch, warm-started from
        the previous group's solutions (nearest value's state).  For dense
        paths this cuts iteration counts several-fold versus cold starts
        while keeping device-parallel batches.  Returns concatenated
        per-value results in input order.

        ``fused=True`` (default) runs the whole group schedule inside ONE
        jit (``lax.scan`` over groups): one dispatch instead of one per
        group.  Results are
        identical to the host-driven loop (``fused=False``): same chunk
        schedule, same warm-start rule, same dtypes.  Falls back to the
        loop when there is only one group or when the solver is sharded
        (the per-group `solve` path owns the device placement logic).
        """
        values = np.asarray(values)
        n = values.shape[0]
        if group_size is None:
            group_size = n
        if group_size < n:
            # Warm starts broadcast the previous group's LAST lane state —
            # only sensible when consecutive values are nearest neighbors.
            d = np.diff(values.astype(np.float64))
            if not (np.all(d <= 0) or np.all(d >= 0)):
                raise ValueError(
                    "solve_path warm-starting requires a monotone `values` "
                    "grid (each group is seeded from the previous group's "
                    "last solution); sort the values or pass "
                    "group_size=len(values)")
        overrides = dict(overrides or {})
        if fused and group_size < n and self.sharding is None:
            return self._solve_path_fused(field, values, overrides,
                                          group_size, **kw)
        mu0_init = kw.pop("mu0", 1.0)
        parts = []
        prev = None
        for s in range(0, n, group_size):
            vals = values[s:s + group_size]
            # additional overrides must be per-value (length n); sliced
            # alongside the path values
            ov = {k: np.asarray(v)[s:s + group_size]
                  for k, v in overrides.items()}
            ov[field] = vals
            if prev is None:
                x0 = h0 = None
                mu0 = mu0_init
            else:
                # warm start every lane from the previous group's last
                # (nearest) solution
                take = lambda t: tuple(
                    jnp.broadcast_to(a[-1], (vals.shape[0],) + a.shape[1:])
                    for a in t)
                x0, h0 = take(prev.x), take(prev.h)
                mu0 = jnp.broadcast_to(prev.mu[-1],
                                       (vals.shape[0],) + prev.mu.shape[1:])
            prev = self.solve(ov, x0=x0, h0=h0, mu0=mu0, **kw)
            parts.append(prev)
        if len(parts) == 1:
            return parts[0]
        cat = lambda get: jnp.concatenate([get(p) for p in parts])
        return BatchResult(
            x=tuple(cat(lambda p, i=i: p.x[i])
                    for i in range(len(parts[0].x))),
            h=tuple(cat(lambda p, i=i: p.h[i])
                    for i in range(len(parts[0].h))),
            mu=cat(lambda p: p.mu),
            iterations=cat(lambda p: p.iterations),
            converged=cat(lambda p: p.converged),
            primal_residual=cat(lambda p: p.primal_residual),
            dual_residual=cat(lambda p: p.dual_residual))

    def _solve_path_fused(self,
                          field: Tuple[int, str],
                          values: np.ndarray,
                          overrides: Dict,
                          group_size: int,
                          x0: Optional[Sequence] = None,
                          h0: Optional[Sequence] = None,
                          mu0=1.0,
                          niter: int = 10000,
                          interval_update_mu: int = 100,
                          update_h: bool = True,
                          rtol: float = 1e-12,
                          atol: float = 0.0,
                          fact_incr: float = 2.0,
                          th_change: float = 10.0,
                          max_mu: float = 1e3,
                          record_residuals: Union[bool, int] = True,
                          dtype=None,
                          chunked_checks: bool = False) -> BatchResult:
        """Whole-path driver: ``lax.scan`` over warm-started groups inside
        one jit (see :meth:`solve_path`).  Semantics match the host loop
        exactly; the last group is padded by repeating the final value
        when ``len(values)`` is not a multiple of ``group_size`` (padding
        lanes are trimmed from the result)."""
        if niter <= 0:
            raise ValueError("niter must be positive for batched solves")
        dtype = self.dtype if dtype is None else jnp.dtype(dtype)
        n = values.shape[0]
        gs = int(group_size)
        G = (n + gs - 1) // gs
        pad_n = G * gs - n
        stack = lambda a: jnp.reshape(
            jnp.concatenate([a, jnp.broadcast_to(a[-1:],
                                                 (pad_n,) + a.shape[1:])])
            if pad_n else a, (G, gs) + a.shape[1:])
        ov = {k: _cast_like(dtype, np.asarray(v)) for k, v in
              overrides.items()}
        ov[field] = _cast_like(dtype, values)
        for (k, f_), v in ov.items():
            if v.shape[0] != n:
                raise ValueError(
                    f"solve_path override {(k, f_)} must be per-value "
                    f"(length {n}), got leading axis {v.shape[0]}")
        # batch-field validation (same checks the host loop gets via solve)
        self._validate_overrides(ov)
        ov_keys = tuple(sorted(ov.keys()))
        ov_stack = tuple(stack(jnp.asarray(ov[k])) for k in ov_keys)

        plan = self.plan
        if x0 is not None:
            x = tuple(_to_state_dtype(x_, dtype) for x_ in x0)
            assert all(x_.shape == (gs, sz)
                       for x_, sz in zip(x, plan.block_sizes))
        else:
            x = tuple(jnp.zeros((gs, sz), dtype=dtype)
                      for sz in plan.block_sizes)
        if h0 is not None:
            h = tuple(_to_state_dtype(h_, dtype) for h_ in h0)
            assert all(h_.shape == (gs, sz)
                       for h_, sz in zip(h, plan.pair_sizes))
        else:
            h = tuple(jnp.zeros((gs, sz), dtype=dtype)
                      for sz in plan.pair_sizes)
        mu0 = _cast_like(dtype, mu0)
        if mu0.ndim == 0:
            mu = jnp.full((gs, plan.npairs), mu0)
        elif mu0.ndim == 1:
            mu = jnp.broadcast_to(mu0[:, None], (gs, plan.npairs))
        else:
            mu = jnp.asarray(mu0)
            assert mu.shape == (gs, plan.npairs)

        cfg = ADMMConfig(niter=int(niter),
                         interval_update_mu=int(interval_update_mu),
                         update_h=bool(update_h), max_mu=float(max_mu),
                         fact_incr=float(fact_incr),
                         th_change=float(th_change))
        record, stride = _parse_record_residuals(record_residuals)
        run = self._compiled_path(cfg, ov_keys, record,
                                  bool(chunked_checks), stride)
        xg, hg, mug, done, count, pbuf, dbuf = run(ov_stack, x, h, mu,
                                                   (rtol, atol))
        flat = lambda a: jnp.reshape(a, (G * gs,) + a.shape[2:])[:n]
        return BatchResult(
            x=tuple(flat(a) for a in xg),
            h=tuple(flat(a) for a in hg),
            mu=flat(mug), iterations=flat(count), converged=flat(done),
            primal_residual=flat(pbuf), dual_residual=flat(dbuf))

    def solve_scan(self,
                   overrides: Dict,
                   group_size: int = 1,
                   x0: Optional[Sequence] = None,
                   h0: Optional[Sequence] = None,
                   mu0=1.0,
                   niter: int = 10000,
                   interval_update_mu: int = 100,
                   update_h: bool = True,
                   rtol: float = 1e-12,
                   atol: float = 0.0,
                   fact_incr: float = 2.0,
                   th_change: float = 10.0,
                   max_mu: float = 1e3,
                   record_residuals: Union[bool, int] = False,
                   chunked_checks: bool = False,
                   relax: float = 1.0) -> BatchResult:
        """Amortized sequential solve: ``lax.map`` over instance groups
        reusing ONE compiled group solve — one dispatch total.

        The fallback for batches of LARGE heterogeneous problems (per-
        instance ``(k, 'A')`` operators with n > 128): :meth:`solve`
        keeps every lane's dense factor resident ((B, n, n) — an HBM
        blowup the n <= 128 cap guards), and looping ``SimpleOptimizer``
        from Python pays a dispatch per instance.  Here only
        ``group_size`` instances' factors exist at a time, the whole
        schedule is one program, and each group's factorization takes
        the non-vmapped Cholesky path (n > 128
        dense blocks, ``_inv_hpd``).  Reference analogue: one
        ``SimpleOptimizer`` per problem (``optimizer.py:121-152``).

        Wall-clock is sequential over ``B / group_size`` groups — use
        :meth:`solve` when the factor state fits.  ``record_residuals``
        defaults to False (histories would be (B, niter) host-side).
        """
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides, allow_large_A=True)
        if B is None:
            raise ValueError("solve_scan needs overrides with a leading "
                             "batch axis")
        if niter <= 0:
            raise ValueError("niter must be positive for batched solves")
        g = int(group_size)
        G = (B + g - 1) // g
        pad_n = G * g - B
        dtype = self.dtype
        plan = self.plan

        stack = lambda a: jnp.reshape(
            jnp.concatenate([a, jnp.broadcast_to(a[-1:],
                                                 (pad_n,) + a.shape[1:])])
            if pad_n else a, (G, g) + a.shape[1:])
        ov = {k: _cast_like(dtype, jnp.asarray(v))
              for k, v in overrides.items()}
        ov_keys = tuple(sorted(ov.keys()))
        ov_stack = tuple(stack(ov[k]) for k in ov_keys)

        state_stack = lambda t: tuple(
            stack(_to_state_dtype(a, dtype)) for a in t)
        xs = (state_stack(x0) if x0 is not None else
              tuple(jnp.zeros((G, g, n), dtype=dtype)
                    for n in plan.block_sizes))
        hs = (state_stack(h0) if h0 is not None else
              tuple(jnp.zeros((G, g, s), dtype=dtype)
                    for s in plan.pair_sizes))
        mu0 = _cast_like(dtype, mu0)
        if mu0.ndim == 0:
            mus = jnp.full((G, g, plan.npairs), mu0)
        else:
            mus = stack(jnp.broadcast_to(
                mu0[:, None] if mu0.ndim == 1 else mu0,
                (B, plan.npairs)))

        cfg = ADMMConfig(niter=int(niter),
                         interval_update_mu=int(interval_update_mu),
                         update_h=bool(update_h), max_mu=float(max_mu),
                         fact_incr=float(fact_incr),
                         th_change=float(th_change),
                         relax=float(relax))
        record, stride = _parse_record_residuals(record_residuals)
        key = ("scan", cfg, ov_keys, record, bool(chunked_checks),
               stride, g)
        jitted = self._compiled_cache.get(key)
        if jitted is None:
            run = self._build(cfg, ov_keys, record, bool(chunked_checks),
                              stride)

            def run_scan(ov_stack, xs, hs, mus, tols):
                def one(group):
                    ov_g, x, h, mu = group
                    done0 = jnp.zeros(mu.shape[0], dtype=bool)
                    return run(ov_g, x, h, mu, tols, done0)

                return jax.lax.map(one, (ov_stack, xs, hs, mus))

            jitted = jax.jit(run_scan)
            if len(self._compiled_cache) >= 32:
                self._compiled_cache.pop(next(iter(self._compiled_cache)))
            self._compiled_cache[key] = jitted
        xg, hg, mug, done, count, pbuf, dbuf = jitted(
            ov_stack, xs, hs, mus, (rtol, atol))
        flat = lambda a: jnp.reshape(a, (G * g,) + a.shape[2:])[:B]
        return BatchResult(
            x=tuple(flat(a) for a in xg),
            h=tuple(flat(a) for a in hg),
            mu=flat(mug), iterations=flat(count), converged=flat(done),
            primal_residual=flat(pbuf), dual_residual=flat(dbuf))

    def solve_resumable(self,
                        path: str,
                        overrides: Optional[Dict] = None,
                        checkpoint_every: int = 1000,
                        niter: int = 10000,
                        mu0=1.0,
                        **kw) -> "BatchResult":
        """Preemption-tolerant solve: checkpoint every ``checkpoint_every``
        iterations, resume from ``path`` if it exists.

        The reference's only resume mechanism is a manual ``x0`` warm
        start (``optimizer.py:146-149``); this drives the same warm-start
        machinery segment-by-segment at the host level and persists the
        full carry (primal, dual, penalties, per-lane iteration counts,
        convergence flags) via :mod:`admmsolver_tpu.utils.checkpoint`
        after each segment.  Killing the process at any point loses at
        most one segment of work.

        Penalty-update schedule caveat: each segment starts the
        ``interval_update_mu`` clock afresh (exactly like a fresh solve
        from a warm start), so pick ``checkpoint_every`` as a multiple of
        ``interval_update_mu`` to keep the uninterrupted schedule.
        Converged lanes freeze across segments (their relative change is
        0, so they re-converge immediately).
        """
        import os

        from ..utils.checkpoint import load_batch_result, save_batch_result

        # segments continue exact state; the mixed recipe's f32 phase
        # would truncate a warm-started carry mid-run
        kw.setdefault("recipe", "plain")
        x0 = h0 = None
        done_iters = 0
        total = None
        if os.path.exists(path):
            ckpt = load_batch_result(path)
            x0, h0, mu0 = ckpt.x, ckpt.h, ckpt.mu
            total = np.asarray(ckpt.iterations)
            done_iters = int(total.max())
        res = None
        while done_iters < niter:
            n = min(int(checkpoint_every), niter - done_iters)
            res = self.solve(overrides, x0=x0, h0=h0, mu0=mu0, niter=n,
                             **kw)
            x0, h0, mu0 = res.x, res.h, res.mu
            done_iters += n
            total = (np.asarray(res.iterations) if total is None
                     else total + np.asarray(res.iterations))
            res = BatchResult(
                x=res.x, h=res.h, mu=res.mu,
                iterations=jnp.asarray(total),
                converged=res.converged,
                primal_residual=res.primal_residual,
                dual_residual=res.dual_residual)
            save_batch_result(path, res)
            if bool(np.all(np.asarray(res.converged))):
                break
        if res is None:
            # checkpoint already covered the full budget
            res = load_batch_result(path)
        return res

    def solve_mixed(self,
                    overrides: Optional[Dict] = None,
                    niter_low: int = 2000,
                    niter: int = 10000,
                    low_dtype="float32",
                    low_rtol: float = 1e-6,
                    fused: bool = False,
                    dtype=None,
                    **kw) -> BatchResult:
        """Two-phase mixed-precision solve (SURVEY.md §7 hard part #1).

        Phase 1 iterates in ``low_dtype`` until the relative residual change plateaus at
        ``low_rtol`` or ``niter_low`` is reached; phase 2 continues the
        SAME primal/dual/penalty state at the solver's full precision to
        the requested tolerance.  ADMM is self-correcting — the dual state
        carries the low-precision phase's progress exactly — so the
        hand-off costs nothing in final accuracy.

        ``fused=True`` runs both phases and the dtype promotion inside
        ONE jit, saving a host dispatch.  Results match the two-dispatch
        driver exactly; which is faster on the GPU is not measured yet.
        Use it when the per-call dispatch dominates (short solves, many
        calls).  Sharded solvers always take the
        two-dispatch path (``solve`` owns placement).
        """
        kw.pop("recipe", None)  # the phases ARE the recipe
        if fused and self.sharding is None:
            if dtype is not None and jnp.dtype(dtype) != self.dtype:
                raise ValueError(
                    "the fused mixed driver always polishes at the "
                    "solver dtype; construct the solver with the "
                    "desired full precision or use fused=False")
            return self._solve_mixed_fused(
                overrides, niter_low=niter_low, niter=niter,
                low_dtype=low_dtype, low_rtol=low_rtol, **kw)
        p1 = self.solve(overrides, niter=niter_low, dtype=low_dtype,
                        rtol=low_rtol, recipe="plain",
                        **{k: v for k, v in kw.items()
                           if k not in ("rtol", "atol")})
        # phase 2 continues phase 1's state at the FULL precision — the
        # caller's explicit dtype when given, else the solver dtype
        p2 = self.solve(overrides, x0=p1.x, h0=p1.h, mu0=p1.mu,
                        niter=niter, recipe="plain", dtype=dtype,
                        **{k: v for k, v in kw.items()
                           if k not in ("mu0", "x0", "h0")})
        return BatchResult(
            x=p2.x, h=p2.h, mu=p2.mu,
            iterations=p1.iterations + p2.iterations,
            converged=p2.converged,
            primal_residual=jnp.concatenate(
                [p1.primal_residual, p2.primal_residual], axis=1),
            dual_residual=jnp.concatenate(
                [p1.dual_residual, p2.dual_residual], axis=1))

    def _solve_mixed_fused(self,
                           overrides: Optional[Dict] = None,
                           niter_low: int = 2000,
                           niter: int = 10000,
                           low_dtype="float32",
                           low_rtol: float = 1e-6,
                           batch_size: Optional[int] = None,
                           x0: Optional[Sequence] = None,
                           h0: Optional[Sequence] = None,
                           mu0=1.0,
                           interval_update_mu: int = 100,
                           update_h: bool = True,
                           rtol: float = 1e-12,
                           atol: float = 0.0,
                           fact_incr: float = 2.0,
                           th_change: float = 10.0,
                           max_mu: float = 1e3,
                           record_residuals: Union[bool, int] = True,
                           chunked_checks: bool = False) -> BatchResult:
        """One-jit two-phase solve (see :meth:`solve_mixed`)."""
        if niter_low <= 0 or niter <= 0:
            raise ValueError("phase iteration budgets must be positive")
        dtype = self.dtype
        low_dtype = jnp.dtype(low_dtype)
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides)
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError(
                "batch size is undetermined: pass overrides with a leading "
                "batch axis or batch_size=")

        plan = self.plan
        if x0 is not None:
            x = tuple(_to_state_dtype(x_, dtype) for x_ in x0)
        else:
            x = tuple(jnp.zeros((B, n), dtype=dtype)
                      for n in plan.block_sizes)
        if h0 is not None:
            h = tuple(_to_state_dtype(h_, dtype) for h_ in h0)
        else:
            h = tuple(jnp.zeros((B, s), dtype=dtype)
                      for s in plan.pair_sizes)
        mu0 = _cast_like(dtype, mu0)
        if mu0.ndim == 0:
            mu = jnp.full((B, plan.npairs), mu0)
        elif mu0.ndim == 1:
            mu = jnp.broadcast_to(mu0[:, None], (B, plan.npairs))
        else:
            mu = jnp.asarray(mu0)
            assert mu.shape == (B, plan.npairs)
        overrides = {k: _cast_like(dtype, v) for k, v in overrides.items()}
        done0 = jnp.zeros(B, dtype=bool)

        mk_cfg = lambda n: ADMMConfig(
            niter=int(n), interval_update_mu=int(interval_update_mu),
            update_h=bool(update_h), max_mu=float(max_mu),
            fact_incr=float(fact_incr), th_change=float(th_change))
        record, stride = _parse_record_residuals(record_residuals)
        ov_keys = tuple(sorted(overrides.keys()))
        ov_vals = tuple(jnp.asarray(overrides[k]) for k in ov_keys)
        run = self._compiled_mixed(mk_cfg(niter_low), mk_cfg(niter),
                                   ov_keys, record, bool(chunked_checks),
                                   stride, low_dtype)
        xh, hh, muh, done, count, pb1, db1, pb2, db2 = run(
            ov_vals, x, h, mu, (low_rtol, 0.0), (rtol, atol), done0)
        return BatchResult(
            x=xh, h=hh, mu=muh, iterations=count, converged=done,
            primal_residual=jnp.concatenate([pb1, pb2], axis=1),
            dual_residual=jnp.concatenate([db1, db2], axis=1))
