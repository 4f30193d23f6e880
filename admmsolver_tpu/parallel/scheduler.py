"""Scenario scheduler: continuous batching over a stream of problems.

BASELINE.json calls for "a scenario-batch scheduler with consensus
reductions across hosts": when there are more independent problem
instances (scenarios) than fit one device batch — 10k+ per-frequency SpM
problems, dense λ grids — a fixed-width batch runs on the device and the
scheduler swaps **converged lanes out and fresh scenarios in** at chunk
boundaries, keeping device utilization high instead of waiting for the
slowest lane of a static batch (the same idea as continuous batching in
LLM serving).

Runs on top of :class:`~admmsolver_tpu.parallel.batch.BatchedSolver`
(sharded or not); each wave is one compiled multi-iteration call.  The
penalty-update schedule restarts per wave, matching the reference's
behavior under repeated ``solve()`` calls (``optimizer.py:310,319``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ADMMConfig
from .batch import BatchedSolver, _cast_like

__all__ = ["ScenarioScheduler", "ScenarioResult"]


@dataclasses.dataclass
class ScenarioResult:
    """Outcome of one scenario."""

    scenario_id: int
    x: Tuple[np.ndarray, ...]
    iterations: int
    converged: bool
    final_mu: np.ndarray


class ScenarioScheduler:
    """Drain a stream of scenarios through a fixed-width device batch.

    ``scenarios``: iterable of override dicts ``{(block, field): value}``
    (unbatched per-instance values, same keys for every scenario).
    Lanes whose problem converges (``atol``/``rtol``) or exhausts
    ``niter_max`` are harvested and refilled each ``chunk_iters``-iteration
    wave.
    """

    def __init__(self, solver: BatchedSolver, batch_size: int,
                 chunk_iters: int = 100, niter_max: int = 10000,
                 rtol: float = 1e-12, atol: float = 0.0,
                 mu0: float = 1.0, **solve_kw) -> None:
        self.solver = solver
        self.B = int(batch_size)
        self.chunk_iters = int(chunk_iters)
        self.niter_max = int(niter_max)
        self.rtol = rtol
        self.atol = atol
        self.mu0 = float(mu0)
        # waves continue exact per-lane state; the auto mixed recipe
        # would truncate warm-started carries to f32 each wave
        solve_kw.setdefault("recipe", "plain")
        self.solve_kw = solve_kw

    def run(self, scenarios: Iterable[Dict]) -> List[ScenarioResult]:
        plan = self.solver.plan
        it = iter(enumerate(scenarios))
        B = self.B

        # Lane state (host mirrors; device work happens per wave).
        first = next(it, None)
        if first is None:
            return []
        sid0, ov0 = first
        keys = tuple(sorted(ov0.keys()))

        lane_sid = np.full(B, -1, dtype=np.int64)
        lane_iters = np.zeros(B, dtype=np.int64)
        lane_ov = {k: np.zeros((B,) + np.shape(np.asarray(ov0[k])),
                               dtype=np.asarray(ov0[k]).dtype)
                   for k in keys}
        dtype = self.solver.dtype
        x = [np.zeros((B, n), dtype=dtype) for n in plan.block_sizes]
        h = [np.zeros((B, s), dtype=dtype) for s in plan.pair_sizes]
        mu = np.full((B, plan.npairs), self.mu0)

        def load(lane: int, sid: int, ov: Dict) -> None:
            assert tuple(sorted(ov.keys())) == keys, \
                f"scenario {sid} keys {sorted(ov.keys())} != {keys}"
            lane_sid[lane] = sid
            lane_iters[lane] = 0
            for k in keys:
                lane_ov[k][lane] = np.asarray(ov[k])
            for a in x:
                a[lane] = 0
            for a in h:
                a[lane] = 0
            mu[lane] = self.mu0

        load(0, sid0, ov0)
        pending = True
        for lane in range(1, B):
            nxt = next(it, None)
            if nxt is None:
                pending = False
                break
            load(lane, *nxt)

        results: List[ScenarioResult] = []

        while (lane_sid >= 0).any():
            res = self.solver.solve(
                overrides={k: lane_ov[k] for k in keys},
                x0=tuple(np.asarray(a) for a in x),
                h0=tuple(np.asarray(a) for a in h),
                mu0=np.asarray(mu),
                niter=self.chunk_iters, rtol=self.rtol, atol=self.atol,
                record_residuals=False,
                # parked lanes (drained stream) freeze from iteration 0
                # instead of re-solving their old problem every wave
                done0=lane_sid < 0,
                **self.solve_kw)
            # np.array (copy): np.asarray on device arrays gives read-only
            # views, and lanes are mutated on reload.
            for i, a in enumerate(res.x):
                x[i] = np.array(a)
            for i, a in enumerate(res.h):
                h[i] = np.array(a)
            mu = np.array(res.mu)
            conv = np.asarray(res.converged)
            lane_iters += np.asarray(res.iterations)

            for lane in range(B):
                if lane_sid[lane] < 0:
                    continue
                done = bool(conv[lane]) or lane_iters[lane] >= self.niter_max
                if not done:
                    continue
                results.append(ScenarioResult(
                    scenario_id=int(lane_sid[lane]),
                    x=tuple(np.array(a[lane]) for a in x),
                    iterations=int(lane_iters[lane]),
                    converged=bool(conv[lane]),
                    final_mu=np.array(mu[lane])))
                nxt = next(it, None) if pending else None
                if nxt is None:
                    pending = False
                    lane_sid[lane] = -1
                    # park the lane on a converged no-op state
                    lane_iters[lane] = 0
                else:
                    load(lane, *nxt)

        results.sort(key=lambda r: r.scenario_id)
        return results

    # ------------------------------------------------------------------
    # Fully-compiled continuous batching
    # ------------------------------------------------------------------
    def run_compiled(self, scenarios: Iterable[Dict]) -> List[ScenarioResult]:
        """Drain the whole stream inside ONE compiled program.

        :meth:`run` drives its wave loop from the host — each wave pays
        a per-call dispatch and host round trip.  Here
        the harvest/refill bookkeeping itself is device code: scenario
        overrides are pre-staged as (S, ...) arrays, lane->scenario
        assignment, converged-lane harvest (scatter into (S, ...) output
        slots), and fresh-scenario refill (gather + state reset) all run
        between chunks inside one ``lax.while_loop`` — one dispatch for
        the entire stream.

        Semantics match :meth:`run`: the penalty-update clock restarts
        per wave, ``mu`` persists across a lane's waves, lanes exceeding
        ``niter_max`` are harvested unconverged, results are per
        scenario id.  Requires the stream to be materializable (it is
        staged to the device up front); for unbounded/lazy streams use
        :meth:`run`.  Unsupported ``solve_kw`` fall back to :meth:`run`.
        """
        scen = list(scenarios)
        if not scen:
            return []
        extra = {k: v for k, v in self.solve_kw.items()
                 if k not in ("interval_update_mu", "update_h",
                              "fact_incr", "th_change", "max_mu",
                              "recipe")}
        if extra or self.solve_kw.get("recipe", "plain") != "plain" \
                or self.solver.sharding is not None:
            # sharded solvers take the host loop: solve() owns the
            # device placement there; the compiled drain builds its
            # state unsharded and would silently run single-device
            return self.run(scen)

        solver = self.solver
        plan = solver.plan
        keys = tuple(sorted(scen[0].keys()))
        for sid, ov in enumerate(scen):
            if tuple(sorted(ov.keys())) != keys:
                raise ValueError(
                    f"scenario {sid} keys {sorted(ov.keys())} != {keys}")
        solver._validate_overrides(
            {k: np.stack([np.asarray(ov[k]) for ov in scen[:1]])
             for k in keys})
        S = len(scen)
        B = self.B
        dtype = solver.dtype
        # same state-dtype discipline as solve() (batch.py _cast_like):
        # f64 scenario values must not promote an f32 loop
        ov_all = {k: _cast_like(dtype, np.stack(
                      [np.asarray(ov[k]) for ov in scen]))
                  for k in keys}

        cfg = ADMMConfig(
            niter=int(self.chunk_iters),
            interval_update_mu=int(
                self.solve_kw.get("interval_update_mu", 100)),
            update_h=bool(self.solve_kw.get("update_h", True)),
            max_mu=float(self.solve_kw.get("max_mu", 1e3)),
            fact_incr=float(self.solve_kw.get("fact_incr", 2.0)),
            th_change=float(self.solve_kw.get("th_change", 10.0)))
        niter_max = int(self.niter_max)
        mu0 = float(self.mu0)

        # mu0 is baked into the drain closure (initial + refill state),
        # so it MUST key the cache: two schedulers sharing one solver
        # would otherwise silently reuse each other's penalty init.
        ckey = ("stream", cfg, keys, S, B, niter_max, mu0)
        jitted = solver._compiled_cache.get(ckey)
        if jitted is None:
            run = solver._build(cfg, keys, False, False, 1)

            def drain(ov_vals_all, tols):
                ov_of = lambda sidc: tuple(
                    jnp.take(v, sidc, axis=0) for v in ov_vals_all)
                zx = tuple(jnp.zeros((B, n), dtype=dtype)
                           for n in plan.block_sizes)
                zh = tuple(jnp.zeros((B, s), dtype=dtype)
                           for s in plan.pair_sizes)
                zmu = jnp.full((B, plan.npairs), mu0, dtype=dtype)
                # initial fill: scenarios 0..B-1 (beyond-S lanes parked)
                sid0 = jnp.arange(B, dtype=jnp.int32)
                sid0 = jnp.where(sid0 < S, sid0, -1)
                # (S+1)-row outputs: row S is the write-off slot for
                # non-harvesting lanes
                outx = tuple(jnp.zeros((S + 1, n), dtype=dtype)
                             for n in plan.block_sizes)
                outmu = jnp.zeros((S + 1, plan.npairs), dtype=dtype)
                outit = jnp.zeros(S + 1, dtype=jnp.int32)
                outcv = jnp.zeros(S + 1, dtype=bool)
                state = (sid0, jnp.asarray(min(B, S), jnp.int32),
                         jnp.zeros(B, jnp.int32),
                         jnp.asarray(0, jnp.int32),
                         zx, zh, zmu, outx, outmu, outit, outcv)

                def cond(state):
                    return state[3] < S

                def body(state):
                    (sid, nxt, iters, harv, x, h, mu,
                     outx, outmu, outit, outcv) = state
                    parked = sid < 0
                    sidc = jnp.maximum(sid, 0)
                    ov_lane = ov_of(sidc)
                    xg, hg, mug, done, count, _pb, _db = run(
                        ov_lane, x, h, mu, tols, parked)
                    iters2 = iters + count
                    fin = jnp.logical_not(parked) & (
                        done | (iters2 >= niter_max))
                    slot = jnp.where(fin, sidc, S)
                    outx = tuple(o.at[slot].set(a)
                                 for o, a in zip(outx, xg))
                    outmu = outmu.at[slot].set(mug)
                    outit = outit.at[slot].set(iters2)
                    outcv = outcv.at[slot].set(done)
                    # refill finished lanes with the next scenarios, in
                    # lane order; park when the stream is drained
                    order = jnp.cumsum(fin.astype(jnp.int32))
                    cand = nxt + order - 1
                    refill = fin & (cand < S)
                    sid_new = jnp.where(refill, cand,
                                        jnp.where(fin, -1, sid))
                    keep = jnp.logical_not(fin) & jnp.logical_not(parked)
                    kb = keep[:, None]
                    x = tuple(jnp.where(kb, a, 0.0) for a in xg)
                    h = tuple(jnp.where(kb, a, 0.0) for a in hg)
                    mu = jnp.where(kb, mug, mu0)
                    iters3 = jnp.where(keep, iters2, 0)
                    nfin = jnp.sum(fin.astype(jnp.int32),
                                   dtype=jnp.int32)
                    return (sid_new, nxt + nfin, iters3, harv + nfin,
                            x, h, mu, outx, outmu, outit, outcv)

                state = jax.lax.while_loop(cond, body, state)
                (_sid, _nxt, _it, _harv, _x, _h, _mu,
                 outx, outmu, outit, outcv) = state
                trim = lambda a: a[:S]
                return (tuple(trim(a) for a in outx), trim(outmu),
                        trim(outit), trim(outcv))

            jitted = jax.jit(drain)
            if len(solver._compiled_cache) >= 32:
                solver._compiled_cache.pop(
                    next(iter(solver._compiled_cache)))
            solver._compiled_cache[ckey] = jitted

        ov_vals_all = tuple(ov_all[k] for k in keys)
        outx, outmu, outit, outcv = jitted(ov_vals_all,
                                           (self.rtol, self.atol))
        xs = [np.asarray(a) for a in outx]
        its = np.asarray(outit)
        cvs = np.asarray(outcv)
        mus = np.asarray(outmu)
        return [ScenarioResult(
            scenario_id=sid,
            x=tuple(a[sid].copy() for a in xs),
            iterations=int(its[sid]),
            converged=bool(cvs[sid]),
            final_mu=mus[sid].copy()) for sid in range(S)]
