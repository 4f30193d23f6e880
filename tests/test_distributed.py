"""Multi-process (multi-host analogue) execution of the distributed
entry point.

The reference has nothing to distribute (SURVEY.md §2.2); §5 mandates a
``jax.distributed`` backend.  This test actually
EXECUTES it: two separate OS processes, each with 2 virtual CPU
devices, form one 4-device cluster via ``init_distributed`` (gloo
collectives, localhost coordinator).  Both run the ordinary
``BatchedSolver`` path over the global mesh — the convergence
``jnp.all(done)`` reduction crosses the process boundary — and the
gathered solution must be BITWISE identical to a single-process run on
the same 4-device mesh shape (the determinism suite's cross-sharding
idiom, extended across process boundaries).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_expected(path: str) -> None:
    """Single-process oracle on a 4-device mesh (same global shape as
    the 2x2 distributed run)."""
    import jax
    import jax.numpy as jnp

    from admmsolver_tpu import (L1Regularizer, LeastSquares, Model,
                                identity)
    from admmsolver_tpu.parallel import (BatchedSolver, batch_sharding,
                                         make_mesh)

    rng = np.random.RandomState(1234)
    M, N, B = 24, 48, 8
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 5, replace=False)] = rng.randn(5)
    ys = xt @ A.T
    mesh = make_mesh(4)
    bs = BatchedSolver(
        Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N)],
              [(1, 0, identity(N), identity(N))]),
        dtype=jnp.float64, sharding=batch_sharding(mesh))
    res = bs.solve({(0, "y"): jnp.asarray(ys)}, niter=120, mu0=1.0,
                   record_residuals=False)
    np.savez(path, x0=np.asarray(res.x[0]), x1=np.asarray(res.x[1]),
             iterations=np.asarray(res.iterations))


def test_two_process_solve_bitwise_matches_single_process(tmp_path):
    # bounded by the subprocess communicate() timeout below (no
    # pytest-timeout in this image)
    nproc = 2
    expected = str(tmp_path / "expected.npz")
    _single_process_expected(expected)

    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(nproc), coord, expected],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n"
                    + "\n".join(o or "" for o in outs))
    codes = [p.returncode for p in procs]
    log = "\n---\n".join(outs)
    if all(c == 42 for c in codes):
        pytest.skip("environment cannot run jax.distributed: " + log)
    assert codes == [0] * nproc, f"exit codes {codes}\n{log}"
    assert all("bitwise identity" in o for o in outs), log
