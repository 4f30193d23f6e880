"""The compile-cache helper: the environment variable wins, otherwise a
fixed, git-ignored directory inside the checkout."""
import os
import subprocess
import sys
from pathlib import Path

import jax

from admmsolver_tpu.utils import compile_cache as cc

ROOT = Path(__file__).resolve().parents[1]


def test_unset_uses_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv(cc.CACHE_ENV, raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_set_variable_is_used_and_nothing_is_changed(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv(cc.CACHE_ENV, str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old


def test_library_import_sets_no_cache():
    code = ("import jax, admmsolver_tpu, admmsolver_tpu.parallel; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items() if k != cc.CACHE_ENV}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


def test_cache_lands_in_the_variable_directory(tmp_path):
    """A compiled program is written where the variable points."""
    code = ("import jax, jax.numpy as jnp; "
            "from admmsolver_tpu.utils.compile_cache import "
            "enable_compile_cache; p = enable_compile_cache(); "
            "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64)))"
            ".block_until_ready(); print(p)")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    assert any(tmp_path.iterdir())
