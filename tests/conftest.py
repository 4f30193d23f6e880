"""Test environment: CPU backend with 8 virtual devices, x64 enabled.

The reference's oracle tests are float64/complex128 (SURVEY.md §4); the
suite runs on the XLA host platform with device emulation so sharding
tests exercise a real 8-device mesh without accelerator hardware.  Tests
marked ``gpu`` take the :func:`gpu` fixture and skip unless JAX sees an
NVIDIA GPU (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``).
"""
import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

#: Source tree of the reference implementation (SpM-lab/admmsolver) for
#: the live parity tests; they skip when it is not given or not there.
REFERENCE_SRC = os.environ.get("ADMMSOLVER_REFERENCE_SRC", "")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none.

    Decided here, at test time, never at import: every xdist worker
    must collect the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return devs[0]


@pytest.fixture(scope="module")
def ref():
    """The reference implementation's modules, or a skip."""
    if not REFERENCE_SRC:
        pytest.skip("reference implementation not available "
                    "(set ADMMSOLVER_REFERENCE_SRC)")
    sys.path.insert(0, REFERENCE_SRC)
    try:
        import admmsolver.matrix as ref_mat
        import admmsolver.objectivefunc as ref_obj
        import admmsolver.optimizer as ref_opt
    except ImportError:
        pytest.skip("reference implementation not available")
    finally:
        sys.path.remove(REFERENCE_SRC)
    import types

    return types.SimpleNamespace(opt=ref_opt, obj=ref_obj, mat=ref_mat)
