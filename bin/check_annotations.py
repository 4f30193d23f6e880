#!/usr/bin/env python
"""Static annotation gate that runs in ANY environment.

mypy is the reference's first-class typing check and runs in CI, but
an environment without network may have no mypy.  This script is the
always-on local floor under it: it imports every module in
``admmsolver_tpu`` and forces every annotation in the package to
RESOLVE via ``typing.get_type_hints`` — under ``from __future__ import
annotations`` every hint is a lazily-evaluated string, so a typo'd or
un-imported name in a signature is invisible until something evaluates
it.  This evaluates all of them.  Exit 1 on any unresolvable
annotation; prints one summary line on success.
"""
import importlib
import inspect
import os
import pkgutil
import sys
import typing

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def iter_modules(pkg_name: str):
    pkg = importlib.import_module(pkg_name)
    yield pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg_name + "."):
        yield importlib.import_module(info.name)


def check(obj, where: str, errors: list) -> int:
    try:
        typing.get_type_hints(obj)
        return 1
    except Exception as e:  # noqa: BLE001 - any failure is the finding
        errors.append(f"{where}: {type(e).__name__}: {e}")
        return 1


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    errors: list = []
    n = 0
    for mod in iter_modules("admmsolver_tpu"):
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__:
                continue
            n += check(fn, f"{mod.__name__}.{name}", errors)
        for cname, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ != mod.__name__:
                continue
            n += check(cls, f"{mod.__name__}.{cname}", errors)
            for mname, meth in inspect.getmembers(cls, inspect.isfunction):
                if meth.__module__ != mod.__name__:
                    continue
                n += check(meth, f"{mod.__name__}.{cname}.{mname}",
                           errors)
    if errors:
        print(f"ANNOTATION GATE: {len(errors)} unresolvable "
              "annotation(s):", file=sys.stderr)
        for e in errors:
            print("  " + e, file=sys.stderr)
        return 1
    print(f"annotation gate: {n} objects resolved cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
