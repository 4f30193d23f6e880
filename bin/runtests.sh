#!/bin/bash
# Test gate (mirror of the reference's bin/runtests.sh: pytest + static
# typing as first-class checks).
set -e
cd "$(dirname "$0")/.."

python -m pytest tests/ -x -q

# Static typing GATE (the reference treats mypy as a first-class
# check).  Two layers:
#  1. bin/check_annotations.py ALWAYS runs (no dependencies): it forces
#     every annotation in the package to resolve, the floor that works
#     in an environment where mypy cannot be installed.
#  2. mypy runs when available (CI always installs it); when absent the
#     skip is LOUD so round journals record it.
python bin/check_annotations.py

if python -c "import mypy" 2>/dev/null; then
    python -m mypy admmsolver_tpu --ignore-missing-imports \
        --no-strict-optional --allow-redefinition
else
    echo "=============================================================="
    echo "WARNING: MYPY GATE SKIPPED - mypy is not installed in this"
    echo "environment (no network, no wheel). CI (.github/workflows/"
    echo "pytest.yml) enforces it; the annotation gate above ran locally."
    echo "=============================================================="
fi
