"""dpcorr_torch.analysis — the port's AST-based invariant linter.

Counterpart of ``dpcorr.analysis``, pointed at this package's own source
and written in its idiom (torch host syncs, the port's key-tree, CUDA
graph capture, the ``nvcc`` build layer). Run it as ``python -m
dpcorr_torch lint``; the programmatic entry point is :func:`run_lint`.
Stdlib-only on purpose: the lint imports no torch and answers in
seconds.
"""

from dpcorr_torch.analysis.core import (  # noqa: F401
    Checker,
    Module,
    Violation,
    apply_baseline,
    default_checkers,
    iter_py_files,
    load_baseline,
    run_lint,
    write_baseline,
)

__all__ = [
    "Checker", "Module", "Violation", "apply_baseline",
    "default_checkers", "iter_py_files", "load_baseline", "run_lint",
    "write_baseline",
]
