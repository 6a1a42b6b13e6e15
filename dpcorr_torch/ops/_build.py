"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``dpcorr_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, at first use, into
``dpcorr_torch/_build/`` (listed in ``.gitignore``). The library's name
carries a digest of its source and flags, so an edited source is rebuilt
and a stale one is never loaded. Sources build in parallel: one ``nvcc``
per source, all started together. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) for the library at :func:`library_path`, under the same
    digest, so it always describes that build."""
    return library_path(name).with_suffix(".log")


def build_all(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) whose
    library is missing; returns ``{name: library path}``. Each build's
    report is kept at :func:`log_path`."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {name: library_path(name) for name in names}
    pending = {n: t for n, t in targets.items() if not t.exists()}
    if pending:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, target in pending.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            pending[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{log}")
            else:
                os.replace(tmp, pending[name])
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
        return _LIBS[name]
