"""Builds the port's native sources and loads them with ctypes.

Every ``dpcorr_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``,
and every ``dpcorr_torch/csrc/*.cpp`` (host code: the RDS reader) by the
host compiler, into its own shared library with a plain C interface, at
first use, into ``dpcorr_torch/_build/`` (listed in ``.gitignore``). The
library's name carries a digest of its source and flags, so an edited
source is rebuilt and a stale one is never loaded. Sources build in
parallel: one compiler per source, all started together. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: wall seconds of each build this process ran, by source name
BUILD_SECONDS: dict[str, float] = {}


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


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` from PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX): the native RDS "
                       "reader is built from source")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` if it exists, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` or ``.cpp`` is built."""
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) for the library at :func:`library_path`, under the same
    digest, so it always describes that build."""
    return library_path(name).with_suffix(".log")


def build_all(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cpp``) whose library is missing; returns ``{name: library
    path}``. Each build's report is kept at :func:`log_path`, its wall
    seconds in :data:`BUILD_SECONDS`."""
    if names is None:
        names = sorted(p.stem for p in (*CSRC.glob("*.cu"),
                                        *CSRC.glob("*.cpp")))
    targets = {name: library_path(name) for name in names}
    pending = {n: t for n, t in targets.items() if not t.exists()}
    if pending:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, target in pending.items():
            src = source_path(name)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            compiler = nvcc_path() if src.suffix == ".cu" else cxx_path()
            cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
            procs[name] = (src, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))

        def finish(item):  # each build's own wall time, waited on apart
            name, (_, _, t0, proc) = item
            log, _ = proc.communicate()
            return name, log, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, procs.items()))
        failed = []
        for name, log, seconds in done:
            src, tmp, _, proc = procs[name]
            BUILD_SECONDS[name] = seconds
            pending[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({os.path.basename(proc.args[0])}"
                              f" exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, pending[name])
        if failed:
            raise RuntimeError("native build failed: " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
        return _LIBS[name]
