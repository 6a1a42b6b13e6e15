"""RDS ingest front-end: ``read_rds_table(path)``, the port's ``readRDS``
(reference real-data-sims.R:13).

Counterpart of ``dpcorr/io/rds.py``. It prefers the native reader
(``dpcorr_torch/csrc/rdsread.cpp``, host C++, built at first use by
``dpcorr_torch.ops._build`` and bound with ctypes) and falls back to the
pure-Python parser (:mod:`dpcorr_torch.io.rds_py`) when the reader cannot
be built or loaded, when it refuses a file, or when ``DPCORR_NO_NATIVE=1``
asks for Python; every fallback but the last is logged as a warning. Both
give the same ``{name: RColumn}`` dicts. Python decompresses the file
(gzip, bzip2, xz or plain) and the native reader parses the stream; its
string blobs are split by the Python reader's decoder
(``rds_py.split_strings``).
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from dpcorr_torch.io import rds_py
from dpcorr_torch.io.rds_py import RColumn

log = logging.getLogger("dpcorr_torch.io.rds")

_lib: ctypes.CDLL | None = None
_lib_error: Exception | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.rds_read_buffer.restype = p
    lib.rds_read_buffer.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.rds_table_ncols.argtypes = [p]
    lib.rds_table_nrows.restype = i64
    lib.rds_table_nrows.argtypes = [p]
    lib.rds_col_name.restype = ctypes.c_char_p
    lib.rds_col_name.argtypes = [p, ctypes.c_int]
    lib.rds_col_kind.restype = ctypes.c_char_p
    lib.rds_col_kind.argtypes = [p, ctypes.c_int]
    lib.rds_col_num.restype = ctypes.POINTER(ctypes.c_double)
    lib.rds_col_num.argtypes = [p, ctypes.c_int]
    lib.rds_col_num_len.restype = i64
    lib.rds_col_num_len.argtypes = [p, ctypes.c_int]
    lib.rds_col_str_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.rds_col_str_blob.argtypes = [p, ctypes.c_int, ctypes.POINTER(i64)]
    lib.rds_col_str_offsets.restype = ctypes.POINTER(i64)
    lib.rds_col_str_offsets.argtypes = [p, ctypes.c_int, ctypes.POINTER(i64)]
    lib.rds_col_nlevels.argtypes = [p, ctypes.c_int]
    lib.rds_col_level.restype = ctypes.c_char_p
    lib.rds_col_level.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.rds_col_nlabels.argtypes = [p, ctypes.c_int]
    lib.rds_col_label_name.restype = ctypes.c_char_p
    lib.rds_col_label_name.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.rds_col_label_value.restype = ctypes.c_double
    lib.rds_col_label_value.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.rds_col_var_label.restype = ctypes.c_char_p
    lib.rds_col_var_label.argtypes = [p, ctypes.c_int]
    lib.rds_table_free.argtypes = [p]
    return lib


def native_reader() -> ctypes.CDLL:
    """The loaded native reader, built on first use; raises with the
    compiler's output when it cannot be built or loaded."""
    global _lib, _lib_error
    if _lib is None:
        if _lib_error is not None:  # one build attempt per process
            raise _lib_error
        from dpcorr_torch.ops import _build

        try:
            _lib = _bind(_build.load("rdsread"))
        except Exception as e:
            _lib_error = e
            raise
    return _lib


def _strings(lib, handle, j: int) -> list:
    """Column ``j``'s strings: its blob of NUL-terminated records (empty
    for NA) through :func:`rds_py.split_strings`, NA where the offset is
    −1."""
    i64 = ctypes.c_int64
    blob_len, n_off = i64(), i64()
    blob = lib.rds_col_str_blob(handle, j, ctypes.byref(blob_len))
    offs = lib.rds_col_str_offsets(handle, j, ctypes.byref(n_off))
    if not n_off.value:
        return []
    off = np.ctypeslib.as_array(offs, shape=(n_off.value,))
    return rds_py.split_strings(ctypes.string_at(blob, blob_len.value),
                                off < 0)


def _native_columns(lib, handle) -> dict[str, RColumn]:
    out: dict[str, RColumn] = {}
    for j in range(lib.rds_table_ncols(handle)):
        name = lib.rds_col_name(handle, j).decode()
        kind = lib.rds_col_kind(handle, j).decode()
        labels = {lib.rds_col_label_name(handle, j, k).decode():
                  lib.rds_col_label_value(handle, j, k)
                  for k in range(lib.rds_col_nlabels(handle, j))} or None
        raw = lib.rds_col_var_label(handle, j)
        var_label = raw.decode() if raw is not None else None
        if kind == "string":
            out[name] = RColumn(name, kind, _strings(lib, handle, j),
                                label=var_label)
            continue
        n = int(lib.rds_col_num_len(handle, j))
        vals = (np.ctypeslib.as_array(lib.rds_col_num(handle, j),
                                      shape=(n,)).copy()
                if n else np.zeros(0, np.float64))
        levels = ([lib.rds_col_level(handle, j, k).decode()
                   for k in range(lib.rds_col_nlevels(handle, j))]
                  if kind == "factor" else None)
        out[name] = RColumn(name, kind, vals, levels=levels, labels=labels,
                            label=var_label)
    return out


def read_native(path: str | os.PathLike) -> dict[str, RColumn]:
    """Read a data.frame/tibble ``.rds`` with the native reader only;
    raises ``ValueError`` with the reader's message when it refuses the
    file."""
    lib = native_reader()
    buf = rds_py.decompressed(os.fspath(path))
    err = ctypes.create_string_buffer(512)
    handle = lib.rds_read_buffer(buf, len(buf), err, len(err))
    if not handle:
        raise ValueError(f"{os.fspath(path)}: "
                         f"{err.value.decode(errors='replace')}")
    try:
        return _native_columns(lib, handle)
    finally:
        lib.rds_table_free(handle)


def read_rds_table(path: str | os.PathLike) -> dict[str, RColumn]:
    """Read a data.frame/tibble ``.rds`` file into ``{name: RColumn}``."""
    path = os.fspath(path)
    if os.environ.get("DPCORR_NO_NATIVE") != "1":
        try:
            native_reader()
        except Exception as e:  # toolchain or load problems: Python parser
            log.warning("native RDS reader unavailable (%s); using the "
                        "Python parser", e)
        else:
            try:
                return read_native(path)
            except ValueError as e:
                log.warning("native RDS reader failed on %s (%s); falling "
                            "back to the Python parser", path, e)
    return rds_py.read_rds_table(path)
