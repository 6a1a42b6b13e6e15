"""Writer for R serialization format (RDS), XDR flavor, numpy only.

Counterpart of ``dpcorr/io/rds_write.py``. The reference persists its
replicate tables with ``saveRDS(detail_all, "sim_detail_all.rds")``
(vert-cor.R:569, ver-cor-subG.R:314) and its downstream lives in R:
:func:`write_rds_table` emits a ``data.frame`` .rds that R's ``readRDS``
consumes directly.

Scope: version-3 XDR streams of one data.frame with double / integer /
logical / string columns (what the replicate tables contain). Layout, as
R's serialize.c writes it:

- item flags word: bits 0-7 SEXP type, 0x100 object bit (class set),
  0x200 has-attributes, 0x400 has-tag; CHARSXP encoding rides the
  levels field (``ASCII << 12`` / ``UTF8 << 12``);
- attributes are a tagged pairlist terminated by NILVALUE (254);
  symbols are emitted inline (legal: the reference table is an
  optimization, not a requirement);
- row.names uses R's compact internal form ``c(NA_integer_, -n)``.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, Mapping

import numpy as np

from dpcorr_torch.io.rds_py import (
    CHARSXP,
    INTSXP,
    LGLSXP,
    LISTSXP,
    NILVALUE_SXP,
    R_NA_INT,
    REALSXP,
    STRSXP,
    SYMSXP,
    VECSXP,
)

_HAS_ATTR = 0x200
_HAS_TAG = 0x400
_IS_OBJECT = 0x100
_ASCII_MASK = 64  # CHARSXP gp levels bit
_UTF8_MASK = 8

class _Writer:
    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def raw(self, b: bytes) -> None:
        self.parts.append(b)

    def i32(self, v: int) -> None:
        self.raw(struct.pack(">i", v))

    def flags(self, ptype: int, *, levels: int = 0, is_object: bool = False,
              has_attr: bool = False, has_tag: bool = False) -> None:
        self.i32(ptype | (levels << 12)
                 | (_IS_OBJECT if is_object else 0)
                 | (_HAS_ATTR if has_attr else 0)
                 | (_HAS_TAG if has_tag else 0))

    def header(self) -> None:
        self.raw(b"X\n")
        self.i32(3)         # serialization version 3
        self.i32(0x040301)  # writer "R 4.3.1"
        self.i32(0x030500)  # minimal reader R 3.5.0
        enc = b"UTF-8"
        self.i32(len(enc))
        self.raw(enc)

    def charsxp(self, s: str | None) -> None:
        if s is None:  # NA_character_
            self.flags(CHARSXP, levels=_ASCII_MASK)
            self.i32(-1)
            return
        b = s.encode("utf-8")
        self.flags(CHARSXP,
                   levels=_ASCII_MASK if s.isascii() else _UTF8_MASK)
        self.i32(len(b))
        self.raw(b)

    def strsxp(self, values: list) -> None:
        self.flags(STRSXP)
        self.i32(len(values))
        for v in values:
            self.charsxp(None if v is None else str(v))

    def symbol(self, name: str) -> None:
        self.flags(SYMSXP)
        self.charsxp(name)

    def realsxp(self, arr: np.ndarray) -> None:
        self.flags(REALSXP)
        self.i32(arr.size)
        self.raw(np.ascontiguousarray(arr, dtype=">f8").tobytes())

    def intsxp(self, arr: np.ndarray, ptype: int = INTSXP) -> None:
        self.flags(ptype)
        self.i32(arr.size)
        self.raw(np.ascontiguousarray(arr, dtype=">i4").tobytes())

    def data_frame(self, columns: Mapping[str, Any], n_rows: int) -> None:
        self.flags(VECSXP, is_object=True, has_attr=True)
        self.i32(len(columns))
        for values in columns.values():
            self._column(values)
        # attributes pairlist: names, row.names (compact), class
        self.flags(LISTSXP, has_tag=True)
        self.symbol("names")
        self.strsxp(list(columns.keys()))
        self.flags(LISTSXP, has_tag=True)
        self.symbol("row.names")
        self.intsxp(np.asarray([R_NA_INT, -n_rows], dtype=np.int64))
        self.flags(LISTSXP, has_tag=True)
        self.symbol("class")
        self.strsxp(["data.frame"])
        self.i32(NILVALUE_SXP)  # end of pairlist

    def _column(self, values: Any) -> None:
        arr = values if isinstance(values, np.ndarray) else np.asarray(values)
        if arr.dtype.kind in "OU":
            vals = list(arr)
            if not all(v is None or isinstance(v, str) for v in vals):
                raise TypeError("an object column must hold strings or None")
            self.strsxp(vals)
            return
        if arr.dtype.kind == "b":
            self.intsxp(arr.astype(np.int64), ptype=LGLSXP)
        elif arr.dtype.kind in "iu":
            if arr.size and (arr.max(initial=0) > 2**31 - 1
                             or arr.min(initial=0) <= -(2**31)):
                self.realsxp(arr.astype(np.float64))  # R ints are 32-bit
            else:
                self.intsxp(arr.astype(np.int64))
        elif arr.dtype.kind == "f":
            self.realsxp(arr.astype(np.float64))
        else:
            raise TypeError(f"unsupported column dtype {arr.dtype}")


def write_rds_table(path: str, columns: Mapping[str, Any],
                    compress: bool = True) -> None:
    """Write ``{name: values}`` as a data.frame .rds (``saveRDS``-shaped:
    version-3 XDR, gzip at level 6 by default, R's own saveRDS level;
    level 9 is far slower on a grid's table and saves little).

    Columns: float arrays → REALSXP (NaN kept as IEEE NaN), int arrays →
    INTSXP (values that overflow R's 32-bit ints are promoted to doubles,
    as R itself would store them), bool → LGLSXP, string arrays → STRSXP
    with None as NA_character_. All columns must share one length. (The
    JAX package's writer also takes pandas' nullable object columns; the
    port has no pandas.)"""
    sizes = {len(v) if isinstance(v, (list, tuple)) else np.asarray(v).size
             for v in columns.values()}
    if len(sizes) > 1:
        raise ValueError(f"ragged columns: lengths {sorted(sizes)}")
    n_rows = sizes.pop() if sizes else 0
    w = _Writer()
    w.header()
    w.data_frame(columns, n_rows)
    blob = b"".join(w.parts)
    if compress:
        # mtime=0 → deterministic bytes for identical tables
        blob = gzip.compress(blob, compresslevel=6, mtime=0)
    with open(path, "wb") as f:
        f.write(blob)


def write_rds_frame(path: str, table: Mapping[str, np.ndarray],
                    compress: bool = True) -> None:
    """The grid's ``detail_all`` table (a dict of numpy columns) as a
    data.frame .rds: the reference's ``saveRDS(detail_all, ...)`` call,
    vert-cor.R:569."""
    write_rds_table(path, {str(c): np.asarray(v) for c, v in table.items()},
                    compress=compress)
