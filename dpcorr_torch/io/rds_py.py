"""R serialization format (RDS), XDR flavor: the codes the writer needs and
a reader for what it writes.

Counterpart of the part of ``dpcorr/io/rds_py.py`` that the grid needs:
the SEXP type codes and the NA payload that :mod:`dpcorr_torch.io.rds_write`
emits, and a reader for version-2/3 XDR streams of one ``data.frame`` with
double, integer, logical and string columns, which reads back a
``detail_all.rds`` that the grid wrote. The JAX package's reader covers
more of the grammar (ALTREP, reference tables, factors, haven labels)
for the HRS panel; the port does not read the panel yet.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

# SEXP type codes (R internals)
NILSXP, SYMSXP, LISTSXP = 0, 1, 2
CHARSXP, LGLSXP, INTSXP, REALSXP, STRSXP = 9, 10, 13, 14, 16
VECSXP = 19
# serialization-only pseudo-type
NILVALUE_SXP = 254

#: R's integer/logical NA payload
R_NA_INT = -0x80000000


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.encoding = "utf-8"

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos: self.pos + n]
        if len(b) != n:
            raise EOFError(f"truncated RDS stream at byte {self.pos}")
        self.pos += n
        return b

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector: two more ints, 2^32*hi + lo
            hi, lo = self.i32(), self.i32()
            n = (hi << 32) + (lo & 0xFFFFFFFF)
        return n

    def header(self) -> None:
        if self._take(2) != b"X\n":
            raise ValueError("unsupported RDS encoding (only XDR 'X\\n')")
        version = self.i32()
        self.i32()  # writer R version
        self.i32()  # minimal reader R version
        if version >= 3:
            self.encoding = self._take(self.i32()).decode("ascii")
        elif version != 2:
            raise ValueError(f"unsupported RDS version {version}")

    def item(self):
        """One item as ``(type, data, attributes)``: ``data`` is a numpy
        array (atomic), a list (strings, list elements, or the (tag,
        value) pairs of a pairlist), a str (symbol, CHARSXP) or None."""
        flags = self.i32()
        ptype = flags & 0xFF
        has_attr = bool(flags & 0x200)
        if ptype in (NILVALUE_SXP, NILSXP):
            return NILSXP, None, {}
        if ptype == SYMSXP:
            return SYMSXP, self.item()[1], {}
        if ptype == LISTSXP:
            return self._pairlist(has_attr, bool(flags & 0x400))
        if ptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return CHARSXP, None, {}  # NA_character_
            return CHARSXP, self._take(n).decode(self.encoding,
                                                 "replace"), {}
        if ptype in (LGLSXP, INTSXP):
            n = self.length()
            data = np.frombuffer(self._take(4 * n), ">i4").astype(np.int32)
        elif ptype == REALSXP:
            n = self.length()
            data = np.frombuffer(self._take(8 * n), ">f8").astype(np.float64)
        elif ptype == STRSXP:
            data = [self.item()[1] for _ in range(self.length())]
        elif ptype == VECSXP:
            data = [self.item() for _ in range(self.length())]
        else:
            raise ValueError(f"unsupported SEXP type {ptype} in RDS stream "
                             f"(byte {self.pos})")
        return ptype, data, self._attrs() if has_attr else {}

    def _pairlist(self, has_attr: bool, has_tag: bool):
        attrs = self._attrs() if has_attr else {}
        items = []
        while True:
            tag = self.item()[1] if has_tag else None
            items.append((tag, self.item()))
            flags = self.i32()
            if flags & 0xFF in (NILVALUE_SXP, NILSXP):
                break
            if flags & 0xFF != LISTSXP:
                raise ValueError(f"unsupported pairlist tail type "
                                 f"{flags & 0xFF} (byte {self.pos})")
            has_tag = bool(flags & 0x400)
        return LISTSXP, items, attrs

    def _attrs(self) -> dict:
        ptype, items, _ = self.item()
        if ptype == NILSXP:
            return {}
        return {tag: val for tag, val in items if tag is not None}


def read_rds(path: str):
    """Read a .rds file (gzip-compressed or plain) into ``(type, data,
    attributes)`` as :meth:`_Reader.item` returns it."""
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    with (gzip.open if gz else open)(path, "rb") as f:
        rd = _Reader(f.read())
    rd.header()
    return rd.item()


def read_rds_table(path: str) -> dict:
    """Read a data.frame .rds into ``{name: values}`` in column order:
    doubles as float64 arrays, integers as int32 arrays and logicals as
    bool arrays (their NAs stay ``R_NA_INT`` and True), strings as
    lists."""
    ptype, cols, attrs = read_rds(path)
    cls = attrs.get("class")
    if ptype != VECSXP or cls is None or "data.frame" not in cls[1]:
        raise ValueError(f"{path}: not a data.frame")
    out = {}
    for name, (ctype, data, _) in zip(attrs["names"][1], cols, strict=True):
        out[name] = data != 0 if ctype == LGLSXP else data
    return out
