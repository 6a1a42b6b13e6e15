"""Pure-Python reader for R serialization format (RDS), XDR flavor.

Counterpart of ``dpcorr/io/rds_py.py``, with the same output contract.
The reference's real-data pipeline starts at
``readRDS("hrs_long_panel.rds")`` (real-data-sims.R:13); this module is
the port's ``readRDS``.

Scope: the R serialization grammar as ``saveRDS`` version 2/3 emits it in
XDR ("X\\n") encoding: atomic vectors (LGL/INT/REAL/CPLX/STR/RAW),
pairlists with attributes and tags, generic vectors (lists), symbols with
the reference table, CHARSXP encodings, long vectors, and the ALTREP
wrappers R ≥ 3.5 emits for compact sequences and wrapped or deferred
vectors. Environments, closures, promises, bytecode and S4 are out of
scope (``saveRDS`` of plain data never produces them) and raise.

A character vector's elements are variable-length records, one after
another. :meth:`_Reader._charsxp_run` finds a long vector's records with
numpy (every plausible header in a window of the stream, then a check
that each record's end is the next header) and decodes them in one
pass; a vector it cannot prove that way is read record by record.

Output: :class:`RObj` trees of numpy arrays and string lists with
attribute dicts; :func:`read_rds` returns the root, :func:`read_rds_table`
flattens a data.frame or tibble into ``{name: RColumn}`` (what
``dpcorr_torch.hrs`` consumes, and what the grid's ``detail_all.rds``
reads back as).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Any

import numpy as np

# SEXP type codes (R internals)
NILSXP, SYMSXP, LISTSXP = 0, 1, 2
CHARSXP, LGLSXP, INTSXP, REALSXP, CPLXSXP, STRSXP = 9, 10, 13, 14, 15, 16
VECSXP, EXPRSXP, RAWSXP = 19, 20, 24
LANGSXP = 6
# serialization-only pseudo-types
REFSXP, NILVALUE_SXP, GLOBALENV_SXP = 255, 254, 253
NAMESPACESXP, PACKAGESXP, PERSISTSXP = 249, 248, 247
EMPTYENV_SXP, BASEENV_SXP = 242, 241
ATTRLANGSXP, ATTRLISTSXP = 240, 239
ALTREP_SXP = 238

#: R's integer/logical NA payload
R_NA_INT = -0x80000000
#: R's real NA: an NaN with payload 1954 in the low word
R_NA_REAL_BITS = 0x7FF00000000007A2

#: character vectors shorter than this are read record by record
_VECTOR_SCAN_MIN = 64


@dataclasses.dataclass
class RObj:
    """One R object: ``data`` is a numpy array (atomic), list (STRSXP or
    VECSXP elements), str (symbol name), or None."""

    type: int
    data: Any = None
    attributes: dict | None = None

    def attr(self, name: str, default=None):
        return (self.attributes or {}).get(name, default)

    @property
    def names(self):
        nm = self.attr("names")
        return None if nm is None else nm.data

    @property
    def rclass(self):
        cl = self.attr("class")
        return [] if cl is None else list(cl.data)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.u8 = np.frombuffer(buf, dtype=np.uint8)
        self.pos = 0
        self.refs: list[Any] = []
        self.encoding = "utf-8"

    # ---- primitive reads (XDR = big-endian) ----
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

    # ---- header ----
    def header(self) -> None:
        magic = self._take(2)
        if magic != b"X\n":
            raise ValueError(
                f"unsupported RDS encoding {magic!r} (only XDR 'X\\n')")
        version = self.i32()
        self.i32()  # writer R version
        self.i32()  # minimal reader R version
        if version >= 3:
            enc_len = self.i32()
            self.encoding = self._take(enc_len).decode("ascii")
        elif version != 2:
            raise ValueError(f"unsupported RDS version {version}")

    # ---- items ----
    def item(self) -> RObj:
        flags = self.i32()
        ptype = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if ptype == NILVALUE_SXP or ptype == NILSXP:
            return RObj(NILSXP)
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]  # 1-based
        if ptype == SYMSXP:
            char = self.item()
            sym = RObj(SYMSXP, data=char.data)
            self.refs.append(sym)
            return sym
        if ptype in (GLOBALENV_SXP, EMPTYENV_SXP, BASEENV_SXP):
            return RObj(NILSXP)
        if ptype in (NAMESPACESXP, PACKAGESXP, PERSISTSXP):
            # InStringVec format: a compatibility 0, then length, then names
            self.i32()
            obj = RObj(ptype, data=self._strsxp(self.i32()))
            self.refs.append(obj)
            return obj
        if ptype in (LISTSXP, LANGSXP, ATTRLISTSXP, ATTRLANGSXP):
            return self._pairlist(ptype, has_attr, has_tag)
        if ptype == ALTREP_SXP:
            return self._altrep()
        if ptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return RObj(CHARSXP, data=None)  # NA_character_
            return RObj(CHARSXP, data=self._take(n).decode(self.encoding,
                                                           "replace"))
        data: Any
        if ptype in (LGLSXP, INTSXP):
            n = self.length()
            data = np.frombuffer(self._take(4 * n),
                                 dtype=">i4").astype(np.int32)
        elif ptype == REALSXP:
            n = self.length()
            data = np.frombuffer(self._take(8 * n),
                                 dtype=">f8").astype(np.float64)
        elif ptype == CPLXSXP:
            n = self.length()
            data = np.frombuffer(self._take(16 * n),
                                 dtype=">c16").astype(np.complex128)
        elif ptype == RAWSXP:
            n = self.length()
            data = np.frombuffer(self._take(n), dtype=np.uint8).copy()
        elif ptype == STRSXP:
            data = self._strsxp(self.length())
        elif ptype in (VECSXP, EXPRSXP):
            n = self.length()
            data = [self.item() for _ in range(n)]
        else:
            raise ValueError(f"unsupported SEXP type {ptype} in RDS stream "
                             f"(byte {self.pos})")
        obj = RObj(ptype, data=data)
        if has_attr:
            obj.attributes = self._attrs()
        return obj

    def _strsxp(self, n: int) -> list:
        run = self._charsxp_run(n) if n >= _VECTOR_SCAN_MIN else None
        if run is not None:
            return run
        return [self.item().data for _ in range(n)]

    def _charsxp_run(self, n: int) -> list | None:
        """The next ``n`` items as strings, if they are n CHARSXP records
        this scan can prove: every position in a window whose 8 bytes read
        as a CHARSXP header (type 9, no object/attribute/tag bit, length
        −1 or one that ends inside the stream) is a candidate, and the run
        is proved when the first candidate is here and each of the first
        n − 1 records ends where the next candidate starts. A candidate
        inside a record's bytes, or an item of another type, breaks the
        proof: None, and the caller reads record by record. The window
        grows while the proved prefix runs off its end."""
        start, u8 = self.pos, self.u8
        window = 16 * n
        while True:
            seg = u8[start: start + window]
            m = len(seg) - 7
            if m <= 0:
                return None
            at = np.flatnonzero((seg[3:m + 3] == CHARSXP) & (seg[:m] == 0)
                                & ((seg[2:m + 2] & 0x0F) == 0))
            words = seg[at[:, None] + np.arange(4, 8)].astype(np.int64)
            ln = (words[:, 0] << 24 | words[:, 1] << 16 | words[:, 2] << 8
                  | words[:, 3])
            ln = np.where(ln >= 2**31, ln - 2**32, ln)
            keep = (ln >= -1) & (start + at + 8 + ln <= len(u8))
            at, ln = at[keep], ln[keep]
            if not len(at) or at[0] != 0:
                return None
            ends = at + 8 + np.maximum(ln, 0)
            bad = np.flatnonzero(ends[:-1] != at[1:])
            proved = int(bad[0]) + 1 if len(bad) else len(at)
            if proved >= n and ends[n - 1] <= len(seg):
                break
            if ends[proved - 1] + 8 <= len(seg) or start + window >= len(u8):
                return None  # the next item is not a provable record
            window *= 4
        at, ln = at[:n], ln[:n]
        self.pos = start + int(ends[n - 1])
        return decode_strings(self.u8, start + at + 8, ln, self.encoding)

    def _pairlist(self, ptype: int, has_attr: bool, has_tag: bool) -> RObj:
        """Pairlist read as a Python list of (tag, value); attributes on the
        whole list are rare for data and folded into the first node."""
        items = []
        attrs = self._attrs() if has_attr else None
        while True:
            tag = None
            if has_tag:
                tag_obj = self.item()
                tag = tag_obj.data
            items.append((tag, self.item()))
            flags = self.i32()
            nxt = flags & 0xFF
            if nxt in (NILVALUE_SXP, NILSXP):
                break
            if nxt not in (LISTSXP, LANGSXP, ATTRLISTSXP, ATTRLANGSXP):
                # cdr is a non-pairlist object: re-dispatch it
                self.pos -= 4
                items.append((None, self.item()))
                break
            if flags & 0x200:
                self._attrs()  # attributes on an interior cons cell: drop
            has_tag = bool(flags & 0x400)
        obj = RObj(LISTSXP, data=items)
        obj.attributes = attrs
        return obj

    def _attrs(self) -> dict:
        plist = self.item()
        if plist.type == NILSXP:
            return {}
        return {tag: val for tag, val in plist.data if tag is not None}

    # ---- ALTREP reconstruction ----
    def _altrep(self) -> RObj:
        info = self.item()   # pairlist: (class-sym, package-sym, type int)
        state = self.item()
        attr = self.item()
        cls = info.data[0][1].data if info.type == LISTSXP else None
        obj = self._expand_altrep(cls, state)
        if attr.type == LISTSXP:
            obj.attributes = {t: v for t, v in attr.data if t is not None}
        return obj

    def _expand_altrep(self, cls: str | None, state: RObj) -> RObj:
        if cls == "compact_intseq":
            n, start, step = (float(v) for v in state.data[:3])
            return RObj(INTSXP, data=np.arange(
                start, start + step * n, step, dtype=np.int32)[: int(n)])
        if cls == "compact_realseq":
            n, start, step = (float(v) for v in state.data[:3])
            return RObj(REALSXP, data=np.arange(
                start, start + step * n, step, dtype=np.float64)[: int(n)])
        if cls in ("wrap_logical", "wrap_integer", "wrap_real", "wrap_string",
                   "wrap_complex", "wrap_raw"):
            return _altrep_payload(state)
        if cls == "deferred_string":
            src = _altrep_payload(state)
            vals = ["" if v is None else _r_num_str(v) for v in
                    np.asarray(src.data).tolist()]
            return RObj(STRSXP, data=vals)
        raise ValueError(f"unsupported ALTREP class {cls!r}")


def decode_strings(u8: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                   encoding: str = "utf-8") -> list:
    """Strings at byte offsets ``offs`` of ``u8`` with lengths ``lens``
    (−1 for NA_character_): their bytes gathered into one blob of
    NUL-terminated records (R strings hold no NUL) for
    :func:`split_strings`, which also splits the native reader's blobs
    (``dpcorr_torch.io.rds``)."""
    if not len(lens):
        return []
    k = np.maximum(lens, 0)
    total = int(k.sum())
    first = np.cumsum(k) - k            # each string's first byte
    owner = np.repeat(np.arange(len(k)), k)
    within = np.arange(total) - first[owner]
    blob = np.zeros(total + len(k), np.uint8)
    blob[first[owner] + owner + within] = u8[offs[owner] + within]
    return split_strings(blob.tobytes(), lens < 0, encoding)


def split_strings(blob: bytes, na: np.ndarray,
                  encoding: str = "utf-8") -> list:
    """A blob of NUL-terminated records, one per element (empty for NA),
    as the column's strings: one decode, one split, None where ``na``."""
    vals = blob[:-1].decode(encoding, "replace").split("\x00")
    for i in np.flatnonzero(na).tolist():
        vals[i] = None
    return vals


def _altrep_payload(state: RObj) -> RObj:
    """First element of an ALTREP wrapper's state.

    R serializes wrapper state as CONS(wrapped, metadata), a LISTSXP whose
    pairs are untagged, though a VECSXP form also exists; atomic state is
    already the payload.
    """
    if state.type == LISTSXP:
        return state.data[0][1]
    if state.type == VECSXP:
        return state.data[0]
    return state


def _r_num_str(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def real_is_na(arr: np.ndarray) -> np.ndarray:
    """Mask of R ``NA_real_`` (distinct from NaN) in a float64 array."""
    return arr.view(np.uint64) == R_NA_REAL_BITS


def decode_real(arr: np.ndarray) -> np.ndarray:
    """R doubles → numpy float64 with NA as NaN. NA already is an NaN, so
    this is the identity; it names the NA story."""
    return arr


def decode_int(arr: np.ndarray) -> np.ndarray:
    """R integers → float64 with NA (INT_MIN) mapped to NaN."""
    out = arr.astype(np.float64)
    out[arr == R_NA_INT] = np.nan
    return out


def decompressed(path: str) -> bytes:
    """The serialized stream of a .rds file, gzip-, bzip2- or
    xz-compressed (all three are ``saveRDS`` compress modes) or plain."""
    with open(path, "rb") as f:
        head = f.read(6)
    if head.startswith(b"\x1f\x8b"):
        opener = gzip.open
    elif head.startswith(b"BZh"):
        import bz2
        opener = bz2.open
    elif head.startswith(b"\xfd7zXZ\x00"):
        import lzma
        opener = lzma.open
    else:
        opener = open
    with opener(path, "rb") as f:
        return f.read()


def read_rds(path: str) -> RObj:
    """Read a .rds file into an :class:`RObj`."""
    rd = _Reader(decompressed(path))
    rd.header()
    return rd.item()


@dataclasses.dataclass
class RColumn:
    """One data.frame column, decoded.

    ``kind``: "double" | "integer" | "logical" | "string" | "factor".
    ``values``: float64 array (NA→NaN) for numerics, list[str|None]
    otherwise; factors keep integer codes (NA→NaN) + ``levels``.
    ``labels``: haven value-labels mapping, if present; ``label``: the
    haven variable label.
    """

    name: str
    kind: str
    values: Any
    levels: list | None = None
    labels: dict | None = None
    label: str | None = None


def _decode_column(name: str, col: RObj) -> RColumn:
    cls = col.rclass
    lab = col.attr("label")
    label = lab.data[0] if lab is not None and lab.data else None
    labels_attr = col.attr("labels")
    labels = None
    if labels_attr is not None:
        lv = np.asarray(labels_attr.data, dtype=np.float64)
        labels = dict(zip(labels_attr.names or [], lv.tolist()))
    if "factor" in cls:
        levels = col.attr("levels")
        return RColumn(name, "factor", decode_int(col.data),
                       levels=list(levels.data) if levels else [],
                       label=label)
    if col.type == REALSXP:
        return RColumn(name, "double", decode_real(col.data),
                       labels=labels, label=label)
    if col.type == INTSXP:
        return RColumn(name, "integer", decode_int(col.data),
                       labels=labels, label=label)
    if col.type == LGLSXP:
        return RColumn(name, "logical", decode_int(col.data), label=label)
    if col.type == STRSXP:
        return RColumn(name, "string", col.data, label=label)
    raise ValueError(f"column {name!r}: unsupported type {col.type}")


def read_rds_table(path: str) -> dict[str, RColumn]:
    """Read a data.frame/tibble .rds into ``{name: RColumn}`` (ordered)."""
    root = read_rds(path)
    if root.type != VECSXP or "data.frame" not in root.rclass:
        raise ValueError(f"{path}: not a data.frame (class {root.rclass})")
    names = root.names or []
    return {nm: _decode_column(nm, col)
            for nm, col in zip(names, root.data, strict=True)}

