"""The port's RDS reader (dpcorr_torch.io) against the JAX package's.

Both readers parse the same bytes: hand-built XDR streams (NA placement,
factor levels, haven labels, the symbol reference table, ALTREP
wrappers, long character vectors that the port decodes with numpy, and
a record its numpy scan cannot prove, which it reads record by record),
each of the three compressions and a plain file, and the synthetic HRS
panel as the port's writer writes it. The trees and the decoded columns
must be equal: same types, values (NaN where NaN), strings, levels,
labels and attributes.
"""

import bz2
import gzip
import lzma
import struct

import numpy as np
import pytest

from dpcorr.io import rds_py as jrds
from dpcorr_torch import perf_hrs
from dpcorr_torch.io import rds, rds_py


class W:
    """Minimal RDS (XDR v3) writer for fixtures."""

    def __init__(self):
        self.out = bytearray(b"X\n")
        for v in (3, 0x040202, 0x030500, 5):
            self.i32(v)
        self.out += b"UTF-8"

    def i32(self, v):
        self.out += struct.pack(">i", v)

    def flags(self, t, has_attr=False, has_tag=False, levels=0, obj=False):
        self.i32(t | (0x100 if obj else 0) | (0x200 if has_attr else 0)
                 | (0x400 if has_tag else 0) | (levels << 12))

    def charsxp(self, s, obj=False):
        if s is None:
            self.flags(rds_py.CHARSXP)
            self.i32(-1)
        else:
            b = s.encode()
            self.flags(rds_py.CHARSXP, levels=64 if s.isascii() else 8,
                       obj=obj)
            self.i32(len(b))
            self.out += b

    def strsxp(self, items, has_attr=False, odd=()):
        self.flags(rds_py.STRSXP, has_attr)
        self.i32(len(items))
        for i, s in enumerate(items):
            self.charsxp(s, obj=i in odd)

    def realsxp(self, vals, has_attr=False):
        self.flags(rds_py.REALSXP, has_attr)
        self.i32(len(vals))
        for v in vals:
            if v is None:
                self.out += struct.pack(">Q", rds_py.R_NA_REAL_BITS)
            else:
                self.out += struct.pack(">d", v)

    def intsxp(self, vals, has_attr=False, t=rds_py.INTSXP):
        self.flags(t, has_attr)
        self.i32(len(vals))
        for v in vals:
            self.i32(rds_py.R_NA_INT if v is None else v)

    def sym(self, name):
        self.flags(rds_py.SYMSXP)
        self.charsxp(name)

    def attr_list(self, pairs):
        for name, emit in pairs:
            self.flags(rds_py.LISTSXP, has_tag=True)
            self.sym(name)
            emit()
        self.nil()

    def nil(self):
        self.i32(rds_py.NILVALUE_SXP)

    def altrep(self, cls, typ, state, attr=None):
        self.flags(rds_py.ALTREP_SXP)
        self.flags(rds_py.LISTSXP)
        self.sym(cls)
        self.flags(rds_py.LISTSXP)
        self.sym("base")
        self.flags(rds_py.LISTSXP)
        self.intsxp([typ])
        self.nil()
        state()
        (attr or self.nil)()

    def data_frame(self, columns, cls=("data.frame",)):
        """columns: (name, emit) pairs; row count from the first."""
        self.flags(rds_py.VECSXP, has_attr=True, obj=True)
        self.i32(len(columns))
        for _, emit in columns:
            emit()
        self.attr_list([
            ("names", lambda: self.strsxp([c for c, _ in columns])),
            ("row.names", lambda: self.intsxp([None, -3])),
            ("class", lambda: self.strsxp(list(cls))),
        ])

    def bytes(self):
        return bytes(self.out)


#: 150 strings: NA, empty, non-ASCII, lengths 1-12 (9 puts a plausible
#: header word in a length field)
LONG = [None if i % 17 == 0 else "" if i % 23 == 0 else "é" * (i % 3)
        + "Northeast"[: i % 10] + str(i % 16 + 1) for i in range(150)]


def _fixtures():
    out = {}

    def make(name):
        def deco(fn):
            w = W()
            fn(w)
            out[name] = w.bytes()
        return deco

    @make("real_na")
    def _(w):
        w.realsxp([1.5, None, -2.0, float("nan")])

    @make("int_na")
    def _(w):
        w.intsxp([7, None, -3])

    @make("logical_na")
    def _(w):
        w.intsxp([1, 0, None], t=rds_py.LGLSXP)

    @make("short_strings")
    def _(w):
        w.strsxp(["a", None, "ζ", ""])

    @make("long_strings")
    def _(w):
        w.strsxp(LONG)

    @make("long_strings_unprovable")
    def _(w):
        # two records flagged with the object bit: R's reader ignores it,
        # the scan cannot prove them, so the vector is read record by
        # record
        w.strsxp(LONG, odd=(40, 41))

    @make("list_of_long_strings_and_reals")
    def _(w):
        w.flags(rds_py.VECSXP, has_attr=True)
        w.i32(3)
        w.strsxp(LONG)
        w.realsxp([3.0, None])
        w.strsxp(LONG[::-1], has_attr=True)
        w.attr_list([("label", lambda: w.strsxp(["reversed"]))])
        w.attr_list([("names", lambda: w.strsxp(["s", "x", "r"]))])

    @make("factor_frame")
    def _(w):
        def factor():
            w.intsxp([1, None, 4], has_attr=True)
            w.attr_list([
                ("levels", lambda: w.strsxp(["Northeast", "Midwest",
                                             "South", "West"])),
                ("class", lambda: w.strsxp(["factor"])),
            ])
        w.data_frame([("x", lambda: w.realsxp([1.0, 2.0, None])),
                      ("cenreg", factor)], cls=("tbl_df", "tbl",
                                                "data.frame"))

    @make("haven_labelled")
    def _(w):
        w.realsxp([1.0, 2.0, None], has_attr=True)
        w.attr_list([
            ("label", lambda: w.strsxp(["Urban or rural"])),
            ("labels", lambda: (w.realsxp([1.0, 2.0], has_attr=True),
                                w.attr_list([("names", lambda: w.strsxp(
                                    ["urban", "rural"]))]))),
            ("class", lambda: w.strsxp(["haven_labelled", "vctrs_vctr",
                                        "double"])),
        ])

    @make("symbol_reference")
    def _(w):
        w.flags(rds_py.VECSXP, has_attr=True)
        w.i32(2)
        w.realsxp([1.0], has_attr=True)
        w.attr_list([("foo", lambda: w.realsxp([9.0]))])
        w.realsxp([2.0], has_attr=True)
        w.flags(rds_py.LISTSXP, has_tag=True)
        w.i32((1 << 8) | rds_py.REFSXP)   # "foo" again, by reference
        w.realsxp([10.0])
        w.nil()
        w.attr_list([("names", lambda: w.strsxp(["a", "b"]))])

    @make("compact_intseq")
    def _(w):
        w.altrep("compact_intseq", 13, lambda: w.realsxp([5.0, 10.0, 1.0]))

    @make("compact_realseq")
    def _(w):
        w.altrep("compact_realseq", 14, lambda: w.realsxp([4.0, 0.5, 2.0]))

    @make("wrap_real")
    def _(w):
        def state():  # CONS(wrapped, metadata), an untagged pairlist
            w.flags(rds_py.LISTSXP)
            w.realsxp([3.5, None])
            w.flags(rds_py.LISTSXP)
            w.intsxp([0, 0])
            w.nil()
        w.altrep("wrap_real", 14, state)

    @make("wrap_string")
    def _(w):
        def state():
            w.flags(rds_py.LISTSXP)
            w.strsxp(LONG)
            w.flags(rds_py.LISTSXP)
            w.intsxp([0, 0])
            w.nil()
        w.altrep("wrap_string", 16, state,
                 attr=lambda: w.attr_list([("label",
                                            lambda: w.strsxp(["w"]))]))

    @make("deferred_string")
    def _(w):
        def state():
            w.flags(rds_py.LISTSXP)
            w.realsxp([1.0, 2.5, None])
            w.flags(rds_py.LISTSXP)
            w.intsxp([0])
            w.nil()
        w.altrep("deferred_string", 16, state)

    return out


FIXTURES = _fixtures()


def _same(p, j):
    """A port RObj tree equals a JAX one: type, data, attributes."""
    assert p.type == j.type
    if isinstance(j.data, np.ndarray):
        assert isinstance(p.data, np.ndarray) and p.data.dtype == j.data.dtype
        np.testing.assert_array_equal(p.data, j.data)
        assert (rds_py.real_is_na(p.data) == jrds.real_is_na(j.data)).all() \
            if j.data.dtype == np.float64 else True
    elif isinstance(j.data, list):
        assert len(p.data) == len(j.data)
        for a, b in zip(p.data, j.data):
            if isinstance(b, tuple):
                assert a[0] == b[0]
                _same(a[1], b[1])
            elif isinstance(b, jrds.RObj):
                _same(a, b)
            else:
                assert a == b
    else:
        assert p.data == j.data
    assert set(p.attributes or {}) == set(j.attributes or {})
    for k, v in (j.attributes or {}).items():
        _same(p.attributes[k], v)


def _same_column(p, j):
    assert (p.name, p.kind, p.levels, p.labels, p.label) == \
        (j.name, j.kind, j.levels, j.labels, j.label)
    if j.kind == "string":
        assert p.values == j.values
    else:
        np.testing.assert_array_equal(p.values, j.values)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_readers_agree_on_each_fixture(name, tmp_path):
    path = tmp_path / f"{name}.rds"
    path.write_bytes(gzip.compress(FIXTURES[name]))
    _same(rds_py.read_rds(str(path)), jrds.read_rds(str(path)))


def test_long_strings_are_decoded_by_the_scan():
    """A long character vector takes the numpy path and ends where the
    next item starts; an unprovable one is read record by record."""
    rd = rds_py._Reader(FIXTURES["list_of_long_strings_and_reals"])
    rd.header()
    obj = rd.item()
    assert obj.data[0].data == LONG and obj.data[2].data == LONG[::-1]
    assert rd.pos == len(rd.buf)
    for name, proved in (("long_strings", True),
                         ("long_strings_unprovable", False)):
        rd = rds_py._Reader(FIXTURES[name])
        rd.header()
        rd.i32()
        n = rd.length()
        assert (rd._charsxp_run(n) is not None) == proved


@pytest.mark.parametrize("compress", [gzip.compress, bz2.compress,
                                      lzma.compress, bytes])
def test_readers_agree_on_each_compression(compress, tmp_path):
    path = tmp_path / "frame.rds"
    path.write_bytes(compress(FIXTURES["factor_frame"]))
    ours, theirs = rds.read_rds_table(path), jrds.read_rds_table(str(path))
    assert list(ours) == list(theirs) == ["x", "cenreg"]
    for name in ours:
        _same_column(ours[name], theirs[name])
    assert ours["cenreg"].levels == ["Northeast", "Midwest", "South", "West"]
    assert np.isnan(ours["cenreg"].values[1])


def test_haven_labels_decode_alike(tmp_path):
    path = tmp_path / "h.rds"
    path.write_bytes(FIXTURES["haven_labelled"])
    obj = rds_py.read_rds(str(path))
    col = rds_py._decode_column("urbrur", obj)
    _same_column(col, jrds._decode_column("urbrur",
                                          jrds.read_rds(str(path))))
    assert col.labels == {"urban": 1.0, "rural": 2.0}
    assert col.label == "Urban or rural" and np.isnan(col.values[2])


def test_synthetic_panel_reads_alike(tmp_path):
    """The HRS-shaped panel as the port's writer writes it: both readers
    give its columns back."""
    cols = perf_hrs.synthetic_panel(5, 16 * 300)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), cols)
    ours, theirs = rds.read_rds_table(path), jrds.read_rds_table(str(path))
    assert list(ours) == list(theirs) == list(perf_hrs.COLUMNS)
    for name, col in cols.items():
        _same_column(ours[name], theirs[name])
        if col.kind == "string":
            assert ours[name].values == col.values
        else:
            np.testing.assert_array_equal(ours[name].values, col.values)


def test_grid_table_reads_back_alike(tmp_path):
    """What the grid writes (the port's writer: doubles, integers,
    logicals, strings with NA) reads back alike through both readers."""
    from dpcorr_torch.io.rds_write import write_rds_frame

    table = {"x": np.array([0.5, np.nan, 2.0]), "i": np.array([1, -3, 7]),
             "b": np.array([True, False, True]),
             "s": np.array(["NI", None, "é"], dtype=object)}
    path = tmp_path / "t.rds"
    write_rds_frame(str(path), table)
    ours, theirs = rds.read_rds_table(path), jrds.read_rds_table(str(path))
    for name in table:
        _same_column(ours[name], theirs[name])
    assert [c.kind for c in ours.values()] == ["double", "integer",
                                               "logical", "string"]


def test_both_readers_refuse_alike(tmp_path):
    """Not a data.frame, and a stream cut inside a long character
    vector."""
    path = tmp_path / "v.rds"
    path.write_bytes(FIXTURES["real_na"])
    for read in (rds_py.read_rds_table, jrds.read_rds_table):
        with pytest.raises(ValueError, match="not a data.frame"):
            read(str(path))
    path.write_bytes(FIXTURES["long_strings"][:-20])
    for read in (rds_py.read_rds, jrds.read_rds):
        with pytest.raises(EOFError):
            read(str(path))


# ---- the native reader (dpcorr_torch/csrc/rdsread.cpp) ----------------------

#: bytes before the first item of a W stream: "X\n", four ints, "UTF-8"
_HEADER = 2 + 4 * 4 + 5


def _as_frame(name: str) -> bytes:
    """A fixture as a table: frames as they are, a vector as the one
    column ``v`` of a data.frame, a list as a column no reader takes."""
    if name == "factor_frame":
        return FIXTURES[name]
    w = W()
    w.data_frame([("v", lambda: w.out.extend(FIXTURES[name][_HEADER:]))])
    return w.bytes()


def _native_and_python(path):
    """(native, port Python, JAX Python) tables of one file."""
    return (rds.read_native(path), rds_py.read_rds_table(str(path)),
            jrds.read_rds_table(str(path)))


LIST_FIXTURES = ("list_of_long_strings_and_reals", "symbol_reference")


@pytest.mark.parametrize("name", sorted(set(FIXTURES) - set(LIST_FIXTURES)))
def test_native_reader_agrees_on_each_fixture(name, tmp_path):
    path = tmp_path / f"{name}.rds"
    path.write_bytes(gzip.compress(_as_frame(name)))
    ours, py, theirs = _native_and_python(path)
    assert list(ours) == list(py) == list(theirs)
    for col in theirs:
        _same_column(ours[col], theirs[col])
        _same_column(py[col], theirs[col])


@pytest.mark.parametrize("name", LIST_FIXTURES)
def test_native_reader_refuses_list_columns_alike(name, tmp_path):
    path = tmp_path / f"{name}.rds"
    path.write_bytes(gzip.compress(_as_frame(name)))
    with pytest.raises(ValueError, match="unsupported type 19"):
        rds.read_native(path)
    for read in (rds_py.read_rds_table, jrds.read_rds_table):
        with pytest.raises(ValueError, match="unsupported type 19"):
            read(str(path))


@pytest.mark.parametrize("compress", [gzip.compress, bz2.compress,
                                      lzma.compress, bytes])
def test_native_reader_reads_each_compression(compress, tmp_path):
    path = tmp_path / "frame.rds"
    path.write_bytes(compress(FIXTURES["factor_frame"]))
    ours, _, theirs = _native_and_python(path)
    for name in theirs:
        _same_column(ours[name], theirs[name])


def test_native_reader_on_the_synthetic_panel(tmp_path):
    cols = perf_hrs.synthetic_panel(8, 16 * 500)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), cols)
    ours, py, theirs = _native_and_python(path)
    assert list(ours) == list(perf_hrs.COLUMNS)
    for name in cols:
        _same_column(ours[name], theirs[name])
        _same_column(ours[name], py[name])


def test_deferred_strings_print_numbers_as_python_does(tmp_path):
    """The deferred_string expansion prints each number as the Python
    readers do: integral values as integers, others in the shortest
    round-trip digits, exponent form below 1e-4."""
    nums = [0.1, 1e-05, 123.456, -2.5, 1e20, float("inf"), float("-inf"),
            3.0, -0.0, 1.5e-07, 2500000000000000.5, 0.0001, None]
    w = W()

    def state():
        w.flags(rds_py.LISTSXP)
        w.realsxp(nums)
        w.flags(rds_py.LISTSXP)
        w.intsxp([0])
        w.nil()

    w.data_frame([("v", lambda: w.altrep("deferred_string", 16, state))])
    path = tmp_path / "d.rds"
    path.write_bytes(w.bytes())
    ours, py, theirs = _native_and_python(path)
    assert ours["v"].values == py["v"].values == theirs["v"].values
    assert ours["v"].values[:3] == ["0.1", "1e-05", "123.456"]


def test_read_rds_table_prefers_native(monkeypatch, tmp_path):
    path = tmp_path / "frame.rds"
    path.write_bytes(gzip.compress(FIXTURES["factor_frame"]))
    calls = []
    real = rds.read_native
    monkeypatch.setattr(rds, "read_native",
                        lambda p: calls.append(p) or real(p))
    rds.read_rds_table(path)
    assert calls == [str(path)]
    monkeypatch.setenv("DPCORR_NO_NATIVE", "1")
    monkeypatch.setattr(rds, "read_native", lambda p: pytest.fail("native"))
    got = rds.read_rds_table(path)
    _same_column(got["cenreg"], jrds.read_rds_table(str(path))["cenreg"])


def test_corrupt_file_raises_alike(tmp_path, caplog):
    """The native reader refuses a cut stream; ``read_rds_table`` logs it,
    falls back and raises what both Python readers raise."""
    path = tmp_path / "cut.rds"
    path.write_bytes(_as_frame("long_strings")[:-40])
    with pytest.raises(ValueError, match="truncated RDS"):
        rds.read_native(path)
    with caplog.at_level("WARNING", logger="dpcorr_torch.io.rds"):
        with pytest.raises(EOFError):
            rds.read_rds_table(path)
    assert "falling back" in caplog.text
    with pytest.raises(EOFError):
        jrds.read_rds_table(str(path))


def test_build_failure_falls_back_with_a_warning(monkeypatch, tmp_path,
                                                 caplog):
    path = tmp_path / "frame.rds"
    path.write_bytes(gzip.compress(FIXTURES["factor_frame"]))
    monkeypatch.setattr(rds, "_lib", None)
    monkeypatch.setattr(rds, "_lib_error", RuntimeError("no compiler"))
    with pytest.raises(RuntimeError, match="no compiler"):
        rds.native_reader()
    with caplog.at_level("WARNING", logger="dpcorr_torch.io.rds"):
        got = rds.read_rds_table(path)
    assert "unavailable" in caplog.text
    _same_column(got["x"], jrds.read_rds_table(str(path))["x"])


def test_native_build_is_digest_named():
    from dpcorr_torch.ops import _build

    assert _build.source_path("rdsread").suffix == ".cpp"
    lib = _build.library_path("rdsread")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("rdsread-")
    rds.native_reader()
    assert lib.exists()
