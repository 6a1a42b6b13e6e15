"""Lightweight span tracer: JSONL log + Chrome trace-event export.

Counterpart of ``dpcorr/obs/trace.py``, the same span model and file
format, so one summariser reads either package's logs:

- a **span** is one named wall-clock interval with a ``trace_id``
  linking every span of one logical operation (a grid run, an ε-sweep)
  and a ``parent_id`` giving the in-trace tree;
- spans land as one JSON object per line (append-only JSONL: a crash
  leaves a valid prefix, ``tail -f`` works);
- :func:`to_chrome_trace` converts a span log into Chrome trace-event
  format (``{"traceEvents": [...]}``), loadable in Perfetto or
  ``chrome://tracing`` beside a ``torch.profiler`` trace of the card.

Parenting is implicit within a thread (a context-local stack) and
explicit across threads or phases: a caller passes ``parent=`` (the
ε-sweep's dispatch and fetch loops do).

A tracer constructed with ``path=None`` is disabled: ``span()`` yields a
reusable null span and touches no locks, so instrumented code pays a
single attribute check when tracing is off.

While ``torch.profiler`` records, every span (span log on or off) also
opens a ``record_function`` range of its name, ended by ``Span.end``, so
the span sits in the profiler's trace on the kernels' clock. The module
never imports torch: it looks for it in ``sys.modules``, so with the
profiler off a span pays one check more. Device time is optional:
callers that read the card inside a span can record device seconds as an
attr (``span.set(device_s=...)``); the tracer never synchronises itself.
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import sys
import threading
import time

_local = threading.local()


def _new_id() -> str:
    """64-bit random hex — unique far past any realistic span volume."""
    return secrets.token_hex(8)


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while
    ``torch.profiler`` records, else None. torch is looked up, never
    imported: a process without it records nothing."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class SpanContext:
    """The cross-thread handle: just (trace_id, span_id), picklable and
    cheap."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    """One live interval. ``set(**attrs)`` attaches attributes (device
    seconds, batch size, ε); ``end()`` stamps the duration and writes
    the JSONL line. Use via ``tracer.span(...)`` unless the begin and end
    points live on different call paths; then ``tracer.start_span`` and
    ``end``."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "t_wall", "_t0", "_tid", "_ended", "_range")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self._tid = threading.current_thread().name
        self._ended = False
        self._range = _profiler_range(name)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        dur_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.tracer._write(self, dur_s)


class _NullSpan:
    """The disabled tracer's span: every operation a no-op, one shared
    instance, so instrumentation costs nothing when tracing is off."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    context = None

    def set(self, **attrs) -> None:
        pass

    def end(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _RangeSpan(_NullSpan):
    """A disabled tracer's span while ``torch.profiler`` records: no log
    line, only the profiler range, ended by :meth:`end`."""

    __slots__ = ("_range",)

    def __init__(self, rf):
        self._range = rf

    def end(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


class Tracer:
    """JSONL span writer. ``path=None`` disables (null spans), unless an
    observer attaches (:meth:`add_observer`), which enables span
    production without a file (a caller that keeps spans in memory)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.enabled = path is not None
        self._lock = threading.Lock()
        self._fh = None  # guarded by: _lock
        self._observers: list = []  # guarded by: _lock
        if self.enabled:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", buffering=1)  # line-buffered

    def add_observer(self, fn) -> None:
        """Register ``fn(span_dict)`` to receive every finished span.
        Attaching enables the tracer even with no span file."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)
        self.enabled = True

    def remove_observer(self, fn) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)
            if self._fh is None and not self._observers:
                self.enabled = False

    def start_span(self, name: str, parent: SpanContext | Span | None = None,
                   trace_id: str | None = None, **attrs) -> Span:
        """Begin a span the caller will ``end()`` explicitly. Parent
        resolution order: explicit ``parent``, else the calling thread's
        current span, else a fresh root (new trace unless ``trace_id``
        pins one). Disabled, it returns the null span, or while the
        profiler records a span that is only a profiler range."""
        if not self.enabled:
            rf = _profiler_range(name)
            return _NULL_SPAN if rf is None else _RangeSpan(rf)
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id, attrs)
        cur = current_span()
        if cur is not None and cur.tracer is self:
            return Span(self, name, cur.trace_id, cur.span_id, attrs)
        return Span(self, name, trace_id or _new_id(), None, attrs)

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | Span | None = None,
             trace_id: str | None = None, **attrs):
        """``with tracer.span("grid.fetch", n=4000) as sp:`` ends on exit
        (errors too, stamped ``error=<type>``) and maintains the thread's
        implicit-parent stack."""
        sp = self.start_span(name, parent=parent, trace_id=trace_id,
                             **attrs)
        if not isinstance(sp, Span):
            try:
                yield sp
            finally:
                sp.end()
            return
        stack = _span_stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set(error=type(e).__name__)
            raise
        finally:
            stack.pop()
            sp.end()

    def _write(self, sp: Span, dur_s: float) -> None:
        obj = {
            "name": sp.name, "trace_id": sp.trace_id,
            "span_id": sp.span_id, "parent_id": sp.parent_id,
            "ts": sp.t_wall, "dur_s": dur_s, "thread": sp._tid,
            "attrs": sp.attrs,
        }
        with self._lock:
            if self._fh is not None:
                self._fh.write(json.dumps(obj) + "\n")
            observers = list(self._observers)
        # observers run outside the tracer lock: an observer that takes
        # its own lock must not nest under ours
        for fn in observers:
            fn(obj)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if not self._observers:
                self.enabled = False


def _span_stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_span() -> Span | None:
    """The calling thread's innermost live span (implicit parent)."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


# ------------------------------------------------------- global tracer ----
_global = Tracer(None)
_global_lock = threading.Lock()


def configure(path: str | None) -> Tracer:
    """Install the process tracer (as the ``DPCORR_TRACE`` environment
    variable does). ``None`` reverts to disabled. Returns the new
    tracer."""
    global _global
    with _global_lock:
        old, _global = _global, Tracer(path)
        if old.enabled:
            old.close()
        return _global


def tracer() -> Tracer:
    """The process tracer: disabled unless :func:`configure` (or the
    ``DPCORR_TRACE`` environment variable, read once at first use)
    enabled it."""
    global _global
    if not _global.enabled:
        env = os.environ.get("DPCORR_TRACE")
        if env:
            with _global_lock:
                if not _global.enabled:
                    _global = Tracer(env)
    return _global


# ---------------------------------------------------- wire propagation ----
def wire_headers(ctx: SpanContext | Span | None) -> dict[str, str]:
    """Serialize a span context into message headers, so one trace can
    cover two processes: the sender stamps its current span here, the
    receiver parents its own spans on :func:`from_wire_headers` of what
    arrived. Returns ``{}`` when tracing is off (null span / ``None``):
    absent headers, not empty strings, so the receiving side stays a
    clean root."""
    if ctx is None or ctx.trace_id is None:
        return {}
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


def from_wire_headers(headers: dict | None) -> SpanContext | None:
    """Inverse of :func:`wire_headers`: rebuild the remote parent
    context from message headers, ``None`` when the peer wasn't
    tracing."""
    if not headers:
        return None
    tid, sid = headers.get("trace_id"), headers.get("span_id")
    if not tid or not sid:
        return None
    return SpanContext(str(tid), str(sid))


# ------------------------------------------------------ readers/export ----
def read_spans(path: str) -> list[dict]:
    """Load a JSONL span log; raises ValueError naming the first bad
    line (an unparseable log fails loudly)."""
    spans = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: bad span line: {e}") from e
            if not isinstance(obj, dict) or "name" not in obj \
                    or "dur_s" not in obj:
                raise ValueError(f"{path}:{i}: not a span object")
            spans.append(obj)
    return spans


def to_chrome_trace(spans: list[dict] | str) -> dict:
    """Convert a span log (list or JSONL path) into Chrome trace-event
    JSON — ``X`` (complete) events, microsecond timestamps, one ``tid``
    row per originating thread. Load the result in Perfetto or
    ``chrome://tracing``; span attrs (and trace/span ids) appear as
    event ``args`` so a request chain is clickable."""
    if isinstance(spans, str):
        spans = read_spans(spans)
    tids: dict[str, int] = {}
    events = []
    for sp in spans:
        tid = tids.setdefault(sp.get("thread", "main"), len(tids) + 1)
        events.append({
            "name": sp["name"], "ph": "X", "pid": 1, "tid": tid,
            "ts": sp.get("ts", 0.0) * 1e6,
            "dur": sp["dur_s"] * 1e6,
            "args": {**sp.get("attrs", {}),
                     "trace_id": sp.get("trace_id"),
                     "span_id": sp.get("span_id"),
                     "parent_id": sp.get("parent_id")},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
             "args": {"name": name}} for name, t in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: list[dict] | str, out_path: str) -> str:
    with open(out_path, "w") as f:
        json.dump(to_chrome_trace(spans), f)
    return out_path
