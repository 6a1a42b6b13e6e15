"""Named crash points, seeded kill plans and fault sites.

Counterpart of ``dpcorr/chaos.py``: code with a durability boundary
declares it (``chaos.point``), code that can limp declares a fault site
(``chaos.fault``), and a plan installed by a test, the CLI (``party
--chaos``, ``serve --fault``) or the ``DPCORR_CHAOS`` environment
variable makes the process die or degrade there.

- **Crash points** model the process dying at a boundary: a
  :class:`ChaosPlan` kills on a chosen traversal of a chosen point,
  ``exit`` mode by ``os._exit(42)`` (no ``finally``, no atexit) or
  ``raise`` mode by :class:`SimulatedCrash`, a ``BaseException`` that
  sails through every recovery handler as a real kill would.
- **Fault sites** model it limping: a :class:`FaultPlan` raises
  :class:`SimulatedFault` (a plain ``Exception``, caught like a real
  kernel error) or sleeps, over a range of traversals.

Both are one ``is None`` or emptiness check when nothing is armed.
:data:`KNOWN_POINTS` and :data:`MATRIX_POINTS` are the JAX package's
tuples in its order, because :func:`plan_from_seed` indexes into them.
Every one of them is traversed by a module of this package, so
:data:`UNREACHABLE_POINTS` is empty.
"""

from __future__ import annotations

import os
import random
import threading
import time

#: Exit status a chaos kill dies with, so an ordinary crash (bug, OOM) is
#: never mistaken for the plan.
EXIT_CODE = 42

#: Every registered crash point. Static, ordered, and append-only by
#: convention: seed-derived plans index into this list, so reordering
#: would silently change what historical seeds reproduce.
KNOWN_POINTS = (
    # protocol session (party.py / gate.py / journal consumers)
    "party.post_handshake",   # handshake done, nothing journaled yet
    "journal.post_prepare",   # outbound slot durable, not charged/sent
    "gate.post_charge",       # eps durably charged, release not sent
    "gate.post_send",         # release acked, journal not marked
    "party.post_gated",       # journal marked acked, transcript pending
    # ledger durability windows (serve/ledger.py; also traversed by the
    # protocol parties — the gate charges the same ledger)
    "ledger.pre_persist",     # spend mutated in memory, file untouched
    "ledger.post_persist",    # spend on disk, audit event not written
    # serve flush pipeline (serve/coalescer.py)
    "coalescer.pre_flush",    # batch popped, kernel not dispatched
    "coalescer.post_flush",   # responses resolved, stats published
    # budget-directory persist windows (serve/budget_dir.py) — every
    # durability boundary of a sharded per-user charge
    "budget.pre_journal",     # admitted, WAL line not yet appended
    "budget.post_journal",    # WAL line fsynced, not applied in memory
    "budget.mid_compaction",  # snapshot gen+1 renamed, WAL still gen
    "budget.mid_eviction",    # cold spill appended, user still resident
    # federation matrix sessions (protocol/federation.py)
    "federation.pre_release",  # column artifacts built, round not charged
    "federation.mid_matrix",   # some pair links finished, others pending
    "federation.pre_finish",   # round validated, finish kernel not run
    # stream window release sequence (stream/service.py) — NOT in
    # MATRIX_POINTS: the two-party chaos matrix never traverses them
    "stream.pre_release",      # window closable, nothing charged yet
    "stream.mid_window",       # ingest batch in the WAL, not acked
    "stream.post_journal",     # release journaled, window not closed
    # fleet lease takeover (serve/fleet/lease.py) — NOT in
    # MATRIX_POINTS: the two-party chaos matrix never traverses it;
    # the JAX package's fleet tests do
    "fleet.pre_lease_commit",  # claim file won, lease not committed
)

#: The step-kill matrix the JAX package's ``chaos`` command sweeps: the
#: points every protocol role traverses exactly once per session (the
#: ledger windows fire inside the role's own gated charge). The coalescer
#: points are serve-side and are exercised by the serve/ledger crash tests
#: instead.
MATRIX_POINTS = (
    "party.post_handshake",
    "journal.post_prepare",
    "gate.post_charge",
    "ledger.post_persist",
    "gate.post_send",
    "party.post_gated",
    # budget-directory windows: traversed once per gated charge when
    # the party wraps its ledger in a CompositeLedger (the chaos command
    # arms the directory with compact-every=1 / max-resident=0 so the
    # compaction and eviction windows fire on that same charge)
    "budget.pre_journal",
    "budget.post_journal",
    "budget.mid_compaction",
    "budget.mid_eviction",
    # federation points: two-party sessions never traverse these; the
    # chaos CLI routes them to a 3-party matrix case instead (and the
    # two-party crash-resume matrix test filters them out)
    "federation.pre_release",
    "federation.mid_matrix",
    "federation.pre_finish",
)

#: Points no module of this package traverses: none, since the fleet lease
#: (``fleet.pre_lease_commit``) came with ``serve.fleet.lease``.
UNREACHABLE_POINTS: frozenset = frozenset()

_MODES = ("exit", "raise")
_KNOWN = frozenset(KNOWN_POINTS)


class SimulatedCrash(BaseException):
    """An in-process stand-in for a kill at a chaos point.

    Deliberately a ``BaseException``: recovery handlers catch concrete
    failure types (``TransportError`` → refund, ``Exception`` →
    degrade), and a simulated *crash* must sail through all of them
    exactly like ``os._exit`` would — a refund fired by a pretend kill
    would test a code path no real crash takes.
    """

    def __init__(self, point: str):
        self.point = point
        super().__init__(f"simulated crash at chaos point {point!r}")


class ChaosPlan:
    """One planned kill: die on the ``hit``-th traversal of ``point``.

    ``role`` names the party process that receives the plan;
    ``thread_name`` scopes an in-process plan to one victim thread so the
    surviving party thread in a two-threads-one-process test sails past
    the same point untouched. ``seed`` records how the plan was derived,
    for the transcript header."""

    def __init__(self, point: str, hit: int = 1, mode: str = "exit",
                 role: str | None = None, seed: int | None = None,
                 thread_name: str | None = None):
        if point not in _KNOWN:
            raise ValueError(f"unknown chaos point {point!r}; "
                             f"registered: {KNOWN_POINTS}")
        if hit < 1:
            raise ValueError(f"hit must be >= 1, got {hit}")
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        self.point = point
        self.hit = int(hit)
        self.mode = mode
        self.role = role
        self.seed = seed
        self.thread_name = thread_name

    def to_dict(self) -> dict:
        """Transcript-header form: everything needed to reproduce."""
        out = {"point": self.point, "hit": self.hit, "mode": self.mode}
        if self.role is not None:
            out["role"] = self.role
        if self.seed is not None:
            out["seed"] = self.seed
        return out

    def to_spec(self) -> str:
        """The ``--chaos``/``DPCORR_CHAOS`` string form of this plan."""
        parts = [f"point={self.point}", f"hit={self.hit}",
                 f"mode={self.mode}"]
        if self.role is not None:
            parts.append(f"role={self.role}")
        return ",".join(parts)


def plan_from_seed(seed: int, mode: str = "exit") -> ChaosPlan:
    """Derive a matrix kill deterministically from one integer: which
    point, which traversal (always the first: each matrix point fires
    once per session) and which role is the victim. stdlib RNG over the
    static matrix, so a seed names the same kill as in the JAX package."""
    r = random.Random(int(seed))
    point = r.choice(MATRIX_POINTS)
    role = r.choice(("x", "y"))
    return ChaosPlan(point, hit=1, mode=mode, role=role, seed=int(seed))


def plan_from_spec(spec: str) -> ChaosPlan:
    """Parse ``"point=gate.post_charge,hit=1,mode=exit"`` or
    ``"seed=123"`` (seed-derived matrix kill)."""
    fields: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad chaos spec field {part!r} "
                             "(want key=value)")
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    if "seed" in fields:
        plan = plan_from_seed(int(fields["seed"]),
                              mode=fields.get("mode", "exit"))
        if "role" in fields:
            plan.role = fields["role"]
        return plan
    if "point" not in fields:
        raise ValueError(f"chaos spec {spec!r} names neither point= "
                         "nor seed=")
    return ChaosPlan(fields["point"], hit=int(fields.get("hit", "1")),
                     mode=fields.get("mode", "exit"),
                     role=fields.get("role"))


def plan_from_env(env: str = "DPCORR_CHAOS") -> ChaosPlan | None:
    """The subprocess hook: a victim process started with
    ``DPCORR_CHAOS=point=...,hit=...`` installs its own kill."""
    spec = os.environ.get(env)
    return plan_from_spec(spec) if spec else None


_lock = threading.Lock()
_plan: ChaosPlan | None = None  # guarded by: _lock
_counts: dict[str, int] = {}  # guarded by: _lock
_crash_hooks: list = []  # guarded by: _lock


def on_crash(fn) -> None:
    """Register ``fn(point_name)`` to run just BEFORE a planned kill
    (both modes — ahead of ``os._exit`` and ahead of the raise). The
    flight recorder's last-gasp dump hook: ``exit`` mode skips every
    ``finally``/atexit on purpose, so anything that must survive the
    kill has to happen here. Hooks are best-effort — an exception in
    one must not save the victim."""
    with _lock:
        if fn not in _crash_hooks:
            _crash_hooks.append(fn)


def remove_crash_hook(fn) -> None:
    with _lock:
        if fn in _crash_hooks:
            _crash_hooks.remove(fn)


def install(plan: ChaosPlan | None) -> None:
    """Arm ``plan`` process-wide (traversal counters reset). ``None``
    disarms — same as :func:`clear`."""
    global _plan
    with _lock:
        _plan = plan
        _counts.clear()


def clear() -> None:
    install(None)


def active() -> ChaosPlan | None:
    # dpcorr-lint: ignore[lock-unguarded-read] — benign stale read (racing disarm)
    return _plan


def point(name: str) -> None:
    """Declare one crash window. No-op unless the armed plan names this
    point (and this thread, for thread-scoped plans); on the planned
    traversal the process dies (``exit``) or :class:`SimulatedCrash`
    propagates (``raise``)."""
    # dpcorr-lint: ignore[lock-unguarded-read] — hot-path probe, re-checked under _lock
    plan = _plan
    if plan is None:
        return
    if name not in _KNOWN:
        raise ValueError(f"unregistered chaos point {name!r}; add it to "
                         "chaos.KNOWN_POINTS")
    if plan.point != name:
        return
    if plan.thread_name is not None \
            and threading.current_thread().name != plan.thread_name:
        return
    with _lock:
        if _plan is not plan:  # disarmed while we raced here
            return
        _counts[name] = _counts.get(name, 0) + 1
        if _counts[name] != plan.hit:
            return
        hooks = list(_crash_hooks)
    for fn in hooks:
        try:
            fn(name)
        except Exception:
            pass  # a broken hook must not save the victim
    if plan.mode == "exit":
        os._exit(EXIT_CODE)
    raise SimulatedCrash(name)


# ------------------------------------------------------------- faults ----
# Crash points (above) model the process DYING at a boundary; fault
# points model it LIMPING: a kernel that raises, a kernel that takes 50x
# its budget, a flush thread that stalls. ``SimulatedFault`` is a plain
# ``Exception`` so the degradation machinery under test (unbatched
# fallback, circuit breaker, retrying client) catches it like a real
# lowering error or device OOM; several fault plans may be armed at once
# and each fires over a traversal range; ``sleep`` mode delays instead.

#: Registered fault sites. Append-only, same convention as
#: KNOWN_POINTS; disjoint from it — a name is a crash point or a fault
#: point, never both.
FAULT_POINTS = (
    "serve.kernel",        # batched/unbatched launch raises
    "serve.kernel_slow",   # launch takes delay_s longer than it should
    "serve.flush_stall",   # the flush thread stalls before dispatch
)

_FAULT_MODES = ("fail", "sleep")
_KNOWN_FAULTS = frozenset(FAULT_POINTS)


class SimulatedFault(Exception):
    """An injected *service* fault (kernel failure, not process death).

    A plain ``Exception`` on purpose — the degradation machinery under
    test (unbatched fallback, circuit breaker, retrying client) handles
    concrete execution failures, and the injected stand-in must be
    caught exactly like a real lowering error or device OOM would be.
    """

    def __init__(self, point: str):
        self.point = point
        super().__init__(f"simulated fault at chaos point {point!r}")


class FaultPlan:
    """One armed degradation: traversals ``after+1 .. after+times`` of
    ``point`` either raise :class:`SimulatedFault` (``mode="fail"``) or
    sleep ``delay_s`` (``mode="sleep"``). ``times=None`` fires forever
    (until cleared) — sustained overload, the brownout trigger."""

    def __init__(self, point: str, mode: str = "fail",
                 times: int | None = None, delay_s: float = 0.0,
                 after: int = 0):
        if point not in _KNOWN_FAULTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"registered: {FAULT_POINTS}")
        if mode not in _FAULT_MODES:
            raise ValueError(f"mode must be one of {_FAULT_MODES}, "
                             f"got {mode!r}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1 or None, got {times}")
        if mode == "sleep" and delay_s <= 0.0:
            raise ValueError("sleep mode needs delay_s > 0")
        if after < 0:
            raise ValueError(f"after must be >= 0, got {after}")
        self.point = point
        self.mode = mode
        self.times = times
        self.delay_s = float(delay_s)
        self.after = int(after)

    def to_dict(self) -> dict:
        out = {"point": self.point, "mode": self.mode}
        if self.times is not None:
            out["times"] = self.times
        if self.delay_s:
            out["delay_s"] = self.delay_s
        if self.after:
            out["after"] = self.after
        return out


def fault_from_spec(spec: str) -> FaultPlan:
    """Parse ``"point=serve.kernel,mode=fail,times=3"`` or
    ``"point=serve.kernel_slow,mode=sleep,delay_ms=40"``."""
    fields: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad fault spec field {part!r} "
                             "(want key=value)")
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    if "point" not in fields:
        raise ValueError(f"fault spec {spec!r} names no point=")
    delay = float(fields.get("delay_s", "0") or 0)
    if "delay_ms" in fields:
        delay = float(fields["delay_ms"]) / 1e3
    return FaultPlan(fields["point"],
                     mode=fields.get("mode", "fail"),
                     times=(int(fields["times"]) if "times" in fields
                            else None),
                     delay_s=delay,
                     after=int(fields.get("after", "0")))


def faults_from_env(env: str = "DPCORR_FAULTS") -> list[FaultPlan]:
    """``DPCORR_FAULTS`` holds ``;``-separated fault specs — the
    subprocess hook mirroring :func:`plan_from_env`."""
    raw = os.environ.get(env)
    if not raw:
        return []
    return [fault_from_spec(s) for s in raw.split(";") if s.strip()]


_fault_plans: list[FaultPlan] = []  # guarded by: _lock
_fault_counts: dict[int, int] = {}  # guarded by: _lock


def install_fault(plan: FaultPlan) -> None:
    """Arm one fault plan (additive — unlike crash plans, several may
    be live at once)."""
    with _lock:
        _fault_plans.append(plan)


def install_faults(plans: list[FaultPlan]) -> None:
    for p in plans:
        install_fault(p)


def clear_faults() -> None:
    with _lock:
        _fault_plans.clear()
        _fault_counts.clear()


def active_faults() -> list[FaultPlan]:
    """The armed fault plans, in the order they were installed (a copy),
    as ``dpcorr.chaos.active_faults`` lists them."""
    with _lock:
        return list(_fault_plans)


def fault(name: str) -> None:
    """Declare one fault site. No-op unless an armed plan names this
    point and the traversal falls in its firing window; then sleep
    (``sleep``) or raise :class:`SimulatedFault` (``fail``)."""
    # dpcorr-lint: ignore[lock-unguarded-read] — hot-path probe, re-read under _lock
    if not _fault_plans:
        return
    if name not in _KNOWN_FAULTS:
        raise ValueError(f"unregistered fault point {name!r}; add it to "
                         "chaos.FAULT_POINTS")
    fire: FaultPlan | None = None
    with _lock:
        for plan in _fault_plans:
            if plan.point != name:
                continue
            k = _fault_counts.get(id(plan), 0) + 1
            _fault_counts[id(plan)] = k
            if k <= plan.after:
                continue
            if plan.times is not None and k > plan.after + plan.times:
                continue
            fire = plan
            break
    if fire is None:
        return
    if fire.mode == "sleep":
        time.sleep(fire.delay_s)
        return
    raise SimulatedFault(name)
