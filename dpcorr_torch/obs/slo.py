"""Declarative SLOs evaluated as multi-window burn-rate alerts.

Counterpart of ``dpcorr/obs/slo.py``: the same objectives, windows and
state machine, so under one scripted clock both packages fire the same
transitions.

The serve layer already publishes a single-window burn gauge
(``dpcorr_serve_slo_burn_rate`` — one threshold, one window, one
process). Fleet operation needs the real thing: objectives declared
once, evaluated over the *scraped* cumulative series of every instance,
with the classic multi-window / multi-burn-rate policy (a page needs
BOTH a fast short-window burn and a sustained long-window burn, so a
single slow request cannot page and a slow leak cannot hide).

Everything here is deterministic and clock-injectable on purpose:
``observe``/``evaluate`` take an explicit ``at`` timestamp, so the
state machine's transitions are a pure function of the scraped counter
deltas and the scripted clock — the property the tests pin. No wall-clock reads happen unless the
caller omits ``at``.

Objective kinds (all computed from cumulative exposition series, so a
missed scrape loses resolution, never correctness):

- ``latency`` — a request is *bad* when it lands above ``threshold_s``
  in the instance's latency histogram. The threshold must be an exact
  bucket bound: cumulative buckets make "good ≤ le" exact, and refusing
  an off-bucket threshold loudly beats silently interpolating.
- ``error``   — bad = Σ configured failure counters (refused, failed),
  total = admitted + refused.
- ``eps_burn`` — bad = ε actually spent (from the scraped per-party
  spend series), budget = ``eps_per_s × window`` — "are we spending
  privacy budget faster than the release schedule sustains".

The ``page`` transition arms the offending instance's flight recorder
through its existing trigger hook: in-process via
:func:`recorder_trigger_hook` (→ ``obs.recorder.trigger("slo_page")``),
cross-process via :func:`http_trigger_hook` (→ ``POST /obs/trigger`` on
the serve front end, which calls the same hook inside that instance).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Callable, Mapping

from dpcorr_torch.obs.fleet import MetricFamily

#: classic multi-window policy (Google SRE workbook shape): page on a
#: fast, confirmed burn; warn on a sustained slow one. Windows are in
#: seconds of scraped history; thresholds are in "error budgets per
#: window" (burn rate 1.0 = spending exactly the allowed budget).
DEFAULT_WINDOWS = (
    # severity, short window, long window, burn-rate threshold
    ("page", 300.0, 3600.0, 14.4),
    ("warn", 1800.0, 21600.0, 6.0),
)

_KINDS = ("latency", "error", "eps_burn", "gauge")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective. ``target`` is the error budget — the
    tolerated bad fraction (latency/error) — or, for ``eps_burn``, the
    sustainable spend rate is ``eps_per_s`` and ``target`` scales it
    (1.0 = page when spending faster than the schedule itself)."""

    name: str
    kind: str
    target: float
    #: latency kind: histogram family + exact bucket bound
    histogram: str = "dpcorr_serve_latency_seconds"
    threshold_s: float | None = None
    #: error kind: family names summed into the denominator / numerator
    total_series: tuple = ("dpcorr_serve_requests_total",
                           "dpcorr_serve_requests_refused_total")
    bad_series: tuple = ("dpcorr_serve_requests_refused_total",
                         "dpcorr_serve_requests_failed_total")
    #: eps_burn kind: spend gauge family + sustainable rate
    eps_series: str = "dpcorr_ledger_spent_eps"
    eps_per_s: float = 0.0
    #: gauge kind: an instantaneous level (e.g. watermark lag) whose
    #: budget is ``threshold_s`` — burn rate is worst-in-window / budget
    gauge_series: str = "dpcorr_stream_watermark_lag_seconds"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"objective {self.name!r}: unknown kind "
                             f"{self.kind!r} (one of {_KINDS})")
        if self.target <= 0:
            raise ValueError(f"objective {self.name!r}: target must be "
                             f"> 0, got {self.target}")
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError(f"objective {self.name!r}: latency kind "
                             f"needs threshold_s")
        if self.kind == "eps_burn" and self.eps_per_s <= 0:
            raise ValueError(f"objective {self.name!r}: eps_burn kind "
                             f"needs eps_per_s > 0")
        if self.kind == "gauge" and (self.threshold_s is None
                                     or self.threshold_s <= 0):
            raise ValueError(f"objective {self.name!r}: gauge kind "
                             f"needs threshold_s > 0 (the level budget)")

    # -- cumulative (bad, total) off one instance's parsed families ----
    def cumulative(self, families: Mapping[str, MetricFamily],
                   ) -> tuple[float, float | None]:
        """``(bad, total)`` as cumulative values; ``total`` is ``None``
        for ``eps_burn`` (its budget is a rate × window, not a scraped
        counter)."""
        if self.kind == "latency":
            fam = families.get(self.histogram)
            if fam is None:
                return 0.0, 0.0
            total = _sum_samples(fam, f"{self.histogram}_count")
            good = None
            want = _le_repr(self.threshold_s)
            for sample_name, labels, value in fam.samples:
                if sample_name != f"{self.histogram}_bucket":
                    continue
                le = dict(labels).get("le")
                if le is not None and _le_match(le, want):
                    good = (good or 0.0) + value
            if good is None:
                les = sorted({dict(ls).get("le")
                              for s, ls, _ in fam.samples
                              if s == f"{self.histogram}_bucket"})
                raise ValueError(
                    f"objective {self.name!r}: threshold_s="
                    f"{self.threshold_s} is not a bucket bound of "
                    f"{self.histogram} (le ∈ {les}) — cumulative "
                    f"buckets only answer exact-bound questions")
            return total - good, total
        if self.kind == "error":
            total = sum(_sum_samples(families.get(n)) or 0.0
                        for n in self.total_series)
            bad = sum(_sum_samples(families.get(n)) or 0.0
                      for n in self.bad_series)
            return bad, total
        if self.kind == "gauge":
            # a level, not a rate: "bad" is the gauge itself (worst
            # sample when labelled), and there is no denominator
            fam = families.get(self.gauge_series)
            if fam is None:
                return 0.0, None
            vals = [v for _n, _ls, v in fam.samples]
            return (max(vals) if vals else 0.0), None
        # eps_burn: cumulative spend over every party the series carries
        fam = families.get(self.eps_series)
        return (_sum_samples(fam) or 0.0), None


def _sum_samples(fam: MetricFamily | None,
                 sample_name: str | None = None) -> float | None:
    if fam is None:
        return None
    name = sample_name if sample_name is not None else fam.name
    return sum(v for s, _, v in fam.samples if s == name)


def _le_repr(bound: float) -> str:
    v = float(bound)
    return str(int(v)) if v.is_integer() else repr(v)


def _le_match(le: str, want: str) -> bool:
    if le == want:
        return True
    try:
        return float(le) == float(want) and not math.isinf(float(le))
    except ValueError:
        return False


@dataclasses.dataclass(frozen=True)
class Alert:
    """One state transition of one (objective, instance) pair."""

    objective: str
    instance: str
    severity: str          # "page" | "warn" | "ok"
    previous: str
    burn_short: float
    burn_long: float
    window: tuple          # the (severity, short_s, long_s, threshold) row
    at: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BurnRateEngine:
    """The deterministic multi-window burn-rate state machine.

    Feed it scrapes with :meth:`observe` (cumulative families per
    instance, stamped by the injectable clock), then :meth:`evaluate`
    computes each (objective, instance) pair's burn rate over every
    configured window and walks the ``ok → warn → page`` machine.
    Transitions *into* ``page``/``warn`` fire ``on_page``/``on_warn``
    exactly once per transition — the page hook is how the offending
    instance's flight recorder gets armed.
    """

    def __init__(self, objectives, windows=DEFAULT_WINDOWS,
                 clock: Callable[[], float] | None = None,
                 on_page: Callable[[Alert], None] | None = None,
                 on_warn: Callable[[Alert], None] | None = None,
                 max_samples: int = 4096):
        self.objectives = tuple(objectives)
        if not self.objectives:
            raise ValueError("BurnRateEngine needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.windows = tuple(windows)
        self._clock = clock if clock is not None else time.monotonic
        self.on_page = on_page
        self.on_warn = on_warn
        self._series: dict[tuple, deque] = {}
        self._state: dict[tuple, str] = {}
        self._max = int(max_samples)
        #: every transition ever fired, oldest first (the artifact trail)
        self.alerts: list[Alert] = []

    # -- feeding -------------------------------------------------------
    def observe(self, families_by_instance: Mapping[str, Mapping],
                at: float | None = None) -> None:
        """Record one scrape: ``{instance: parsed families}`` (what
        ``FleetSnapshot.families()`` returns) at clock time ``at``."""
        t = float(at) if at is not None else self._clock()
        for inst in sorted(families_by_instance):
            fams = families_by_instance[inst]
            for obj in self.objectives:
                bad, total = obj.cumulative(fams)
                ring = self._series.setdefault(
                    (obj.name, inst), deque(maxlen=self._max))
                ring.append((t, bad, total))

    # -- burn arithmetic ----------------------------------------------
    def _burn(self, obj: Objective, ring, t: float,
              window_s: float) -> float:
        """Burn rate over the trailing ``window_s`` at time ``t``: the
        newest sample at or before ``t - window_s`` anchors the delta
        (falling back to the oldest sample — a partial window reads as
        what it is, not as zero)."""
        if len(ring) < 2:
            return 0.0
        if obj.kind == "gauge":
            # a gauge has no delta arithmetic: its burn over a window
            # is the worst level observed in [t - window_s, t] as a
            # multiple of the budget (threshold_s × target)
            worst = max((bad for ts, bad, _total in ring
                         if ts >= t - window_s),
                        default=ring[-1][1])
            budget = (obj.threshold_s or 0.0) * obj.target
            return worst / budget if budget > 0 else 0.0
        newest = ring[-1]
        anchor = ring[0]
        for sample in ring:
            if sample[0] <= t - window_s:
                anchor = sample
            else:
                break
        dt = newest[0] - anchor[0]
        if dt <= 0:
            return 0.0
        dbad = newest[1] - anchor[1]
        if obj.kind == "eps_burn":
            budget = obj.eps_per_s * dt * obj.target
            return max(0.0, dbad) / budget if budget > 0 else 0.0
        dtotal = (newest[2] or 0.0) - (anchor[2] or 0.0)
        if dtotal <= 0:
            return 0.0
        return (max(0.0, dbad) / dtotal) / obj.target

    # -- evaluation ----------------------------------------------------
    def evaluate(self, at: float | None = None) -> list[Alert]:
        """Walk every (objective, instance) pair's state machine at
        clock time ``at``; returns the transitions that fired (empty
        when nothing changed — re-evaluating an unchanged world is a
        no-op, which is what makes page delivery exactly-once)."""
        t = float(at) if at is not None else self._clock()
        fired: list[Alert] = []
        for (obj_name, inst), ring in sorted(self._series.items()):
            obj = next(o for o in self.objectives if o.name == obj_name)
            severity, burns, window = "ok", (0.0, 0.0), None
            for row in self.windows:
                row_sev, short_s, long_s, threshold = row
                b_short = self._burn(obj, ring, t, short_s)
                b_long = self._burn(obj, ring, t, long_s)
                if b_short > threshold and b_long > threshold:
                    severity, burns, window = row_sev, (b_short, b_long), row
                    break  # windows are ordered page-first
            prev = self._state.get((obj_name, inst), "ok")
            if severity == prev:
                continue
            self._state[(obj_name, inst)] = severity
            alert = Alert(objective=obj_name, instance=inst,
                          severity=severity, previous=prev,
                          burn_short=burns[0], burn_long=burns[1],
                          window=window if window is not None
                          else self.windows[0], at=t)
            self.alerts.append(alert)
            fired.append(alert)
            if severity == "page" and self.on_page is not None:
                self.on_page(alert)
            elif severity == "warn" and self.on_warn is not None:
                self.on_warn(alert)
        return fired

    def state(self, objective: str, instance: str) -> str:
        return self._state.get((objective, instance), "ok")

    def states(self) -> dict[str, str]:
        return {f"{o}/{i}": s for (o, i), s in sorted(self._state.items())}


# ------------------------------------------- federation objectives ----
def federation_round_latency_objective(
        name: str = "fed-round-latency", threshold_s: float = 2.5,
        target: float = 0.05) -> Objective:
    """Round-trip latency objective over a federation party's
    ``dpcorr_federation_round_latency_seconds`` histogram: a round is
    *bad* above ``threshold_s`` (which must be an exact
    ``LATENCY_BUCKETS`` bound), ``target`` is the tolerated bad
    fraction. Feed the party scrapes (``--obs-port``) to a
    :class:`BurnRateEngine` with :func:`http_trigger_hook` pointed at
    the same ports and a page dumps the *offending party's* flight
    recorder, in-process."""
    return Objective(
        name=name, kind="latency", target=target,
        histogram="dpcorr_federation_round_latency_seconds",
        threshold_s=threshold_s)


def federation_eps_burn_objectives(plan, makespan_s: float,
                                   target: float = 1.0) -> tuple:
    """One ε-burn-vs-plan-share objective per federation party: party
    P's sustainable rate is its :meth:`FederationPlan.party_eps` share
    spread over ``makespan_s`` (the matrix duration the schedule is
    sized for), so burn rate 1.0 means "spending exactly the plan
    share, on schedule" and a party re-charging artifacts or running
    ahead of plan pages. Each party process only exposes its *own*
    ``dpcorr_federation_ledger_spent_eps`` gauge, so evaluate each
    objective against its matching instance — pair alerts on
    ``alert.objective.endswith(alert.instance)`` or run one engine per
    party."""
    if makespan_s <= 0:
        raise ValueError(f"makespan_s must be > 0, got {makespan_s}")
    shares = plan.party_eps()
    return tuple(
        Objective(name=f"fed-eps-burn-{party}", kind="eps_burn",
                  target=target,
                  eps_series="dpcorr_federation_ledger_spent_eps",
                  eps_per_s=shares[party] / makespan_s)
        for party, _cols in plan.parties if shares[party] > 0)


# --------------------------------------------- stream objectives ----
def stream_release_latency_objective(
        name: str = "stream-release-latency", threshold_s: float = 1.0,
        target: float = 0.05) -> Objective:
    """Release-latency objective over a stream instance's
    ``dpcorr_stream_release_seconds`` histogram: a window release is
    *bad* above ``threshold_s`` (which must be an exact
    ``LATENCY_BUCKETS`` bound — cumulative buckets only answer
    exact-bound questions), ``target`` the tolerated bad fraction.
    Scrape the stream's ``--obs-port`` into the same
    :class:`BurnRateEngine` as serve and federation; a page through
    :func:`http_trigger_hook` dumps the stream's own flight
    recorder."""
    return Objective(
        name=name, kind="latency", target=target,
        histogram="dpcorr_stream_release_seconds",
        threshold_s=threshold_s)


def stream_watermark_lag_objective(
        name: str = "stream-watermark-lag", max_lag_s: float = 30.0,
        target: float = 1.0) -> Objective:
    """Freshness objective over ``dpcorr_stream_watermark_lag_seconds``
    (the gauge :mod:`dpcorr_torch.stream.service` publishes alongside the
    absolute watermark — lag, not position, is what an SLO can
    threshold). ``max_lag_s × target`` is the lag *budget*: the burn
    rate is the worst lag observed in each evaluation window divided
    by that budget, so with the default multi-window thresholds a page
    means the watermark sustained ≥14.4× its budget in both windows —
    size ``max_lag_s`` as the budget, not as the page line."""
    return Objective(
        name=name, kind="gauge", target=target, threshold_s=max_lag_s,
        gauge_series="dpcorr_stream_watermark_lag_seconds")


# ------------------------------------------------- recorder arming ----
def recorder_trigger_hook(**extra) -> Callable[[Alert], None]:
    """In-process page hook: dump the installed flight recorder with
    reason ``slo_page`` (the recorder's existing trigger indirection —
    a no-op when none is armed, like every other trigger site)."""
    def hook(alert: Alert) -> None:
        from dpcorr_torch.obs import recorder as obs_recorder

        obs_recorder.trigger("slo_page", objective=alert.objective,
                             instance=alert.instance,
                             burn_short=alert.burn_short,
                             burn_long=alert.burn_long, **extra)
    return hook


def http_trigger_hook(urls: Mapping[str, str],
                      timeout_s: float = 5.0) -> Callable[[Alert], None]:
    """Cross-process page hook for the fleet collector: POST the page
    to the *offending* instance's ``/obs/trigger`` endpoint, which
    calls that process's own ``recorder.trigger("slo_page", ...)`` —
    the dump happens inside the instance, next to its rings. Never
    raises (an unreachable instance is already the incident)."""
    def hook(alert: Alert) -> None:
        base = urls.get(alert.instance)
        if base is None:
            return
        body = json.dumps({
            "reason": "slo_page",
            "detail": {"objective": alert.objective,
                       "instance": alert.instance,
                       "burn_short": alert.burn_short,
                       "burn_long": alert.burn_long},
        }).encode()
        req = urllib.request.Request(
            f"{base.rstrip('/')}/obs/trigger", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s):
                pass
        except (urllib.error.URLError, OSError):
            pass
    return hook
