"""Continuous SLO monitoring: declarative objectives, sliding windows,
multi-window burn-rate alerts.

An :class:`Objective` states a service-level contract over the request
stream in ONE of three vocabularies (docs/observability.md "SLO
monitor"):

* ``latency`` — at most ``budget`` of requests may take longer than
  ``threshold_s`` end-to-end (``p95 <= 2.5s`` is spelled "budget 0.05
  over threshold 2.5" — the quantile contract in its countable form);
* ``error`` — at most ``budget`` of requests may fail (any honest
  error response: ``invalid`` / ``overloaded`` / ``internal`` / ...);
* ``failover`` — at most ``budget`` of requests may need a failover
  re-route (the fleet's churn signal: a rising failover rate means
  members are dying faster than the ring re-balances).

:class:`SloMonitor` evaluates the objectives continuously over a
sliding window of per-request samples fed by the fleet router
(``fleet/router.py`` — every terminal ``solve()`` outcome, success or
rejection, is one sample).  Alerting is MULTI-WINDOW BURN RATE, the
SRE-workbook shape: ``burn = bad_fraction / budget`` measured over both
a slow window (``window_s``) and a fast window (``fast_window_s``); an
objective alerts only when BOTH burns exceed ``burn_alert`` — the slow
window keeps one transient spike from paging, the fast window ends the
alert promptly once the bleeding stops.  Alert STATE TRANSITIONS
(firing and resolving both) are first-class recorder events
(``slo_alert``) and bump the ``slo_alerts`` counter
(``obs/counters.py`` SLO_KEYS); the continuous values render as
``br_slo_*`` gauges appended to the router ``/metrics``
(:meth:`SloMonitor.prometheus`).

:func:`evaluate_traces` is the same arithmetic over STITCHED fleet
traces (``obs.stitch``) — the offline surface the JAX package's
``scripts/obs_slo.py --gate`` checks against a banked baseline in CI,
turning the latency
baselines from a post-hoc diff into a live contract.

Port of ``batchreactor_tpu/obs/slo.py``.  Pure stdlib — the SLO plane
rides the router, which touches no device, and must keep
evaluating when every device is wedged.
"""

import threading
import time
from collections import deque

from .export import _metric

#: schema version riding ``slo_alert`` events and the gate summary —
#: bump on any layout change
SLO_VERSION = 1

#: the objective vocabulary (module doc)
OBJECTIVE_KINDS = ("latency", "error", "failover")


class Objective:
    """One declarative objective (module doc): ``budget`` is the
    allowed BAD fraction of requests in a window; ``latency``
    objectives additionally carry the ``threshold_s`` a request must
    beat to count as good.  Loud on every malformed field — a silently
    ignored objective is an SLO that never pages."""

    __slots__ = ("name", "kind", "budget", "threshold_s")

    def __init__(self, name, kind, budget, threshold_s=None):
        if not isinstance(name, str) or not name:
            raise ValueError(f"objective name must be a non-empty "
                             f"string; got {name!r}")
        if kind not in OBJECTIVE_KINDS:
            raise ValueError(f"objective {name!r}: unknown kind "
                             f"{kind!r}; vocabulary: {OBJECTIVE_KINDS}")
        budget = float(budget)
        if not 0.0 < budget < 1.0:
            raise ValueError(f"objective {name!r}: budget must be a "
                             f"fraction in (0, 1); got {budget!r}")
        if kind == "latency":
            if threshold_s is None or float(threshold_s) <= 0.0:
                raise ValueError(
                    f"objective {name!r}: latency objectives need "
                    f"threshold_s > 0; got {threshold_s!r}")
            threshold_s = float(threshold_s)
        elif threshold_s is not None:
            raise ValueError(
                f"objective {name!r}: threshold_s only applies to "
                f"latency objectives (kind is {kind!r})")
        self.name = name
        self.kind = kind
        self.budget = budget
        self.threshold_s = threshold_s

    def bad(self, latency_s, ok, failover):
        """Is one ``(latency_s, ok, failover)`` sample BAD under this
        objective?  (A failed request counts against a latency
        objective only through the error objective — its latency is
        the rejection's, not a solve's.)"""
        if self.kind == "latency":
            return bool(ok) and float(latency_s) > self.threshold_s
        if self.kind == "error":
            return not ok
        return bool(failover)

    def describe(self):
        """JSON-able self-description (the gate summary / healthz
        block)."""
        d = {"kind": self.kind, "budget": self.budget}
        if self.threshold_s is not None:
            d["threshold_s"] = self.threshold_s
        return d


#: the router's default contract (the JAX package's scripts/obs_slo.py
#: --gate checks the
#: same three against the banked baseline): p95 end-to-end under 2.5 s,
#: <=1% errors, <=5% failovers
DEFAULT_OBJECTIVES = (
    Objective("latency_p95", "latency", budget=0.05, threshold_s=2.5),
    Objective("error_rate", "error", budget=0.01),
    Objective("failover_rate", "failover", budget=0.05),
)


class SloMonitor:
    """Module doc: the continuous evaluator.  Thread-safe — ``record``
    runs on router handler threads, ``prometheus`` on the scrape
    thread (``fleet/router.py`` ``_BRLINT_THREAD_ENTRIES``)."""

    def __init__(self, objectives=None, *, window_s=300.0,
                 fast_window_s=30.0, burn_alert=2.0, recorder=None):
        objs = tuple(DEFAULT_OBJECTIVES if objectives is None
                     else objectives)
        if not objs:
            raise ValueError("SloMonitor needs at least one objective")
        names = [o.name for o in objs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        for o in objs:
            if not isinstance(o, Objective):
                raise ValueError(f"objectives must be Objective "
                                 f"instances; got {type(o).__name__}")
        self.objectives = objs
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s)
        if not 0.0 < self.fast_window_s < self.window_s:
            raise ValueError(
                f"fast_window_s ({self.fast_window_s}) must sit inside "
                f"window_s ({self.window_s}) — multi-window burn needs "
                f"two distinct horizons")
        self.burn_alert = float(burn_alert)
        if self.burn_alert <= 0.0:
            raise ValueError(f"burn_alert must be > 0; got "
                             f"{self.burn_alert!r}")
        self.recorder = recorder
        self._lock = threading.Lock()
        self._samples = deque()   # (at, latency_s, ok, failover)
        self._alerting = {o.name: False for o in objs}

    # ---- feeding -----------------------------------------------------------
    def record(self, latency_s, ok=True, failover=False, at=None):
        """Fold one terminal request outcome into the window."""
        at = time.time() if at is None else float(at)
        with self._lock:
            self._samples.append((at, float(latency_s), bool(ok),
                                  bool(failover)))
            self._trim_locked(at)

    def _trim_locked(self, now):
        floor = now - self.window_s
        while self._samples and self._samples[0][0] < floor:
            self._samples.popleft()

    # ---- evaluation --------------------------------------------------------
    def evaluate(self, now=None):
        """Evaluate every objective over both windows; emit
        ``slo_alert`` events / ``slo_alerts`` counters on state
        transitions.  Returns ``{name: {requests, bad, bad_fraction,
        burn, fast: {...}, alerting}}``."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self._trim_locked(now)
            samples = list(self._samples)
        fast_floor = now - self.fast_window_s
        out = {}
        transitions = []
        for o in self.objectives:
            slow = self._window_stats(o, samples)
            fast = self._window_stats(
                o, [s for s in samples if s[0] >= fast_floor])
            alerting = (slow["requests"] > 0 and fast["requests"] > 0
                        and slow["burn"] >= self.burn_alert
                        and fast["burn"] >= self.burn_alert)
            with self._lock:
                was = self._alerting[o.name]
                self._alerting[o.name] = alerting
            if alerting != was:
                transitions.append((o, alerting, slow, fast))
            out[o.name] = {**o.describe(), **slow, "fast": fast,
                           "alerting": alerting}
        rec = self.recorder
        if rec is not None:
            for o, firing, slow, fast in transitions:
                rec.counter("slo_alerts")
                rec.event("slo_alert", v=SLO_VERSION, objective=o.name,
                          state=("firing" if firing else "resolved"),
                          burn=slow["burn"], burn_fast=fast["burn"],
                          bad_fraction=slow["bad_fraction"],
                          budget=o.budget)
        return out

    @staticmethod
    def _window_stats(objective, samples):
        n = len(samples)
        bad = sum(1 for at, lat, ok, fo in samples
                  if objective.bad(lat, ok, fo))
        frac = (bad / n) if n else 0.0
        return {"requests": n, "bad": bad,
                "bad_fraction": round(frac, 6),
                "burn": round(frac / objective.budget, 6)}

    # ---- exposition --------------------------------------------------------
    def prometheus(self, now=None):
        """The ``br_slo_*`` gauge families the router appends to its
        ``/metrics`` (rendered with ``obs.export._metric`` — the same
        escaping/ordering every exposition family shares)."""
        results = self.evaluate(now)
        lines = []
        _metric(lines, "br_slo_requests", "gauge",
                "Requests in the SLO sliding window, per horizon.",
                [({"window": "slow"},
                  next(iter(results.values()))["requests"]),
                 ({"window": "fast"},
                  next(iter(results.values()))["fast"]["requests"])])
        _metric(lines, "br_slo_bad_fraction", "gauge",
                "Fraction of windowed requests violating each "
                "objective.",
                [({"objective": name, "window": w},
                  (r if w == "slow" else r["fast"])["bad_fraction"])
                 for name, r in sorted(results.items())
                 for w in ("slow", "fast")])
        _metric(lines, "br_slo_burn_rate", "gauge",
                "Error-budget burn rate (bad_fraction / budget) per "
                "objective and window; sustained > burn_alert on both "
                "windows fires the alert.",
                [({"objective": name, "window": w},
                  (r if w == "slow" else r["fast"])["burn"])
                 for name, r in sorted(results.items())
                 for w in ("slow", "fast")])
        _metric(lines, "br_slo_alert", "gauge",
                "1 while the objective's multi-window burn alert is "
                "firing.",
                [({"objective": name}, int(r["alerting"]))
                 for name, r in sorted(results.items())])
        return "\n".join(lines) + ("\n" if lines else "")


def evaluate_traces(traces, objectives=None):
    """The monitor's arithmetic over STITCHED traces (``obs.stitch``) —
    one offline pass, no windows (a banked CI run is one window).
    Returns ``{name: {kind, budget[, threshold_s], requests, bad,
    bad_fraction, burn, ok}}`` — ``ok`` is the plain budget check
    the JAX package's ``scripts/obs_slo.py --gate`` turns into an exit code."""
    objs = tuple(DEFAULT_OBJECTIVES if objectives is None
                 else objectives)
    out = {}
    for o in objs:
        if not isinstance(o, Objective):
            raise ValueError(f"objectives must be Objective instances; "
                             f"got {type(o).__name__}")
        n = bad = 0
        for t in traces:
            lat = t.get("total_s")
            if lat is None:
                continue
            ok = not t.get("failed") and t.get("code") is None
            n += 1
            if o.bad(lat, ok, bool(t.get("failover"))):
                bad += 1
        frac = (bad / n) if n else 0.0
        out[o.name] = {**o.describe(), "requests": n, "bad": bad,
                       "bad_fraction": round(frac, 6),
                       "burn": round(frac / o.budget, 6),
                       "ok": frac <= o.budget}
    return out
