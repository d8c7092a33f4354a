"""Deterministic fault injection, test-only
(``batchreactor_tpu/resilience/inject.py``: the same spec grammar and the
same ``BR_FAULT_INJECT`` variable).

Every recovery path of the resilience layer is exercised by *simulating*
the fault classes at exact, reproducible points (no timing races, no real
wedges):

``hang_fetch[:delay=S][,count=N]``
    the next deadline-guarded device wait is held back ``S`` seconds
    (default 30) inside the guarded wait (``watchdog._guarded_wait``), so
    the deadline breach fires for real.
``kill[:chunk=I]``
    the process ``os._exit(137)``s immediately before saving chunk ``I``
    (the SIGKILLed-process scenario): the chunk file stays missing and its
    claim goes stale, which is what the elastic reassignment keys on.
``corrupt_chunk[:chunk=I]``
    chunk ``I``'s ``.npz`` is truncated to half its bytes right after the
    (atomic) save completes: the torn file resume must survive.
``nan_lane[:lane=I]``
    global lane ``I``'s result is poisoned after its chunk solve (``y ->
    NaN``, ``status -> DT_UNDERFLOW``): the numerical blowup the
    quarantine re-solves.
``slow_request[:delay=S][,request=ID][,count=N]``
    parsed for the serving scheduler, which the port does not have yet
    (ROADMAP A15): nothing consumes it.

Plans arm from ``BR_FAULT_INJECT`` (semicolon-separated specs, parsed
once on first use) or programmatically via :func:`arm`; each spec fires
``count`` times (default 1) and then stays quiet, which is what makes
"retry succeeds after the injected failure" deterministic.  Every hook is
a cheap no-op when nothing is armed."""

import os
import sys
import threading

_lock = threading.Lock()
_plans = None   # None = BR_FAULT_INJECT not parsed yet; [] = armed empty


class _Plan:
    __slots__ = ("kind", "params", "count", "fired")

    def __init__(self, kind, params):
        self.kind = kind
        self.params = params
        self.count = int(params.get("count", 1))
        self.fired = 0

    def __repr__(self):
        return f"_Plan({self.kind}, {self.params}, fired={self.fired})"


_KINDS = ("hang_fetch", "kill", "corrupt_chunk", "nan_lane",
          "slow_request")


def _parse(spec):
    plans = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in "
                             f"BR_FAULT_INJECT; known: {_KINDS}")
        params = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            if not _ or not k:
                raise ValueError(f"malformed fault param {kv!r} in "
                                 f"{part!r} (expected key=value)")
            params[k.strip()] = v.strip()
        plans.append(_Plan(kind, params))
    return plans


def arm(spec):
    """Arm a plan set from a spec string (replaces any armed plans)."""
    global _plans
    with _lock:
        _plans = _parse(spec)


def disarm():
    """Drop every armed plan (tests call this in teardown)."""
    global _plans
    with _lock:
        _plans = []


def active():
    """True when at least one plan still has firings left."""
    with _lock:
        plans = _get_locked()
        return any(p.fired < p.count for p in plans)


def _get_locked():
    global _plans
    if _plans is None:
        _plans = _parse(os.environ.get("BR_FAULT_INJECT", ""))
    return _plans


def _take(kind, pred=None):
    """Atomically consume one firing of the first live matching plan;
    returns its params dict, or None when nothing matches."""
    with _lock:
        for p in _get_locked():
            if p.kind != kind or p.fired >= p.count:
                continue
            if pred is not None and not pred(p.params):
                continue
            p.fired += 1
            return dict(p.params)
    return None


def _chunk_matches(params, chunk):
    return "chunk" not in params or int(params["chunk"]) == int(chunk)


# --------------------------------------------------------------------------
# hooks (called from the resilience/parallel layers; no-ops unless armed)
# --------------------------------------------------------------------------
def fetch_hang_delay():
    """Seconds the next deadline-guarded wait should sleep (0 = none)."""
    p = _take("hang_fetch")
    return float(p.get("delay", 30.0)) if p else 0.0


def kill_now(chunk):
    """``os._exit(137)`` if a ``kill`` plan targets this chunk — the
    un-catchable-death simulation (finally blocks and atexit do NOT run,
    exactly like SIGKILL)."""
    p = _take("kill", lambda prm: _chunk_matches(prm, chunk))
    if p is not None:
        print(f"[inject] kill before saving chunk {chunk} (pid "
              f"{os.getpid()})", file=sys.stderr, flush=True)
        sys.stderr.flush()
        os._exit(137)


def corrupt_path(path, chunk):
    """Truncate ``path`` to half its size if a ``corrupt_chunk`` plan
    targets this chunk; returns True when it fired."""
    p = _take("corrupt_chunk", lambda prm: _chunk_matches(prm, chunk))
    if p is None:
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(1, size // 2))
    print(f"[inject] corrupted chunk file {path} ({size} -> "
          f"{max(1, size // 2)} bytes)", file=sys.stderr, flush=True)
    return True


def poison_lanes(res, lane_lo, lane_hi):
    """Poison every armed ``nan_lane`` target inside the global lane
    range [lane_lo, lane_hi): final state -> NaN, status ->
    DT_UNDERFLOW.  Returns the (possibly replaced) SolveResult."""
    import dataclasses

    poisoned = []
    while True:
        p = _take("nan_lane", lambda prm: ("lane" in prm and lane_lo
                                           <= int(prm["lane"]) < lane_hi))
        if p is None:
            break
        poisoned.append(int(p["lane"]) - lane_lo)
    if not poisoned:
        return res
    from ..solver.common import DT_UNDERFLOW

    y, status = res.y.clone(), res.status.clone()
    for i in poisoned:
        y[i] = float("nan")
        status[i] = DT_UNDERFLOW
    print(f"[inject] poisoned lane(s) "
          f"{[lane_lo + i for i in poisoned]} (NaN blowup simulation)",
          file=sys.stderr, flush=True)
    return dataclasses.replace(res, y=y, status=status)
