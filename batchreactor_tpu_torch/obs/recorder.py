"""Host-side span tracing: the :class:`Recorder`.

Port of ``batchreactor_tpu/obs/recorder.py`` (same records, same
snapshot shapes).

A Recorder collects three record kinds:

* **spans** — nested wall-clock intervals with a name, slash-joined path
  (``solve/segment``), depth, wall-clock ``start`` (unix seconds),
  monotonic ``dur`` (``time.perf_counter`` difference), and free-form
  JSON-able attributes.  Spans nest per *thread* (the checkpoint writer's
  background save thread records its spans at root depth, interleaved by
  start time), and timings are host wall-clock: callers timing device
  work pass ``block=<tensors>`` so the span waits for the card before its
  clock stops — through ``solver/graphs.py``'s choke point
  (:func:`~..solver.graphs.block`), which counts the wait as a host sync
  and honours ``fetch_deadline``.
* **events** — zero-duration points (a retrace warning, a chunk load).
* **counters** — monotonically accumulated named floats (bytes written,
  segments launched).
* **histograms** — labeled distributions over the FIXED log-spaced
  bucket ladder ``obs.counters.HIST_BUCKET_EDGES``
  (:meth:`Recorder.observe`): per-request latency stages land here
  (``serve_stage_seconds{stage=}``) instead of as lying summed
  counters; the report carries them in its ``histograms`` section and
  ``obs.export`` renders the Prometheus ``_bucket``/``_sum``/``_count``
  exposition.

The Recorder touches no device and is safe to create on hosts with no
usable accelerator.  All appends are lock-guarded so worker threads (checkpoint saves, compile
listeners) can emit concurrently with the main thread.
"""

import contextlib
import threading
import time


@contextlib.contextmanager
def null_span(*_args, **_kwargs):
    """Stand-in for ``Recorder.span`` when no recorder is wired: yields a
    throwaway dict so call sites can unconditionally read ``span["dur"]``
    (it stays ``None``)."""
    yield {"name": None, "dur": None, "attrs": {}}


def span_or_null(recorder, name, block=None, **attrs):
    """``recorder.span(...)`` when a recorder is present, else
    :func:`null_span` — the one-liner every optionally-instrumented call
    site uses instead of an if/else."""
    if recorder is None:
        return null_span()
    return recorder.span(name, block=block, **attrs)


class Recorder:
    """Collects nested spans, point events, and counters (module doc)."""

    def __init__(self):
        # REENTRANT: the flight recorder's SIGTERM hook (obs/live.py)
        # runs on the main thread and snapshots this recorder — if the
        # signal lands while the interrupted frame already holds the
        # lock (a counter() mid-update), a plain Lock would deadlock
        # the teardown the dump exists to capture
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._seq = 0
        self.spans = []     # append order = start order (per the lock)
        self.events = []
        self.counters = {}
        self.histograms = {}   # name -> {label-items tuple -> hist dict}
        #: optional observer ``tap(kind, record)`` called (outside the
        #: lock) once per COMPLETED span, event, and counter update —
        #: the flight recorder's attachment point (obs/live.py); must be
        #: cheap and must not call back into this recorder
        self.tap = None

    # ---- spans ------------------------------------------------------------
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name, block=None, **attrs):
        """Context manager recording one span; yields the (mutable) span
        record so callers can read ``span["dur"]`` after the block or add
        attributes from inside it.  ``block=<tensors>`` (a tensor or a nest
        of them) waits for the card before the clock stops, so device work
        launched inside the span is charged to it."""
        stack = self._stack()
        path = "/".join([s["name"] for s in stack] + [name])
        rec = {"name": name, "path": path, "depth": len(stack),
               "start": time.time(), "dur": None, "attrs": dict(attrs)}
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self.spans.append(rec)
        stack.append(rec)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            if block is not None:
                from ..solver import graphs

                graphs.block(block)
            rec["dur"] = time.perf_counter() - t0
            stack.pop()
            tap = self.tap   # local snapshot: a concurrent disarm may
            if tap is not None:   # null the attribute between the
                tap("span", dict(rec))   # check and the call

    # ---- events & counters ------------------------------------------------
    def event(self, name, **attrs):
        """Record a point event (e.g. ``retrace``, ``chunk_loaded``)."""
        rec = {"name": name, "time": time.time(), "attrs": dict(attrs)}
        with self._lock:
            self.events.append(rec)
        tap = self.tap
        if tap is not None:
            tap("event", dict(rec))

    def counter(self, name, value=1):
        """Accumulate ``value`` onto the named counter."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value
            total = self.counters[name]
        tap = self.tap
        if tap is not None:
            tap("counter", {"name": name, "value": value,
                            "total": total})

    def observe(self, name, value, **labels):
        """Fold one observation into the named histogram (fixed
        log-spaced buckets — ``obs.counters.HIST_BUCKET_EDGES``);
        ``labels`` select the series within the family (e.g.
        ``observe("serve_stage_seconds", dur, stage="coalesced")``)."""
        from . import counters as C

        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self.histograms.setdefault(name, {})
            ser = fam.get(key)
            if ser is None:
                ser = fam[key] = C.hist_new()
            C.hist_observe(ser, value)
        tap = self.tap
        if tap is not None:
            tap("histogram", {"name": name, "labels": dict(labels),
                              "value": value})

    # ---- views ------------------------------------------------------------
    def by_name(self):
        """Aggregate spans by *name* -> ``{"total_s", "count"}`` (the
        Phases-compatible view: repeated spans accumulate)."""
        agg = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            if s["dur"] is None:
                continue
            a = agg.setdefault(s["name"], {"total_s": 0.0, "count": 0})
            a["total_s"] += s["dur"]
            a["count"] += 1
        return agg

    def summary(self):
        """``{name: total_seconds}`` over completed spans."""
        return {k: v["total_s"] for k, v in self.by_name().items()}

    def pretty(self):
        """Phases-style per-name breakdown, largest first, with call
        counts."""
        agg = self.by_name()
        total = sum(v["total_s"] for v in agg.values()) or 1.0
        lines = [
            f"{name:>12s}: {v['total_s']:8.3f}s  "
            f"({100.0 * v['total_s'] / total:5.1f}%)  x{v['count']}"
            for name, v in sorted(agg.items(),
                                  key=lambda kv: -kv[1]["total_s"])
        ]
        return "\n".join(lines)

    def snapshot(self):
        """Copies of (spans, events, counters) safe to serialize while
        other threads keep recording.  (Histograms have their own
        :meth:`hist_snapshot` — the 3-tuple shape predates them and is
        consumed positionally all over the live plane.)"""
        with self._lock:
            return ([dict(s) for s in self.spans],
                    [dict(e) for e in self.events],
                    dict(self.counters))

    def hist_snapshot(self):
        """Report-shaped histogram copies: ``{name: [{"labels", "counts",
        "sum", "count"}, ...]}``, series sorted by label items — the
        ``build_report`` ``histograms`` section."""
        with self._lock:
            return {name: [{"labels": dict(key),
                            "counts": list(ser["counts"]),
                            "sum": ser["sum"], "count": ser["count"]}
                           for key, ser in sorted(fam.items())]
                    for name, fam in sorted(self.histograms.items())}
