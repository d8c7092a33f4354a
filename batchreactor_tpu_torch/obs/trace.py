"""Request-lifecycle tracing: the :class:`RequestTrace` record.

One trace per served request, capturing WHERE the wall-clock went as a
sequence of monotonic stage marks over a fixed vocabulary
(:data:`STAGES`)::

    submitted -> coalesced -> admitted -> first_harvest -> resolved
                                            (+ stalled)

* ``submitted`` — the scheduler accepted the request into its queue
  (``serving/scheduler.py`` ``Scheduler.submit``);
* ``coalesced`` — the request left the queue into an epoch: the
  coalescing window over which it waited closed (``_pop_work_locked``),
  so ``submitted -> coalesced`` is queue wait + coalesce delay +
  cross-pack-key admission wait;
* ``admitted`` — the request's lanes joined the resident stream's
  backlog (the epoch gid map): from here the device is working on it;
* ``first_harvest`` — the FIRST of the request's lanes harvested
  (idempotent: an out-of-order harvest marks once), so
  ``admitted -> first_harvest`` is resident solve time to first
  result and ``first_harvest -> resolved`` is the harvest tail;
* ``stalled`` — only under the injected ``slow_request`` fault
  (``resilience/inject.py``): the stall begins here, so
  ``stalled -> resolved`` carries the injected delay;
* ``resolved`` — the future resolved (or failed): the client-visible
  end of the server-side latency.

Marks are ``time.perf_counter`` instants recorded in causal order by
the scheduler, so per-request stage offsets are monotone by
construction; :meth:`RequestTrace.mark` is idempotent (first mark
wins — the ``first_harvest`` contract) and loud on an unknown stage.
Capture is lock-cheap: one clock read + one dict store per stage, no
locks of its own (each trace is touched by the submitting thread once
and the scheduler worker thereafter).

Exports (docs/observability.md "Request tracing"):

* **response JSON** — behind the versioned ``trace=`` request key
  (``serving/schema.py``): :meth:`to_payload` is the ``"trace"``
  section of an ``ok`` response;
* **recorder JSONL** — every resolved request emits a
  ``request_trace`` event (:meth:`to_attrs`) on the session recorder,
  so the daemon's obs report (``tools/serve.py --obs-out``) carries
  per-request waterfalls the JAX package's ``scripts/obs_trace.py``
  renders;
* **histograms** — the per-stage durations (:meth:`segments`) feed the
  ``serve_stage_seconds`` histogram family (``obs/counters.py``), the
  ``br_serve_stage_seconds{stage=}`` exposition a mid-flight
  ``/metrics`` scrape shows moving.

Port of ``batchreactor_tpu/obs/trace.py``: the same stage vocabulary
and payload schema, so either package's tools read either's traces.
Nothing here imports torch or numpy — the trace plane is pure stdlib,
shared by the scheduler, the schema layer, and the render CLI.
"""

import time

#: the trace schema version riding every exported payload (response
#: JSON and recorder events) — bump on any vocabulary/layout change
TRACE_VERSION = 1

#: the fixed stage vocabulary in causal order (module doc); ``stalled``
#: appears only when the ``slow_request`` fault injection fired
STAGES = ("submitted", "coalesced", "admitted", "first_harvest",
          "resolved")
#: fault-only stages and their position: ``stalled`` sits between
#: ``first_harvest`` and ``resolved``
FAULT_STAGES = ("stalled",)
#: full mark ordering (vocabulary + fault stages interleaved)
STAGE_ORDER = ("submitted", "coalesced", "admitted", "first_harvest",
               "stalled", "resolved")

_STAGE_SET = frozenset(STAGE_ORDER)


class RequestTrace:
    """One request's lifecycle record (module doc): id, pack key, lane
    span, and monotonic stage marks.  Constructing the trace marks
    ``submitted``."""

    __slots__ = ("request_id", "pack_key", "lanes", "wall_start",
                 "marks", "trace_id", "parent_span", "hop")

    def __init__(self, request_id, pack_key=None, lanes=1):
        self.request_id = str(request_id)
        self.pack_key = pack_key
        self.lanes = int(lanes)
        self.wall_start = time.time()
        self.marks = {"submitted": time.perf_counter()}
        # distributed-trace identity (docs/observability.md "Fleet
        # tracing"): unset until adopt() — a ctx-less request exports
        # exactly the pre-fleet attribute set (byte-identity contract)
        self.trace_id = None
        self.parent_span = None
        self.hop = 0

    def adopt(self, trace_id, parent_span=None, hop=0):
        """Adopt an inherited trace context (``serving/schema.py``
        ``trace_ctx``): this request's stage marks become child spans
        of the fleet-wide trace ``trace_id`` under ``parent_span``
        (the forwarding router's span), ``hop`` forwards deep.  Loud
        on an empty id — a silently dropped identity would orphan the
        member's half of a stitched waterfall."""
        if not trace_id:
            raise ValueError(
                f"trace adoption needs a non-empty trace id; got "
                f"{trace_id!r}")
        self.trace_id = str(trace_id)
        self.parent_span = (None if parent_span is None
                            else str(parent_span))
        self.hop = int(hop)
        return self

    def mark(self, stage, at=None):
        """Record ``stage`` at ``time.perf_counter()`` (or ``at``).
        Idempotent — the first mark wins, which is what makes
        ``first_harvest`` mean FIRST under out-of-order harvest — and
        loud on a stage outside :data:`STAGE_ORDER`."""
        if stage not in _STAGE_SET:
            raise ValueError(f"unknown trace stage {stage!r}; "
                             f"vocabulary: {STAGE_ORDER}")
        if stage in self.marks:
            return False
        self.marks[stage] = time.perf_counter() if at is None else at
        return True

    def at(self, stage):
        """The raw ``perf_counter`` instant of a marked stage (None
        when unmarked)."""
        return self.marks.get(stage)

    def stages(self):
        """``{stage: offset_s}`` — marked stages as offsets from
        ``submitted``, in :data:`STAGE_ORDER` order."""
        t0 = self.marks["submitted"]
        return {s: self.marks[s] - t0 for s in STAGE_ORDER
                if s in self.marks}

    def segments(self):
        """``{stage: duration_s}`` between consecutive MARKED stages,
        keyed by the destination stage — ``{"coalesced": queue wait,
        "first_harvest": resident solve, ...}`` (module doc reading).
        Monotone marks make every duration >= 0."""
        marked = [s for s in STAGE_ORDER if s in self.marks]
        out = {}
        for prev, cur in zip(marked, marked[1:]):
            out[cur] = self.marks[cur] - self.marks[prev]
        return out

    def total_s(self):
        """``submitted -> resolved`` seconds (the server-side request
        latency); falls back to the latest mark while unresolved."""
        t0 = self.marks["submitted"]
        if "resolved" in self.marks:
            return self.marks["resolved"] - t0
        return max(self.marks.values()) - t0

    # ---- exports ----------------------------------------------------------
    def to_payload(self):
        """The response-JSON ``"trace"`` section (``trace=true``
        requests — docs/serving.md): versioned, stage offsets +
        per-segment durations in seconds."""
        return {"v": TRACE_VERSION,
                "stages": {s: round(v, 6)
                           for s, v in self.stages().items()},
                "segments": {s: round(v, 6)
                             for s, v in self.segments().items()},
                "total_s": round(self.total_s(), 6),
                "lanes": self.lanes}

    def to_attrs(self):
        """The ``request_trace`` recorder-event attributes (the JSONL
        export): the payload plus identity — request id, pack key, and
        the wall-clock submit instant (events carry their own emit
        time; this one is the request's).  An adopted trace context
        adds the fleet identity (``trace``/``parent_span``/``hop`` —
        the ``obs.stitch`` join keys); ctx-less traces export exactly
        the pre-fleet attribute set (byte-identity contract)."""
        attrs = {"request": self.request_id,
                 "pack": (None if self.pack_key is None
                          else list(self.pack_key)),
                 "wall_start": round(self.wall_start, 6),
                 **self.to_payload()}
        if self.trace_id is not None:
            attrs["trace"] = self.trace_id
            attrs["parent_span"] = self.parent_span
            attrs["hop"] = self.hop
        return attrs
