"""The coalescer: a thread-safe request queue feeding resident streams.

Requests land here (:meth:`Scheduler.submit`) from any number of
front-end threads, are grouped by *pack key* ``(t1, rtol, atol,
energy)`` — ``t1`` and the conditions are traced operands of one shared
program; ``rtol``/``atol``/``energy`` are static and therefore a
distinct compiled program (an energy lane's state is one row wider) —
and are packed into the admission backlog of a resident streaming
sweep: the scheduler's worker thread runs one *epoch* per active pack
key through ``session.stream``, whose

* ``feed(n_space, idle)`` hook pulls newly-arrived requests of the same
  key INTO the live backlog (``parallel/sweep.py`` ``_feed`` contract)
  — continuous admission, the LLM-inference-server shape: a request
  arriving mid-stream rides freed lanes without a fresh dispatch;
* ``on_harvest(gids, payload)`` hook resolves each request's future the
  moment its LAST lane harvests — results are un-shuffled to request
  lane order via the gid map (the driver already un-shuffles slot ->
  global-index; the scheduler maps global index -> (request, offset)).

An epoch ends when its feed goes idle past ``idle_timeout_s`` (the
resident program is released; the next request replays the session's
warmed graphs at zero captures), when a different pack key has work
waiting (fairness rotation), or at drain.

**Multi-epoch capacity** (``SessionSpec.resident_epochs`` — docs/
serving.md "Capacity levers"): with ``resident_epochs=N`` the scheduler
runs N worker threads, each hosting its own resident streaming epoch,
all pulling from the ONE shared pack-key queue.  The spray is
pull-based: each epoch's seed/feed pops up to its own free-slot depth
under the scheduler lock, so pops are disjoint and exactly-once
resolution needs no new machinery — a request belongs to exactly the
epoch that popped it, and its harvest un-shuffle stays epoch-local.
Lanes a secondary epoch pulls count ``epoch_spray``; each epoch
publishes its driver gauges under its own live source (``sweep-e0``,
``sweep-e1``, ...) so per-epoch occupancy survives the registry merge.
``resident_epochs=1`` is byte-identical to the single-worker scheduler
(same thread name, same stream call signature, zero spray).

**Backpressure is explicit**: ``submit`` REJECTS with
:class:`Overloaded` once ``max_queue_lanes`` lanes are queued
(un-admitted) — never silent unbounded queueing — and with
:class:`Draining` after :meth:`drain` began; accepted requests are
always answered exactly once (drain finishes the backlog first, and a
dead stream resolves its requests with ``internal`` errors rather than
dropping them).

**Request-lifecycle tracing** (obs/trace.py — docs/observability.md
"Request tracing"): every accepted request carries a
:class:`~..obs.trace.RequestTrace` marked lock-cheaply at the points
that already exist — ``submitted`` in :meth:`Scheduler.submit`,
``coalesced`` in ``_pop_work_locked``, ``admitted`` on joining the
epoch backlog, ``first_harvest`` in the harvest hook (idempotent),
``stalled`` under the injected fault, ``resolved`` at
``_resolve``/``_fail``.  Resolution folds the per-stage durations into
the ``serve_stage_seconds`` histograms (the live ``/metrics``
decomposition), emits the ``request_trace`` JSONL event, and — past
``spec.slow_request_s`` — a structured ``slow_request`` event that
arms the flight recorder.

The module imports stdlib + numpy only (no torch): the session object
carries all device work, so the scheduler invariants are unit-testable
against a fake session (tests/test_torch_serving.py).  Port of
``batchreactor_tpu/serving/scheduler.py``, line for line.
"""

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..obs.trace import RequestTrace

#: the solvers' success status (``solver.common.SUCCESS``), kept here so
#: the scheduler imports no module that loads torch
SUCCESS = 1



class SchedulerReject(RuntimeError):
    """A request the scheduler refused; ``code`` is the response error
    code (schema.ERROR_CODES)."""

    code = "internal"


class Overloaded(SchedulerReject):
    """Queue bound reached — admission-control backpressure."""

    code = "overloaded"


class Draining(SchedulerReject):
    """The scheduler is draining (SIGTERM path): in-flight work still
    answers, new work is refused."""

    code = "draining"


@dataclasses.dataclass
class RequestResult:
    """What a request's future resolves to: per-lane arrays in REQUEST
    lane order (the harvest un-shuffle target), plus provenance and
    wall time.  ``serving/session.py render_result`` turns this into
    the response payload."""

    request: object
    t: np.ndarray
    y: np.ndarray
    status: np.ndarray
    n_accepted: np.ndarray
    n_rejected: np.ndarray
    stats: dict | None
    observed: dict | None
    provenance: list
    elapsed_s: float
    #: the request's lifecycle trace (obs/trace.py) — stage marks the
    #: scheduler captured; ``render_result`` exports it behind the
    #: request's ``trace=`` key
    trace: object = None


class _Work:
    """One accepted request in flight: its future, pre-packed lane
    blocks, per-lane result buffers, the harvest countdown, and the
    lifecycle trace (obs/trace.py — constructing it marks
    ``submitted``; the other stages mark at the existing scheduler
    points, one clock read each, no locks of their own: the trace is
    touched by the submit thread once and the worker thereafter)."""

    __slots__ = ("request", "future", "y0", "cfg", "t", "y", "status",
                 "n_acc", "n_rej", "stats", "observed", "remaining",
                 "trace", "stall_s", "seq")

    def __init__(self, request, y0, cfg, seq):
        self.request = request
        self.future = Future()
        self.y0 = y0
        self.cfg = cfg
        k = request.n_lanes
        self.t = np.full((k,), np.nan)
        self.y = np.array(y0, copy=True)
        self.status = np.full((k,), -1, dtype=np.int32)
        self.n_acc = np.zeros((k,), dtype=np.int64)
        self.n_rej = np.zeros((k,), dtype=np.int64)
        self.stats = None
        self.observed = None
        self.remaining = k
        self.trace = RequestTrace(request.id,
                                  pack_key=request.pack_key(), lanes=k)
        # inherited distributed-trace context (schema.Request
        # trace_ctx — docs/observability.md "Fleet tracing"): adopt
        # the fleet identity so this daemon's stage marks export as
        # child spans of ONE cross-host trace; getattr-gated so
        # pre-ctx request stubs (tests) keep working
        ctx = getattr(request, "trace_ctx", None)
        if ctx is not None:
            self.trace.adopt(*ctx)
        self.stall_s = 0.0
        self.seq = seq


class Scheduler:
    """Module doc.  ``session`` provides ``request_lanes`` /
    ``stream`` / ``spec`` (a real :class:`~.session.SolverSession`, or
    any stub with that surface — the invariant tests use one)."""

    def __init__(self, session, *, max_queue_lanes=None,
                 idle_timeout=None):
        self.session = session
        spec = session.spec
        self.max_queue_lanes = int(
            spec.max_queue_lanes if max_queue_lanes is None
            else max_queue_lanes)
        self.idle_timeout = float(
            spec.idle_timeout_s if idle_timeout is None else idle_timeout)
        self._cond = threading.Condition()
        self._queues = {}            # pack key -> deque[_Work]
        self._queued_lanes = 0
        self._inflight_lanes = 0
        self._draining = False
        self._closed = False
        self._seq = 0
        # capacity plane (module doc): N resident epochs, one worker
        # thread each.  The session resolves "auto" (one per local
        # device) to an int before the scheduler sees it; a stub
        # session without the knob runs single-epoch
        epochs = getattr(session, "resident_epochs", None)
        if epochs is None:
            epochs = getattr(spec, "resident_epochs", 1)
        try:
            epochs = int(epochs)
        except (TypeError, ValueError):
            epochs = 1
        self.epochs = max(epochs, 1)
        self._worker = threading.Thread(target=self._run, args=(0,),
                                        daemon=True,
                                        name="br-serve-scheduler")
        self._workers = [self._worker] + [
            threading.Thread(target=self._run, args=(k,), daemon=True,
                             name=f"br-serve-scheduler-{k}")
            for k in range(1, self.epochs)]
        self._started = False

    # ---- producer side ----------------------------------------------------
    def start(self):
        # under the lock: two front-end threads racing an unguarded
        # check-then-set could both see _started False and double-start
        # the worker (Thread.start raises RuntimeError on the loser)
        with self._cond:
            if not self._started:
                self._started = True
                for w in self._workers:
                    w.start()
        return self

    def submit(self, request):
        """Queue one validated request; returns its ``Future`` (resolves
        to a :class:`RequestResult`).  Raises :class:`Overloaded` /
        :class:`Draining` — the caller maps those onto 503 responses."""
        rec = getattr(self.session, "recorder", None)
        # pack lanes OUTSIDE the lock (y0 construction does real work);
        # an invalid composition raises here, before anything is queued
        y0, cfg = self.session.request_lanes(request)
        with self._cond:
            if self._draining or self._closed:
                if rec is not None:
                    rec.counter("serve_rejects_draining")
                raise Draining("scheduler is draining; request refused")
            if self._queued_lanes + request.n_lanes > self.max_queue_lanes:
                if rec is not None:
                    rec.counter("serve_rejects_overload")
                raise Overloaded(
                    f"admission queue full ({self._queued_lanes} + "
                    f"{request.n_lanes} lanes > bound "
                    f"{self.max_queue_lanes}); retry with backoff")
            work = _Work(request, y0, cfg, self._seq)
            self._seq += 1
            self._queues.setdefault(request.pack_key(),
                                    collections.deque()).append(work)
            self._queued_lanes += request.n_lanes
            if rec is not None:
                rec.counter("serve_requests")
                rec.counter("serve_lanes", request.n_lanes)
            self._publish_locked()
            self._cond.notify_all()
        return work.future

    def drain(self, timeout=None):
        """Stop accepting, answer everything accepted, stop the worker.
        Returns True when the queue fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if not self._started:
            # no worker ever ran: anything queued can never be served —
            # answer it loudly rather than stranding the futures
            with self._cond:
                stranded = [w for q in self._queues.values() for w in q]
                self._queues.clear()
                self._queued_lanes = 0
                self._closed = True
            for w in stranded:
                w.future.set_exception(Draining(
                    "scheduler closed before it ever started"))
            return True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for w in self._workers:
            w.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
        done = not any(w.is_alive() for w in self._workers)
        with self._cond:
            self._closed = True
        return done

    close = drain

    def depth(self):
        """(queued_lanes, inflight_lanes) — the backpressure gauges."""
        with self._cond:
            return self._queued_lanes, self._inflight_lanes

    def _publish_locked(self):
        reg = getattr(self.session, "registry", None)
        if reg is None:
            return
        reg.publish("serve", gauges={
            "serve_queue_lanes": int(self._queued_lanes),
            "serve_inflight_lanes": int(self._inflight_lanes),
            "serve_pending_requests": int(
                sum(len(q) for q in self._queues.values())),
            "serve_draining": int(self._draining),
            "resident_epochs": int(self.epochs)})

    # ---- worker side ------------------------------------------------------
    def _next_key_locked(self):
        """The pack key of the oldest queued request (FIFO fairness
        across keys), or None."""
        best = None
        for key, q in self._queues.items():
            if q and (best is None or q[0].seq < best[1]):
                best = (key, q[0].seq)
        return best[0] if best else None

    def _run(self, epoch=0):
        while True:
            with self._cond:
                key = self._next_key_locked()
                while key is None and not self._draining:
                    self._cond.wait()
                    key = self._next_key_locked()
                if key is None:       # draining and empty: done
                    self._publish_locked()
                    break
            self._run_epoch(key, epoch)
        with self._cond:
            self._publish_locked()

    def _pop_work_locked(self, key, n_space, epoch=0):
        """Pop whole queued requests of ``key`` up to ~``n_space`` lanes
        (always at least one when any is queued) — the rest stays
        QUEUED, which is what keeps the ``max_queue_lanes`` bound
        meaningful while a stream is resident.  Pops are the spray:
        each epoch pulls up to its own free-slot depth under THIS lock,
        so concurrent epochs never double-pop a request."""
        q = self._queues.get(key)
        works, lanes = [], 0
        while q and (not works or lanes + q[0].request.n_lanes
                     <= max(int(n_space), 1)):
            w = q.popleft()
            w.trace.mark("coalesced")   # left the queue into an epoch
            works.append(w)
            lanes += w.request.n_lanes
        if q is not None and not q:
            del self._queues[key]
        self._queued_lanes -= lanes
        self._inflight_lanes += lanes
        if works:
            if epoch:
                rec = getattr(self.session, "recorder", None)
                if rec is not None:
                    rec.counter("epoch_spray", lanes)
            self._publish_locked()
        return works

    def _run_epoch(self, key, epoch=0):
        """One resident stream over one pack key (module doc);
        ``epoch`` is this worker's slot in the multi-epoch spray."""
        from ..resilience import inject

        rec = getattr(self.session, "recorder", None)
        if rec is not None:
            rec.counter("serve_epochs")
        # pack key: (t1, rtol, atol) pre-energy, (t1, rtol, atol,
        # energy) since — the star-unpack keeps fake-session tests and
        # any 3-tuple producer working
        t1, rtol, atol, *rest = key
        energy = rest[0] if rest else None
        gid_map = []      # gid -> (_Work, lane offset); driver gids are
        #                   append-order over (initial backlog + feeds)
        epoch_works = []

        def _admit(works):
            for w in works:
                w.trace.mark("admitted")   # joins the resident backlog
                w.stall_s = inject.slow_request_delay(w.request.id)
                epoch_works.append(w)
                for off in range(w.request.n_lanes):
                    gid_map.append((w, off))

        def _stack(works):
            y0 = np.concatenate([w.y0 for w in works])
            cfg = {k: np.concatenate([np.asarray(w.cfg[k])
                                      for w in works])
                   for k in works[0].cfg}
            return y0, cfg

        # seed the epoch with ~one resident program's worth of lanes;
        # the rest stays queued and flows in through the feed
        cap = getattr(self.session, "bucket_cap", None)
        coalesce = float(getattr(self.session.spec, "coalesce_s", 0.0)
                         or 0.0)
        adaptive = bool(getattr(self.session.spec, "coalesce_adaptive",
                                False))
        with self._cond:
            if coalesce > 0:
                # batching window (SessionSpec.coalesce_s): give
                # concurrent arrivals a beat to fill the resident
                # program before the seed is cut — counted against
                # THIS epoch's pack key (other keys' lanes cannot ride
                # this program and must not cut its window short)
                def _key_lanes():
                    return sum(w.request.n_lanes
                               for w in self._queues.get(key, ()))

                start = time.monotonic()
                window = coalesce
                while (_key_lanes() < (cap or 1)
                       and not self._draining):
                    window = coalesce
                    if adaptive:
                        # the adaptive window (SessionSpec.coalesce_adaptive):
                        # the window the queue has EARNED — fill
                        # fraction x coalesce_s, re-evaluated on every
                        # wakeup.  Mostly-free resident slots mean the
                        # batch was never coming: seed now, let
                        # latecomers ride the live feed
                        free = (self.epochs * (cap or 1)
                                - self._inflight_lanes)
                        if _key_lanes() <= max(free, 0):
                            # the resident tier can absorb everything
                            # queued RIGHT NOW: waiting buys no batch
                            # density, only queue-wait — collapse the
                            # window to zero
                            window = 0.0
                            break
                        window = coalesce * (_key_lanes()
                                             / float(cap or 1))
                    left = start + window - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                # the adaptive lever's telemetry (docs/observability.md
                # "Request tracing"): the window this epoch CLOSED at —
                # a gauge for the live scrape and a histogram so the
                # chosen-window distribution sits next to the stage
                # waterfalls it shapes (obs/counters.py
                # COALESCE_HIST_KEYS)
                if rec is not None:
                    rec.observe("coalesce_window_s", window,
                                mode=("adaptive" if adaptive
                                      else "fixed"))
                reg = getattr(self.session, "registry", None)
                if reg is not None:
                    reg.publish("coalesce", gauges={
                        "coalesce_window_s": round(window, 6)})
            seed = self._pop_work_locked(
                key, cap if cap else self.max_queue_lanes, epoch)
            if not seed:    # drained away (or sprayed onto a sibling
                return      # epoch) while coalescing
        _admit(seed)
        y0s, cfgs = _stack(seed)

        def feed(n_space, idle):
            with self._cond:
                deadline = time.monotonic() + self.idle_timeout
                while True:
                    works = self._pop_work_locked(key, n_space, epoch)
                    if works:
                        break
                    other = any(k != key and q
                                for k, q in self._queues.items())
                    if self._draining or other:
                        return None     # rotate / drain: close the feed
                    if not idle:
                        # zero-lane rows keep each cfg leaf's trailing
                        # shape (the energy _atol_scale leaf is (k, n),
                        # not (k,)) so the driver's concatenate stays
                        # shape-consistent
                        return (np.zeros((0,) + y0s.shape[1:]),
                                {k: np.zeros(
                                    (0,) + np.asarray(cfgs[k]).shape[1:])
                                 for k in cfgs})
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return None     # idle past the timeout: release
                        #                 the resident program
                    self._cond.wait(left)
            _admit(works)
            return _stack(works)

        def on_harvest(gids, payload):
            finished = []
            for row, gid in enumerate(np.asarray(gids)):
                w, off = gid_map[int(gid)]
                w.trace.mark("first_harvest")   # idempotent: FIRST wins
                w.t[off] = payload["t"][row]
                w.y[off] = payload["y"][row]
                w.status[off] = payload["status"][row]
                w.n_acc[off] = payload["n_accepted"][row]
                w.n_rej[off] = payload["n_rejected"][row]
                if "stats" in payload:
                    if w.stats is None:
                        w.stats = {
                            k: np.zeros((w.request.n_lanes,)
                                        + np.asarray(v).shape[1:],
                                        dtype=np.asarray(v).dtype)
                            for k, v in payload["stats"].items()}
                    for k, v in payload["stats"].items():
                        w.stats[k][off] = np.asarray(v)[row]
                if "observed" in payload:
                    if w.observed is None:
                        w.observed = {
                            k: np.zeros((w.request.n_lanes,)
                                        + np.asarray(v).shape[1:],
                                        dtype=np.asarray(v).dtype)
                            for k, v in payload["observed"].items()}
                    for k, v in payload["observed"].items():
                        w.observed[k][off] = np.asarray(v)[row]
                w.remaining -= 1
                if w.remaining == 0:
                    finished.append(w)
            for w in finished:
                self._resolve(w)

        try:
            # energy rides only when set, so fake sessions (and any
            # pre-energy stream signature) keep working; the per-epoch
            # live source likewise rides only at resident_epochs > 1 —
            # single-epoch keeps today's stream call byte-identical
            ekw = {} if energy is None else {"energy": energy}
            if self.epochs > 1:
                ekw["live_source"] = f"sweep-e{epoch}"
            self.session.stream(y0s, cfgs, t1=t1, rtol=rtol, atol=atol,
                                on_harvest=on_harvest, feed=feed, **ekw)
        except BaseException as e:  # noqa: BLE001 — an epoch must not
            #                         kill the scheduler thread; every
            #                         admitted request is answered
            if rec is not None:
                rec.event("fault", kind="serve_epoch_error",
                          error=f"{type(e).__name__}: {e}")
            if getattr(self.session, "fatal", None) is not None:
                # a CUDA error: the device context is not retried in this
                # process, so no later epoch may run on it
                self._halt(e)
        finally:
            # a stream that died (or a driver bug) must still answer
            # every admitted request exactly once
            for w in epoch_works:
                if not w.future.done():
                    self._fail(w, RuntimeError(
                        "serving stream ended before this request "
                        "harvested (see the daemon's fault events)"))

    def _halt(self, exc):
        """Refuse new work (``draining``) and fail every queued request
        with ``internal``: the session reported a fatal device fault
        (``session.fatal``), after which the daemon drains and exits
        non-zero for its supervisor to restart it."""
        with self._cond:
            self._draining = True
            stranded = [w for q in self._queues.values() for w in q]
            self._queues.clear()
            self._queued_lanes = 0
            self._publish_locked()
            self._cond.notify_all()
        for w in stranded:
            w.trace.mark("resolved")
            w.future.set_exception(RuntimeError(
                f"the device failed under an earlier request and this "
                f"daemon serves no more: {type(exc).__name__}: {exc}"))

    def _settle_locked(self, w):
        self._inflight_lanes -= w.request.n_lanes
        self._publish_locked()

    def _resolve(self, w):
        if w.stall_s:
            # deterministic slow_request fault injection: the stall sits
            # between admission and harvest-resolution, exactly where a
            # slow consumer would (resilience/inject.py); the trace's
            # ``stalled`` mark opens here, so ``stalled -> resolved``
            # carries the injected delay in the waterfall
            w.trace.mark("stalled")
            rec = getattr(self.session, "recorder", None)
            if rec is not None:
                rec.counter("serve_stalls")
                rec.event("fault", kind="slow_request",
                          request=w.request.id, delay_s=w.stall_s)
            time.sleep(w.stall_s)
        w.trace.mark("resolved")
        prov = ["success" if int(c) == int(SUCCESS) else "failed"
                for c in w.status]
        result = RequestResult(
            request=w.request, t=w.t, y=w.y, status=w.status,
            n_accepted=w.n_acc, n_rejected=w.n_rej, stats=w.stats,
            observed=w.observed, provenance=prov,
            elapsed_s=w.trace.total_s(), trace=w.trace)
        with self._cond:
            self._settle_locked(w)
        rec = getattr(self.session, "recorder", None)
        if rec is not None:
            rec.counter("serve_answered")
            self._record_trace(rec, w.trace)
        w.future.set_result(result)

    def _record_trace(self, rec, trace):
        """Fold one resolved trace onto the obs plane: the per-stage
        ``serve_stage_seconds`` histograms (``{stage="total"}`` is the
        request latency — the old summed ``serve_latency_s`` counter,
        migrated), the ``request_trace`` JSONL event, and — past the
        spec's ``slow_request_s`` threshold — a structured
        ``slow_request`` event that arms the flight recorder with a
        counter snapshot (obs/live.py), so a latency excursion leaves
        postmortem evidence behind."""
        total = trace.total_s()
        for stage, dur in trace.segments().items():
            rec.observe("serve_stage_seconds", dur, stage=stage)
        rec.observe("serve_stage_seconds", total, stage="total")
        rec.event("request_trace", **trace.to_attrs())
        slow = float(getattr(self.session.spec, "slow_request_s", 0.0)
                     or 0.0)
        if slow and total >= slow:
            from ..obs.live import flight_note_counters

            rec.event("slow_request", request=trace.request_id,
                      total_s=round(total, 6), threshold_s=slow,
                      stages={s: round(v, 6)
                              for s, v in trace.segments().items()})
            flight_note_counters(rec)

    def _fail(self, w, exc):
        w.trace.mark("resolved")
        with self._cond:
            self._settle_locked(w)
        rec = getattr(self.session, "recorder", None)
        if rec is not None:
            rec.counter("serve_failed")
            # failed requests export their trace (a stream death's
            # timing is postmortem evidence) but never enter the
            # latency histograms — a half-served request's wall would
            # poison the distributions the gate bands check
            rec.event("request_trace", failed=True, **w.trace.to_attrs())
        w.future.set_exception(exc)
