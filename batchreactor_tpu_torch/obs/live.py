"""Live telemetry plane: in-flight metrics endpoint, fleet aggregation,
and the fault flight recorder.

Port of ``batchreactor_tpu/obs/live.py`` (host side only: stdlib HTTP,
threads, files and a signal handler; the same metric names).

Everything else in ``obs/`` is post-hoc — ``build_report`` runs after the
sweep returns, ``to_prometheus`` renders once.  This module makes the
same telemetry LIVE:

* :class:`LiveRegistry` — a thread-safe view over an ``obs.Recorder``
  plus per-source *overlays* (in-flight counter deltas and gauges) that
  the sweep drivers publish at their existing poll boundaries
  (``parallel/sweep.py`` ``live=``).  ``prometheus()`` renders the
  merged state through the one existing exposition renderer
  (``obs.export.to_prometheus``), so a mid-flight scrape and a post-hoc
  report share schema — counters sum recorder totals with the overlay
  deltas (``br_sweep_occupancy`` therefore moves between scrapes while
  lanes stream), and published gauges render as ``br_sweep_<name>``
  families.
* :class:`MetricsServer` — a stdlib ``http.server`` background thread
  serving ``/metrics`` (Prometheus text, format 0.0.4) and ``/healthz``
  (JSON liveness + the current gauge block) from a registry.  Wired by
  ``batch_reactor_sweep(live_metrics=)`` / ``BR_METRICS_PORT`` and
  entirely host-side — the captured step windows are the same with the
  endpoint on or off.
* **fleet aggregation** — each ``elastic_checkpointed_sweep`` process
  drops periodic :func:`write_fleet_snapshot` files beside its
  heartbeat in the shared checkpoint dir; :func:`merge_fleet` reduces
  them (counters summed, gauges max-reduced — the ``obs/counters.py``
  GAUGE convention) and :func:`fleet_prometheus` renders the per-host
  labeled view any process's ``/metrics`` (``fleet_dir=``) serves.
* :class:`FlightRecorder` — a bounded in-memory ring of recent spans,
  events, and counter snapshots (tapped off the recorder), dumped to a
  ``flight_<ts>.jsonl`` postmortem artifact by the resilience layer's
  fault paths (wedge watchdog breach, chunk-retry exhaustion) and by
  the SIGTERM handler :func:`arm_flight` optionally installs — so a
  wedged chip session leaves evidence behind instead of a bare SIGTERM
  note (docs/observability.md "Flight recorder").

Nothing here touches a device: the live plane observes host-side state
only (the zero-overhead-when-off
contract of the whole ``obs`` package).
"""

import collections
import http.server
import json
import os
import signal
import threading
import time

from .export import _metric, to_prometheus
from .report import build_report

def resolve_live_metrics(live_metrics=None):
    """THE resolution rule for the live metrics endpoint knob (the
    ``resolve_jac_window`` convention): explicit ``False`` = off,
    ``True`` = an ephemeral port (0, read the bound port off the
    server), an int >= 0 = that port (0 = ephemeral); ``None`` resolves
    from the ``BR_METRICS_PORT`` env lever (unset/empty = off).
    Returns the port to bind, or ``None`` for off."""
    if live_metrics is None:
        env = os.environ.get("BR_METRICS_PORT", "")
        if not env:
            return None
        live_metrics = env
    if live_metrics is False:
        return None
    if live_metrics is True:
        return 0
    port = int(live_metrics)
    if port < 0 or port > 65535:
        raise ValueError(f"live_metrics port must be in [0, 65535] "
                         f"(0 = ephemeral), got {live_metrics!r}")
    return port


class LiveRegistry:
    """Thread-safe live view over a recorder + in-flight overlays.

    ``publish(source, counters=, gauges=)`` REPLACES that source's
    overlay (the drivers re-publish their full in-flight state at each
    poll, so a scrape never sees a partial update); ``clear(source)``
    drops it — the drivers clear on return, after folding their final
    totals onto the recorder, so counters never double-count.  All
    reads (``report`` / ``gauges`` / ``prometheus`` / ``healthz``) are
    safe concurrently with publishes from driver threads."""

    def __init__(self, recorder=None, meta=None, fleet_dir=None,
                 host_label=None):
        self.recorder = recorder
        self.meta = dict(meta or {})
        #: shared checkpoint dir whose ``hosts/*.metrics.json`` snapshots
        #: this registry merges into its ``/metrics`` (fleet view)
        self.fleet_dir = fleet_dir
        self.host_label = host_label
        self._lock = threading.Lock()
        self._overlays = {}   # source -> {"counters": {}, "gauges": {}}
        self._t0 = time.time()

    # ---- publish side (the sweep drivers) ---------------------------------
    def publish(self, source, counters=None, gauges=None):
        with self._lock:
            self._overlays[source] = {"counters": dict(counters or {}),
                                      "gauges": dict(gauges or {}),
                                      "time": time.time()}
        if self.recorder is not None:
            self.recorder.counter("live_publishes")

    def clear(self, source):
        with self._lock:
            self._overlays.pop(source, None)

    def retire(self, source, counters=None):
        """Atomically drop ``source``'s overlay AND fold its final
        counter totals onto the recorder — the drivers' clear-on-return
        path.  The old sequence (recorder fold, then :meth:`clear`)
        left a window where a concurrent scrape merged the final totals
        WITH the still-standing overlay and double-counted the whole
        sweep; folding and clearing under the registry lock — the same
        lock :meth:`_merged` now holds across its recorder read —
        closes it: a scrape sees the overlay or the folded totals,
        never both and never neither (regression:
        tests/test_live.py)."""
        with self._lock:
            self._overlays.pop(source, None)
            if self.recorder is not None:
                for k, v in (counters or {}).items():
                    self.recorder.counter(k, v)

    # ---- read side (the endpoint) -----------------------------------------
    def _merged(self):
        """(counters, gauges): recorder counters + summed overlay
        deltas; overlay gauges merged across sources (later sources
        win on a name collision — sources are distinct by convention).
        The recorder read happens UNDER the registry lock so it is
        atomic with the overlay read against :meth:`retire` (lock
        order registry -> recorder, same as retire; the recorder never
        calls back into the registry, so the order is acyclic)."""
        with self._lock:
            base = {}
            if self.recorder is not None:
                base = dict(self.recorder.snapshot()[2])
            overlays = [dict(o) for o in self._overlays.values()]
        gauges = {}
        for o in overlays:
            for k, v in o["counters"].items():
                base[k] = base.get(k, 0) + v
            gauges.update(o["gauges"])
        return base, gauges

    def report(self):
        """A ``build_report``-shaped dict of the CURRENT state: recorder
        spans/events + merged counters (overlay deltas folded in)."""
        rep = build_report(recorder=self.recorder, meta=self.meta)
        counters, _ = self._merged()
        rep["counters"] = counters
        return rep

    def gauges(self):
        return self._merged()[1]

    def prometheus(self):
        """The ``/metrics`` payload: the standard report exposition
        (``to_prometheus`` — so ``br_sweep_occupancy`` derives from the
        merged counter pair), the published gauges as ``br_sweep_<name>``
        families, an uptime gauge, and — with ``fleet_dir`` set — the
        per-host fleet section appended."""
        if self.recorder is not None:
            self.recorder.counter("metrics_scrapes")
        # ONE merged snapshot per scrape: counters and gauges in the
        # exposition describe the same instant (and the lock is taken
        # once, not twice)
        counters, gauges = self._merged()
        rep = build_report(recorder=self.recorder, meta=self.meta)
        rep["counters"] = counters
        lines = [to_prometheus(rep).rstrip("\n")]
        extra = []
        _metric(extra, "br_live_uptime_seconds", "gauge",
                "Seconds since this live registry was created.",
                [({}, round(time.time() - self._t0, 3))])
        for name, value in sorted(gauges.items()):
            _metric(extra, f"br_sweep_{name}", "gauge",
                    f"Live sweep gauge '{name}' (published at the "
                    f"driver's poll boundaries).", [({}, value)])
        if self.fleet_dir:
            snaps = read_fleet_snapshots(self.fleet_dir)
            if snaps:
                extra.append(fleet_prometheus(snaps).rstrip("\n"))
        text = "\n".join([ln for ln in lines if ln] + extra)
        return text + ("\n" if text else "")

    def healthz(self):
        """The ``/healthz`` payload: liveness + the current gauge block
        (a load balancer reads ``ok``; an operator reads the gauges)."""
        return {"ok": True, "time": time.time(),
                "uptime_s": round(time.time() - self._t0, 3),
                "pid": os.getpid(), "meta": self.meta,
                "gauges": self.gauges()}


class _Handler(http.server.BaseHTTPRequestHandler):
    registry = None   # bound per-server via a subclass (MetricsServer)

    def do_GET(self):  # noqa: N802 — stdlib handler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = self.registry.prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body = (json.dumps(self.registry.healthz()) + "\n").encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path (serve /metrics or "
                                     "/healthz)")
                return
        except Exception as e:  # noqa: BLE001 — a scrape must never kill
            #                     the serving thread; surface as a 500
            self.send_error(500, f"{type(e).__name__}: {e}")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args):
        pass   # scrapes are periodic by design; don't spam stderr


class MetricsServer:
    """Background ``/metrics`` + ``/healthz`` HTTP server over a
    :class:`LiveRegistry` (module doc).  ``port=0`` binds an ephemeral
    port — read the bound one from ``.port`` (or ``.url``).  Use as a
    context manager (the sweep entry points do) or call
    ``start()``/``close()`` explicitly for a long-lived service."""

    def __init__(self, registry, port=0, host="127.0.0.1", log=None):
        self.registry = registry
        self._requested = (host, int(port))
        self._server = None
        self._thread = None
        self._log = log

    def start(self):
        if self._server is not None:
            return self
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._server = http.server.ThreadingHTTPServer(
            self._requested, handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="br-metrics-server")
        self._thread.start()
        # the ephemeral-port (port=0) discipline: the BOUND port is the
        # only one that exists, so expose it the moment it does — on the
        # instance (.port/.url), as a recorder event, and through any
        # caller-supplied log — so daemons, tests, and CI never race a
        # fixed port
        if self.registry is not None and self.registry.recorder is not None:
            self.registry.recorder.event(
                "metrics_server_bound",
                host=self._server.server_address[0], port=self.port)
        if self._log is not None:
            self._log(f"[metrics] serving {self.url}/metrics")
        return self

    @property
    def port(self):
        if self._server is None:
            raise RuntimeError("MetricsServer not started")
        return self._server.server_address[1]

    @property
    def url(self):
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *_exc):
        self.close()


# --------------------------------------------------------------------------
# fleet aggregation (the elastic tier's shared-checkpoint-dir view)
# --------------------------------------------------------------------------
def _fleet_dir(ckpt_dir):
    # beside the heartbeats: multihost._hosts_dir writes ckpt_dir/hosts
    d = os.path.join(ckpt_dir, "hosts")
    os.makedirs(d, exist_ok=True)
    return d


def _pid_id(process_id):
    # usually an OS pid, but in-process fleets (serve_bench --router: N
    # members under ONE pid) pass string ids for distinct snapshot files
    try:
        return int(process_id)
    except (TypeError, ValueError):
        return str(process_id)


def snapshot_path(ckpt_dir, process_id):
    return os.path.join(_fleet_dir(ckpt_dir),
                        f"p{_pid_id(process_id)}.metrics.json")


def write_fleet_snapshot(ckpt_dir, process_id, registry):
    """Atomically drop this process's metric snapshot beside its
    heartbeat (``hosts/p<id>.metrics.json``): merged counters + gauges
    + the recorder's histograms, the payload :func:`merge_fleet`
    reduces.  Crash-safe (tmp + ``os.replace``) and cheap enough for
    the elastic tier's poll loop."""
    from . import counters as C

    counters, gauges = registry._merged()
    hists = {}
    if registry.recorder is not None:
        le = list(C.HIST_BUCKET_EDGES)
        hists = {name: [{"le": le, **ser} for ser in series]
                 for name, series
                 in registry.recorder.hist_snapshot().items()}
    snap = {"pid": _pid_id(process_id), "time": time.time(),
            "counters": counters, "gauges": gauges,
            "histograms": hists}
    path = snapshot_path(ckpt_dir, process_id)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f)
    os.replace(tmp, path)
    if registry.recorder is not None:
        registry.recorder.counter("fleet_snapshots")
    return path


def read_fleet_snapshots(ckpt_dir):
    """All processes' snapshots from the shared dir, sorted by pid; a
    torn snapshot (a writer died mid-``json.dump`` before the atomic
    writer existed, or a disk fault) is skipped, not fatal."""
    d = os.path.join(ckpt_dir, "hosts")
    out = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("p") and name.endswith(".metrics.json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out


def merge_fleet(snapshots):
    """Reduce per-host snapshots to one fleet view: counters SUMMED
    across hosts, gauges MAX-reduced — the ``obs/counters.py`` GAUGE
    convention (summing a per-host high-water mark or ratio would
    report a value no host ever saw) — and histogram series merged by
    slot-wise sum (``hist_merge``: the fixed bucket ladder is exactly
    what makes a cross-host latency distribution well-defined)."""
    from . import counters as C

    counters, gauges, hists = {}, {}, {}
    for s in snapshots:
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (s.get("gauges") or {}).items():
            gauges[k] = max(gauges.get(k, v), v)
        for name, series in (s.get("histograms") or {}).items():
            fam = hists.setdefault(name, {})
            for ser in series:
                key = tuple(sorted((ser.get("labels") or {}).items()))
                if key in fam:
                    fam[key] = {"labels": dict(key),
                                "le": fam[key].get("le"),
                                **C.hist_merge(fam[key], ser)}
                else:
                    fam[key] = {"labels": dict(key),
                                "le": ser.get("le"),
                                "counts": list(ser["counts"]),
                                "sum": ser["sum"],
                                "count": ser["count"]}
    return {"hosts": len(snapshots), "counters": counters,
            "gauges": gauges,
            "histograms": {name: [fam[k] for k in sorted(fam)]
                           for name, fam in sorted(hists.items())}}


def fleet_prometheus(snapshots):
    """Prometheus rendering of the fleet: per-host labeled counter and
    gauge families plus the merged derived occupancy, so one scrape of
    any process answers "what is the whole pod doing"."""
    from . import counters as C

    lines = []
    _metric(lines, "br_fleet_hosts", "gauge",
            "Processes with a metric snapshot in the shared dir.",
            [({}, len(snapshots))])
    _metric(lines, "br_fleet_counter_total", "counter",
            "Per-host recorder counters from the fleet snapshots.",
            [({"host": f"p{s.get('pid', '?')}", "name": k}, v)
             for s in snapshots
             for k, v in sorted((s.get("counters") or {}).items())])
    _metric(lines, "br_fleet_gauge", "gauge",
            "Per-host live gauges from the fleet snapshots.",
            [({"host": f"p{s.get('pid', '?')}", "name": k}, v)
             for s in snapshots
             for k, v in sorted((s.get("gauges") or {}).items())])
    _metric(lines, "br_fleet_snapshot_age_seconds", "gauge",
            "Age of each host's metric snapshot (stale = host slow, "
            "dead, or partitioned).",
            [({"host": f"p{s.get('pid', '?')}"},
              round(time.time() - float(s.get("time", 0)), 3))
             for s in snapshots])
    merged = merge_fleet(snapshots)
    occ = C.occupancy(merged["counters"])
    if occ is not None:
        _metric(lines, "br_fleet_occupancy", "gauge",
                "Fleet-wide sweep occupancy (counters summed across "
                "hosts before the ratio).", [({}, round(occ, 6))])
    # fleet-merged latency histograms (slot-wise summed across hosts —
    # the fixed bucket ladder makes the cross-host distribution
    # well-defined); series missing their ``le`` (a pre-histogram
    # snapshot) are skipped rather than guessed at
    from .export import _histogram

    for name in sorted(merged.get("histograms") or {}):
        series = [ser for ser in merged["histograms"][name]
                  if ser.get("le")]
        _histogram(lines, f"br_fleet_{name}",
                   f"Fleet-merged latency histogram '{name}' "
                   f"(seconds; per-host series summed slot-wise).",
                   series)
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------
# flight recorder (the postmortem ring)
# --------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of recent telemetry records (module doc).

    Attach to a recorder by assigning ``recorder.tap = flight.tap`` (or
    let :func:`arm_flight` do it): every completed span, event, and
    counter update lands in the ring, oldest evicted first.  Push
    whole-counter snapshots with :meth:`snapshot_counters` (the sweep
    drivers do at poll boundaries), so a dump's tail carries the last
    known counter state before the fault.  :meth:`dump` writes the ring
    oldest-to-newest as ``flight_<ts>.jsonl`` — append-cheap, bounded
    memory, and safe to call from a signal handler or an exception
    path."""

    def __init__(self, capacity=256):
        if int(capacity) < 1:
            raise ValueError(f"flight capacity must be >= 1, got "
                             f"{capacity}")
        self._ring = collections.deque(maxlen=int(capacity))
        # REENTRANT: the SIGTERM hook may interrupt the main thread
        # inside note() (the recorder tap fires on every counter) and
        # then dump() — a plain Lock would deadlock the very teardown
        # the dump exists to record
        self._lock = threading.RLock()
        self._n_dumps = 0

    def tap(self, kind, record):
        """``obs.Recorder`` tap hook: called once per completed span /
        event / counter update with a plain dict."""
        self.note(kind, **record)

    def note(self, kind, **payload):
        with self._lock:
            self._ring.append({"kind": kind, "time": time.time(),
                               **payload})

    def snapshot_counters(self, counters):
        """Record a full counter snapshot (a dict copy) into the ring."""
        self.note("counter_snapshot", counters=dict(counters or {}))

    def records(self):
        with self._lock:
            return list(self._ring)

    def dump(self, dir=".", reason=None, path=None):
        """Write the ring as a ``flight_<ts>.jsonl`` postmortem (one
        ``kind``-tagged JSON object per line, a ``flight`` header line
        first); returns the path.  The per-recorder dump sequence number
        is allocated atomically WITH the ring snapshot, so concurrent
        dumps (a worker-thread wedge racing the SIGTERM hook) pick
        distinct names — a fault cascade never overwrites its own
        evidence."""
        with self._lock:
            records = list(self._ring)
            n = self._n_dumps
            self._n_dumps += 1
        if path is None:
            ts = int(time.time())
            name = (f"flight_{ts}.jsonl" if n == 0
                    else f"flight_{ts}_{n}.jsonl")
            path = os.path.join(dir, name)
        header = {"kind": "flight", "time": time.time(),
                  "pid": os.getpid(), "reason": reason,
                  "records": len(records)}
        with open(path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True, default=repr)
                        + "\n")
        return path


_flight_lock = threading.Lock()
_FLIGHT = None      # (FlightRecorder, dir, recorder)


def arm_flight(recorder=None, dir=".", capacity=256, install_signal=True):
    """Arm the process-wide flight recorder: creates the ring, taps the
    given recorder (if any), and — from the main thread, with
    ``install_signal`` — installs a SIGTERM handler that dumps the ring
    before chaining to the previous handler, so a supervised teardown
    (``resilience.run_guarded`` sends SIGTERM first) ships a
    ``flight_*.jsonl`` instead of a bare note.  Re-arming replaces the
    previous ring.  Returns the :class:`FlightRecorder`."""
    global _FLIGHT
    fl = FlightRecorder(capacity=capacity)
    if recorder is not None:
        recorder.tap = fl.tap
    with _flight_lock:
        _FLIGHT = (fl, dir, recorder)
    if install_signal:
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_sigterm(signum, frame):
                flight_dump("SIGTERM")
                if callable(prev):
                    prev(signum, frame)
                elif prev is signal.SIG_IGN:
                    # the process intentionally ignores SIGTERM: dump
                    # and keep ignoring — re-raising here would convert
                    # a soft-kill the supervisor suppressed into death
                    return
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            # not the main thread (or an exotic platform): the exception
            # and watchdog dump paths still work, only the signal hook
            # is unavailable
            pass
    return fl


def armed_flight():
    """The armed :class:`FlightRecorder`, or ``None``."""
    fl = _FLIGHT   # atomic reference read — safe from signal handlers
    return fl[0] if fl is not None else None


def disarm_flight():
    """Drop the armed flight recorder (tests call this in teardown);
    detaches the recorder tap.  Any signal handler installed by
    :func:`arm_flight` stays but becomes a no-op dump."""
    global _FLIGHT
    with _flight_lock:
        fl = _FLIGHT
        _FLIGHT = None
    if fl is not None and fl[2] is not None:
        fl[2].tap = None


def flight_note_counters(recorder):
    """Snapshot ``recorder``'s current counters into the armed ring (the
    "last counter snapshot preceding the fault" a postmortem wants);
    no-op when nothing is armed — the resilience fault paths call this
    unconditionally."""
    fl = _FLIGHT   # atomic reference read — safe from signal handlers
    if fl is None or recorder is None:
        return
    fl[0].snapshot_counters(recorder.snapshot()[2])


def flight_dump(reason):
    """Dump the armed ring (no-op -> ``None`` when nothing is armed);
    returns the written path.  Called by the resilience fault paths
    (watchdog breach, retry exhaustion) and the SIGTERM hook; safe to
    call repeatedly — each dump gets its own file.  The global is read
    WITHOUT the arm/disarm lock: an atomic reference read, so the
    SIGTERM hook can never deadlock on a lock the interrupted frame
    holds."""
    fl = _FLIGHT
    if fl is None:
        return None
    flight, dir_, recorder = fl
    if recorder is not None:
        flight.note("counter_snapshot",
                    counters=dict(recorder.snapshot()[2]))
        recorder.counter("flight_dumps")
    try:
        return flight.dump(dir=dir_, reason=reason)
    except OSError:
        return None   # postmortem best-effort: never mask the fault
