"""Daemon front-ends: stdlib HTTP (``POST /solve``) and stdin-JSONL.

The HTTP face is the ``obs.MetricsServer`` shape grown a solve
endpoint: a ``ThreadingHTTPServer`` background thread (``port=0`` binds
an ephemeral port, read it from ``.port``/``.url`` — the no-fixed-port
discipline the whole test/CI tier uses) serving

* ``POST /solve`` — one schema request in, one response out.  The
  handler thread blocks on the request's future (each HTTP connection
  is its own thread; the solver never waits on HTTP).  Scheduler
  rejections map to ``503`` (``overloaded`` / ``draining`` — the
  backpressure contract is an HTTP status, not a silent queue), schema
  rejections to ``400``, a dead stream to ``500``.
* ``GET /metrics`` — the session registry's Prometheus exposition (the
  live plane: ``br_sweep_occupancy``, backlog depth, and the
  ``serve_*`` queue gauges move between mid-flight scrapes, and the
  ``br_serve_stage_seconds`` latency-stage histograms show the live
  queue-wait vs solve-time distributions — docs/observability.md
  "Histograms").
* ``GET /healthz`` — registry liveness + the session's serving block
  (fingerprint, warm state, compile count, drain flag).

The JSONL face (:func:`serve_jsonl`) reads one request object per stdin
line and writes responses as they resolve (out-of-order completion is
the point — ids correlate), then drains on EOF.  Both faces answer
every accepted request exactly once; ``tools/serve.py`` wires them to
SIGTERM-with-grace teardown (``resilience.run_guarded`` supervision).
"""

import http.server
import json
import threading
from concurrent import futures

from . import schema
from .scheduler import SchedulerReject



class _ServeHandler(http.server.BaseHTTPRequestHandler):
    front = None    # bound per-server via a subclass (ServingServer)

    def _send(self, code, obj, ctype="application/json"):
        body = (json.dumps(obj) + "\n").encode() if not isinstance(
            obj, bytes) else obj
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib handler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200, self.front.session.registry.prometheus()
                           .encode(),
                           ctype="text/plain; version=0.0.4; "
                                 "charset=utf-8")
            elif path == "/healthz":
                self._send(200, self.front.healthz())
            else:
                self.send_error(404, "unknown path (GET /metrics, "
                                     "GET /healthz, POST /solve)")
        except Exception as e:  # noqa: BLE001 — a scrape must never
            #                     kill the serving thread
            self.send_error(500, f"{type(e).__name__}: {e}")

    def do_POST(self):  # noqa: N802 — stdlib handler contract
        path = self.path.split("?", 1)[0]
        if path not in ("/solve", "/mechanism"):
            self.send_error(404, "POST /solve and POST /mechanism are "
                                 "the write paths")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            obj = json.loads(raw.decode() or "null")
        except (ValueError, UnicodeDecodeError) as e:
            self._send(400, schema.error_response(
                None, "invalid", f"request body is not JSON: {e}"))
            return
        if path == "/mechanism":
            code, resp = self.front.upload(obj)
        else:
            code, resp = self.front.solve(obj)
        self._send(code, resp)

    def log_message(self, *_args):
        pass    # request logging rides the obs recorder, not stderr


class ServingServer:
    """Module doc.  Composes a :class:`~.session.SolverSession` and a
    :class:`~.scheduler.Scheduler` behind one HTTP port; use as a
    context manager, or ``start()``/``close()`` for a long-lived
    daemon (``tools/serve.py``)."""

    def __init__(self, session, scheduler, port=0, host="127.0.0.1",
                 request_timeout=None, store=None, membership=None):
        self.session = session
        self.scheduler = scheduler
        #: multi-mechanism store (docs/serving.md): routes per-request
        #: ``mech`` keys and accepts ``POST /mechanism`` uploads; None
        #: keeps the single-mechanism daemon byte-compatible
        self.store = store
        #: fleet membership (:class:`~..fleet.MemberRegistration`) —
        #: when set, ``close()`` runs the drain handshake: the draining
        #: flag goes up FIRST so the router stops sending new work (and
        #: fails over in-flight retries) while this daemon finishes what
        #: it already accepted, and the member deregisters LAST, after
        #: the final request has answered
        self.membership = membership
        self.request_timeout = float(
            session.spec.request_timeout_s if request_timeout is None
            else request_timeout)
        self._requested = (host, int(port))
        self._server = None
        self._thread = None
        self._ids = _IdSource()

    # ---- request plumbing (shared by HTTP and tests) ----------------------
    def _route(self, obj):
        """(session, scheduler) for a raw request object's ``mech`` key
        — routed BEFORE validation, which needs the target session's
        species list."""
        mech = obj.get("mech") if isinstance(obj, dict) else None
        if self.store is None:
            if mech is not None:
                from .session import UnknownMechanism

                raise UnknownMechanism(
                    f"mech={mech!r} routing needs the multi-mechanism "
                    f"store; this daemon serves one mechanism")
            return self.session, self.scheduler
        return self.store.resolve(mech)

    def solve(self, obj):
        """One request object -> ``(http_status, response_object)``."""
        from .session import UnknownMechanism

        rid = obj.get("id") if isinstance(obj, dict) else None
        try:
            session, scheduler = self._route(obj)
        except UnknownMechanism as e:
            return 404, schema.error_response(
                rid, "unknown_mechanism", e.args[0])
        try:
            req = schema.validate_request(
                obj, species=session.species,
                rtol_default=session.spec.rtol,
                atol_default=session.spec.atol,
                default_id=self._ids.next(),
                max_lanes=session.spec.max_lanes_per_request,
                energy_modes=getattr(session.spec, "energy_modes", ()))
        except ValueError as e:
            return 400, schema.error_response(rid, "invalid", e)
        try:
            future = scheduler.submit(req)
        except SchedulerReject as e:
            return 503, schema.error_response(req.id, e.code, e)
        try:
            result = future.result(timeout=self.request_timeout)
        except SchedulerReject as e:       # pragma: no cover — defensive
            return 503, schema.error_response(req.id, e.code, e)
        except Exception as e:  # noqa: BLE001 — stream death / timeout:
            #                     the request is answered, loudly
            return 500, schema.error_response(
                req.id, "internal", f"{type(e).__name__}: {e}")
        return 200, schema.ok_response(
            req.id, session.render_result(result))

    def upload(self, obj):
        """One mechanism-upload object -> ``(http_status, response)``
        (``POST /mechanism``; grammar schema.validate_upload)."""
        rid = obj.get("id") if isinstance(obj, dict) else None
        if self.store is None:
            return 404, schema.error_response(
                rid, "invalid", "this daemon runs without a mechanism "
                "store (tools/serve.py --store)")
        try:
            upload = schema.validate_upload(obj)
        except ValueError as e:
            return 400, schema.error_response(rid, "invalid", e)
        try:
            _fp, info = self.store.add_upload(upload)
        except ValueError as e:
            return 400, schema.error_response(upload["id"], "invalid", e)
        except Exception as e:  # noqa: BLE001 — answered, loudly
            return 500, schema.error_response(
                upload["id"], "internal", f"{type(e).__name__}: {e}")
        return 200, schema.ok_response(upload["id"], info)

    def healthz(self):
        h = self.session.registry.healthz()
        queued, inflight = self.scheduler.depth()
        h["serving"] = {**self.session.healthz_extra(),
                        "queued_lanes": queued,
                        "inflight_lanes": inflight,
                        # the request-tracing plane's alarm config
                        # (docs/observability.md "Request tracing"):
                        # operators read whether slow-request
                        # flight-recorder dumps are armed, and at what
                        # threshold, off the daemon itself
                        "slow_request_s": float(getattr(
                            self.session.spec, "slow_request_s", 0.0)
                            or 0.0),
                        "draining": bool(self.scheduler._draining)}
        if self.store is not None:
            h["serving"]["store"] = self.store.healthz()
        if self.membership is not None:
            h["serving"]["fleet"] = {
                "member": self.membership.name,
                "fleet_dir": self.membership.fleet_dir,
            }
        return h

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        if self._server is not None:
            return self
        self.scheduler.start()
        handler = type("_BoundServeHandler", (_ServeHandler,),
                       {"front": self})
        self._server = http.server.ThreadingHTTPServer(
            self._requested, handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="br-serve-http")
        self._thread.start()
        rec = self.session.recorder
        if rec is not None:
            rec.event("serving_bound", host=self._server.server_address[0],
                      port=self.port)
        return self

    @property
    def port(self):
        if self._server is None:
            raise RuntimeError("ServingServer not started")
        return self._server.server_address[1]

    @property
    def url(self):
        return (f"http://{self._server.server_address[0]}:{self.port}")

    def close(self, drain_timeout=None):
        """Drain the scheduler (every accepted request answers), then
        stop the HTTP thread.  Fleet mode adds the drain handshake
        around that: mark draining first, deregister last."""
        if self.membership is not None:
            self.membership.mark_draining()
        if self.store is not None:
            self.store.drain(drain_timeout)
        self.scheduler.drain(drain_timeout)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = self._thread = None
        if self.membership is not None:
            self.membership.deregister()

    def __enter__(self):
        return self.start()

    def __exit__(self, *_exc):
        self.close()


class _IdSource:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def next(self):
        with self._lock:
            self._n += 1
            return f"req-{self._n}"


def serve_jsonl(session, scheduler, infile, outfile):
    """The stdin-JSONL front-end (module doc): one request object per
    input line, one response object per output line as each resolves
    (out-of-order; correlate by id).  Returns ``(accepted, rejected)``
    after EOF drains the queue."""
    write_lock = threading.Lock()
    ids = _IdSource()
    accepted = rejected = 0
    pending = []

    def _emit(obj):
        with write_lock:
            outfile.write(json.dumps(obj) + "\n")
            outfile.flush()

    for line in infile:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
            req = schema.validate_request(
                obj, species=session.species,
                rtol_default=session.spec.rtol,
                atol_default=session.spec.atol,
                default_id=ids.next(),
                max_lanes=session.spec.max_lanes_per_request,
                energy_modes=getattr(session.spec, "energy_modes", ()))
        except ValueError as e:
            rejected += 1
            _emit(schema.error_response(
                obj.get("id") if isinstance(obj, dict) else None,
                "invalid", e))
            continue
        try:
            future = scheduler.submit(req)
        except SchedulerReject as e:
            rejected += 1
            _emit(schema.error_response(req.id, e.code, e))
            continue
        accepted += 1

        def _done(fut, rid=req.id):
            try:
                _emit(schema.ok_response(
                    rid, session.render_result(fut.result())))
            except Exception as e:  # noqa: BLE001 — answered, loudly
                _emit(schema.error_response(
                    rid, "internal", f"{type(e).__name__}: {e}"))

        future.add_done_callback(_done)
        pending.append(future)
    scheduler.drain()
    futures.wait(pending)   # belt over braces: every response line has
    #                         been emitted by its done-callback
    return accepted, rejected
