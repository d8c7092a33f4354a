"""The fleet router: one thin HTTP face over N serving daemons.

A :class:`FleetRouter` is a stdlib ``ThreadingHTTPServer`` (the
``obs.MetricsServer`` / ``serving.ServingServer`` shape) that owns NO
solver state — it peeks each request's routing key, consistent-hashes
it onto the live member set (``fleet/ring.py``), and forwards over
HTTP.  Deliberately device-free: the router must keep answering (and keep
serving the fleet ``/metrics``) when every device in the fleet is
wedged.

* ``POST /solve`` — route by ``(mech, t1, rtol, atol, energy)``
  (:func:`~.ring.request_key`: the mechanism + pack-key identity of the
  warm state the request will occupy) and forward.  A member's answer —
  ok or an honest error (``invalid`` / ``overloaded`` / ``unknown_
  mechanism``) — passes through with its HTTP status, plus a
  ``router`` section (host, attempts, failover flag) as provenance.
  **Failover**: a transport-level failure (connection refused/reset —
  the member is gone) or a ``draining`` rejection (the drain
  handshake) sends the request to the next distinct member clockwise;
  the sweep is deterministic, so the survivor's answer is bit-exact
  the one the dead member would have given, and the client gets
  exactly one answer.  Only when every member fails does the router
  answer — loudly — with ``internal``/503.  Nothing ever queues
  silently on the router.
* ``POST /mechanism`` — replicate to every live member
  (``fleet/replication.py``: idempotent by fingerprint, versioned by
  id), journal for replay to later joiners, report per-member results.
* ``GET /metrics`` — the router registry's exposition WITH the shared
  ``fleet_dir`` merge appended (``obs.live``: per-host counters/gauges,
  counters summed, gauges max-reduced, histograms slot-wise — the fleet-snapshot
  machinery verbatim, fed by each member's heartbeat snapshots) plus
  the router's own ``route_*``/``fleet_*`` counters, the
  ``route_seconds`` histogram (``obs/counters.py`` FAMILIES), and the
  SLO monitor's ``br_slo_*`` burn-rate gauges (``obs/slo.py``).

**Distributed tracing** (docs/observability.md "Fleet tracing"): every
``/solve`` carries a ``trace_ctx`` envelope downstream — inherited
from the client when present, minted here when absent — and every
terminal outcome (success, upstream error, invalid envelope, no
members) emits ONE ``request_trace`` recorder event with the hop
ledger (member, hop number, send/recv wall bracket, outcome) that
``obs.stitch`` joins with the members' stage waterfalls into
fleet-wide traces; a failover chain is one trace with honest hop
provenance.  The same outcomes feed the continuous SLO monitor.
* ``GET /healthz`` — membership census (alive, draining, aged-out),
  ring arc shares, journal ids.

Membership is read from the shared fleet dir (``fleet/membership.py``)
with a small cache TTL; a member that stops heartbeating ages out and
its hash arc reassigns to the survivors.  Between the death and the
age-out, forwards to it fail at transport level and the failover path
covers the gap (the member is also marked *suspect* so subsequent
requests skip it first).
"""

import http.server
import json
import threading
import time
import uuid

from ..obs.live import LiveRegistry
from ..obs.recorder import Recorder
from ..obs.slo import SloMonitor
from ..obs.trace import TRACE_VERSION
from ..serving import schema
from .membership import DEFAULT_DEAD_AFTER_S, read_members
from .replication import UploadJournal, post_json, replicate_upload
from .ring import HashRing, request_key



class _RouterHandler(http.server.BaseHTTPRequestHandler):
    front = None    # bound per-server via a subclass (FleetRouter)

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
                self._send(200, self.front.metrics_text().encode(),
                           ctype="text/plain; version=0.0.4; "
                                 "charset=utf-8")
            elif path == "/healthz":
                self._send(200, self.front.healthz())
            else:
                self.send_error(404, "unknown path (GET /metrics, "
                                     "GET /healthz, POST /solve, "
                                     "POST /mechanism)")
        except Exception as e:  # noqa: BLE001 — a scrape must never
            #                     kill the router thread
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


class FleetRouter:
    """Module doc.  ``fleet_dir`` is the shared membership/telemetry
    directory every member registered into (``tools/serve.py
    --fleet-dir``); the router holds no other state worth preserving —
    kill it and start another, the fleet (and its warm caches) carries
    the identity."""

    def __init__(self, fleet_dir, port=0, host="127.0.0.1", *,
                 dead_after_s=DEFAULT_DEAD_AFTER_S, vnodes=None,
                 request_timeout=300.0, refresh_s=None, recorder=None):
        self.fleet_dir = str(fleet_dir)
        self.dead_after_s = float(dead_after_s)
        self.request_timeout = float(request_timeout)
        #: membership cache TTL — a fraction of the death threshold so
        #: an age-out is noticed within ~1 beat of it happening
        self.refresh_s = (self.dead_after_s / 6.0 if refresh_s is None
                          else float(refresh_s))
        self.recorder = recorder if recorder is not None else Recorder()
        self.registry = LiveRegistry(
            recorder=self.recorder, fleet_dir=self.fleet_dir,
            meta={"entry": "fleet-router"})
        #: the continuous SLO monitor (obs/slo.py — docs/observability
        #: .md "SLO monitor"): every terminal solve() outcome feeds it,
        #: and its br_slo_* gauges append to /metrics (metrics_text)
        self.slo = SloMonitor(recorder=self.recorder)
        self._lock = threading.Lock()
        from .ring import DEFAULT_VNODES

        self._ring = HashRing((), vnodes=(DEFAULT_VNODES if vnodes
                                          is None else int(vnodes)))
        self._members = {}       # name -> MemberInfo (routable set)
        self._census = []        # every registration, incl. dead
        self._suspects = {}      # name -> monotonic expiry
        self._refreshed_at = -1e9
        self._journal = UploadJournal()
        self._requested = (host, int(port))
        self._server = None
        self._thread = None

    # ---- membership view ---------------------------------------------------
    def _view(self, force=False):
        """(ring, {name: MemberInfo}) — refreshed from the fleet dir at
        most every ``refresh_s`` (one claiming thread re-reads; the
        rest route on the cached view, which is the point of the TTL).
        New routable members absorb the upload journal BEFORE they
        enter the ring, so a late joiner never serves a mechanism-less
        arc."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._refreshed_at < self.refresh_s:
                return self._ring, dict(self._members)
            self._refreshed_at = now   # claim this refresh
            known = set(self._members)
        census = read_members(self.fleet_dir, self.dead_after_s)
        routable = {m["name"]: m for m in census if m.routable}
        joined = sorted(n for n in routable if n not in known)
        for name in joined:
            # journal replay OUTSIDE the lock (HTTP against the member);
            # failure keeps the member out of the ring until the next
            # refresh retries — replication is idempotent by fingerprint
            for upload in self._journal.replay():
                res = replicate_upload(routable[name], upload,
                                       self.request_timeout)
                if not res["ok"]:
                    del routable[name]
                    self.recorder.event(
                        "fault", kind="fleet_replay_failed",
                        member=name, upload=upload.get("id"))
                    break
        with self._lock:
            old = set(self._members)
            new = set(routable)
            self._census = census
            self._members = routable
            if new != old:
                self._ring = self._ring.with_members(new)
                for _n in sorted(new - old):
                    self.recorder.counter("fleet_members_joined")
                for _n in sorted(old - new):
                    self.recorder.counter("fleet_members_left")
            for name in [s for s, t in self._suspects.items()
                         if t <= now or s not in new]:
                self._suspects.pop(name, None)
            ring, members = self._ring, dict(self._members)
        self.registry.publish("fleet-router", gauges={
            "fleet_members_routable": len(members),
            "fleet_members_registered": len(census),
            "fleet_members_draining": sum(
                1 for m in census if m.get("draining"))})
        return ring, members

    def _mark_suspect(self, name):
        with self._lock:
            self._suspects[name] = time.monotonic() + self.dead_after_s

    def _candidates(self, ring, members, key):
        """Members to try for ``key``, failover order: the ring's
        preference walk, suspects demoted to the tail (a suspect is
        skipped first, not forgotten — if every healthy member fails
        it is still the honest last resort)."""
        with self._lock:
            now = time.monotonic()
            suspects = {n for n, t in self._suspects.items() if t > now}
        prefs = [members[n] for n in ring.preference(key)
                 if n in members]
        healthy = [m for m in prefs if m["name"] not in suspects]
        demoted = [m for m in prefs if m["name"] in suspects]
        return healthy + demoted

    # ---- request plumbing (shared by HTTP and tests) ----------------------
    def _trace_event(self, rid, tid, parent, base_hop, minted, wall0,
                     total_s, hops, tried, host=None, code=None):
        """The router's terminal ``request_trace`` event — ONE per
        ``solve()`` outcome, success or rejection, so error-rate SLOs
        count what the response alone would hide.
        Carries the hop ledger (send/recv wall bracket per attempt)
        ``obs.stitch`` joins member waterfalls into, and feeds the
        same outcome to the SLO monitor."""
        attrs = {"request": rid, "v": TRACE_VERSION, "span": "route",
                 "minted": minted, "hop": base_hop,
                 "wall_start": round(wall0, 6),
                 "total_s": round(total_s, 6),
                 "failover": bool(tried), "tried": list(tried),
                 "hops": hops}
        if tid is not None:
            attrs["trace"] = tid
            attrs["parent_span"] = parent
        if host is not None:
            attrs["host"] = host
        failed = code is not None
        if failed:
            attrs["code"] = code
            attrs["failed"] = True
        self.recorder.event("request_trace", **attrs)
        self.slo.record(total_s, ok=not failed,
                        failover=bool(tried), at=wall0 + total_s)

    def solve(self, obj):
        """One request object -> ``(http_status, response_object)``,
        forwarded to the key's member with failover (module doc).

        Distributed tracing (docs/observability.md "Fleet tracing"):
        an inherited ``trace_ctx`` is validated (a malformed envelope
        is an ``invalid`` rejection — counted, not silent), MINTED
        when absent, and forwarded on EVERY hop with the hop count
        advanced — so a member's stage marks join one fleet-wide
        trace whether the client traced or not.  The RESPONSE is
        untouched by tracing: the ``router`` section stays exactly
        ``{host, attempts, failover, tried}`` and ctx-less requests
        are byte-identical to the pre-tracing wire format."""
        rec = self.recorder
        rec.counter("route_requests")
        rid = obj.get("id") if isinstance(obj, dict) else None
        t0 = time.perf_counter()
        wall0 = time.time()
        try:
            ctx = schema.validate_trace_ctx(
                obj.get("trace_ctx") if isinstance(obj, dict)
                else None, rid)
        except ValueError as e:
            self._trace_event(rid, None, None, 0, False, wall0,
                              time.perf_counter() - t0, [], [],
                              code="invalid")
            return 400, schema.error_response(rid, "invalid", e)
        if ctx is None:
            tid, parent, base_hop = f"r-{uuid.uuid4().hex[:16]}", None, 0
            minted = True
        else:
            tid, parent, base_hop = ctx
            minted = False
        ring, members = self._view()
        candidates = self._candidates(ring, members, request_key(obj))
        if not candidates:
            rec.counter("route_no_members")
            self._trace_event(rid, tid, parent, base_hop, minted,
                              wall0, time.perf_counter() - t0, [], [],
                              code="internal")
            return 503, schema.error_response(
                rid, "internal",
                f"no routable fleet members (fleet dir "
                f"{self.fleet_dir}; registered: "
                f"{[m['name'] for m in self._census_snapshot()]})")
        tried = []
        hops = []
        last = "unreachable"
        for member in candidates:
            hop_n = base_hop + len(tried) + 1
            if isinstance(obj, dict):
                fobj = dict(obj)
                fobj["trace_ctx"] = schema.trace_ctx_payload(
                    tid, span=f"route:{hop_n}", hop=hop_n)
            else:
                fobj = obj
            hop = {"member": member["name"], "hop": hop_n,
                   "send_wall": round(time.time(), 6)}
            try:
                status, resp = post_json(member["url"], "/solve", fobj,
                                         self.request_timeout)
            except OSError as e:
                # the member is gone (or wedged past the deadline):
                # demote it and re-route — the solve is deterministic,
                # so the survivor's answer is THE answer, delivered
                # exactly once
                hop.update(recv_wall=round(time.time(), 6),
                           outcome="transport")
                hops.append(hop)
                tried.append(member["name"])
                last = f"{member['name']}: {type(e).__name__}: {e}"
                self._mark_suspect(member["name"])
                rec.counter("route_failovers")
                rec.event("fault", kind="route_failover",
                          member=member["name"], error=str(e))
                continue
            hop["recv_wall"] = round(time.time(), 6)
            code = ((resp.get("error") or {}).get("code")
                    if isinstance(resp, dict) else None)
            if code == "draining":
                # the drain handshake's race window: the member flagged
                # itself between our membership read and the forward —
                # its arc is already reassigning, follow it
                hop["outcome"] = "draining"
                hops.append(hop)
                tried.append(member["name"])
                last = f"{member['name']}: draining"
                rec.counter("route_failovers")
                continue
            hop["outcome"] = "ok" if code is None else code
            hops.append(hop)
            if code is not None:
                rec.counter("route_upstream_errors")
            if isinstance(resp, dict):
                resp["router"] = {"host": member["name"],
                                  "attempts": len(tried) + 1,
                                  "failover": bool(tried),
                                  "tried": tried}
            dt = time.perf_counter() - t0
            rec.observe("route_seconds", dt,
                        path="failover" if tried else "direct")
            self._trace_event(rid, tid, parent, base_hop, minted,
                              wall0, dt, hops, tried,
                              host=member["name"], code=code)
            return status, resp
        rec.counter("route_no_members")
        self._trace_event(rid, tid, parent, base_hop, minted, wall0,
                          time.perf_counter() - t0, hops, tried,
                          code="internal")
        return 503, schema.error_response(
            rid, "internal",
            f"all {len(candidates)} fleet member(s) failed "
            f"(tried {tried}; last: {last}); the request was not "
            f"served")

    def _census_snapshot(self):
        with self._lock:
            return list(self._census)

    def upload(self, obj):
        """One mechanism upload -> ``(http_status, response)``:
        journal, replicate to every routable member, report per-member
        results (module doc — a partial failure answers ``internal``
        and the idempotent retry finishes the job)."""
        rec = self.recorder
        rid = obj.get("id") if isinstance(obj, dict) else None
        try:
            upload = schema.validate_upload(obj)
        except ValueError as e:
            return 400, schema.error_response(rid, "invalid", e)
        _ring, members = self._view(force=True)
        if not members:
            return 503, schema.error_response(
                upload["id"], "internal",
                "no routable fleet members to replicate to")
        # journal FIRST: a member joining mid-upload replays it (the
        # fingerprint-idempotent store makes double delivery a no-op)
        self._journal.record(upload)
        rec.counter("fleet_uploads")
        results = []
        for name in sorted(members):
            results.append(replicate_upload(members[name], upload,
                                            self.request_timeout))
            rec.counter("fleet_replications")
        failed = [r["member"] for r in results if not r["ok"]]
        info = {"replicated": [r["member"] for r in results
                               if r["ok"]],
                "failed": failed,
                "fingerprint": next(
                    (r["response"].get("fingerprint")
                     for r in results if r["ok"]), None)}
        if failed:
            rec.event("fault", kind="fleet_replication_partial",
                      failed=failed, upload=upload["id"])
            resp = schema.error_response(
                upload["id"], "internal",
                f"replication incomplete: {failed} failed (retry is "
                f"safe — admission is idempotent by fingerprint)")
            resp["replication"] = info
            return 500, resp
        resp = schema.ok_response(upload["id"], info)
        return 200, resp

    # ---- read endpoints ----------------------------------------------------
    def metrics_text(self):
        """The ``/metrics`` exposition: router counters + histograms +
        the fleet-dir merge (``LiveRegistry.prometheus`` with
        ``fleet_dir`` set appends the per-host + merged section) plus
        the SLO monitor's ``br_slo_*`` gauges (obs/slo.py)."""
        base = self.registry.prometheus()
        slo = self.slo.prometheus()
        if slo and base and not base.endswith("\n"):
            base += "\n"
        return base + slo

    def healthz(self):
        ring, members = self._view()
        census = self._census_snapshot()
        with self._lock:
            now = time.monotonic()
            suspects = sorted(n for n, t in self._suspects.items()
                              if t > now)
        return {"ok": bool(members), "time": time.time(),
                "router": {
                    "fleet_dir": self.fleet_dir,
                    "members": census,
                    "routable": sorted(members),
                    "suspects": suspects,
                    "dead_after_s": self.dead_after_s,
                    "arc_share": {m: round(v, 4) for m, v in
                                  ring.arc_share(samples=512).items()},
                    "uploads": self._journal.ids()}}

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        if self._server is not None:
            return self
        handler = type("_BoundRouterHandler", (_RouterHandler,),
                       {"front": self})
        self._server = http.server.ThreadingHTTPServer(
            self._requested, handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="br-fleet-router")
        self._thread.start()
        self.recorder.event("router_bound",
                            host=self._server.server_address[0],
                            port=self.port)
        return self

    @property
    def port(self):
        if self._server is None:
            raise RuntimeError("FleetRouter not started")
        return self._server.server_address[1]

    @property
    def url(self):
        return f"http://{self._server.server_address[0]}:{self.port}"

    def close(self):
        """Stop the HTTP front (members keep serving; the router holds
        no request state — in-flight forwards on handler threads finish
        their response writes)."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join()
            self._server = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *_exc):
        self.close()
