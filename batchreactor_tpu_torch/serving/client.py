"""Client + load-trace tooling for the serving daemon.

:class:`SolveClient` is the minimal stdlib HTTP client (urllib) the
tests, ``tools/serve_bench.py``, and operators use: ``solve`` posts a
schema request and returns the parsed response, raising
:class:`ServeError` (with the server's error code) on anything but
``status == "ok"``.

:func:`poisson_trace` builds the SEEDED open-loop request trace the
bench protocol measures under: exponential inter-arrival gaps at a
target rate, deterministic per seed — two runs of the same seed issue
byte-identical schedules, so a latency regression is a change in the
server, not the load.  :func:`run_trace` fires a trace against a
client from worker threads (open-loop: a slow response does not slow
the arrival process — the honest way to find the knee) and returns
per-request latency records for the p50/p95/p99 + cond/s summary
(:func:`summarize`); when the requests carried ``trace: true``,
:func:`trace_summary` adds the server-side stage decomposition and the
client~server latency-attribution check (docs/observability.md
"Request tracing").
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request


class ServeError(RuntimeError):
    """A non-ok response; ``code`` is the schema error code and
    ``response`` the parsed body (when the server sent one)."""

    def __init__(self, code, message, response=None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.response = response


class SolveClient:
    """Module doc.  ``url`` is the daemon base url
    (``http://host:port``)."""

    def __init__(self, url, timeout=300.0):
        self.url = url.rstrip("/")
        self.timeout = float(timeout)

    def _get(self, path):
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout) as r:
            return r.read().decode()

    def healthz(self):
        return json.loads(self._get("/healthz"))

    def metrics(self):
        """The raw Prometheus exposition text."""
        return self._get("/metrics")

    def solve(self, request):
        """POST one request object; returns the parsed ``ok`` response
        or raises :class:`ServeError` with the server's code."""
        body = json.dumps(request).encode()
        req = urllib.request.Request(
            self.url + "/solve", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                resp = json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                resp = json.loads(e.read().decode())
            except (ValueError, OSError):
                raise ServeError("internal",
                                 f"HTTP {e.code}: {e.reason}") from None
            err = resp.get("error") or {}
            raise ServeError(err.get("code", "internal"),
                             err.get("message", f"HTTP {e.code}"),
                             resp) from None
        if resp.get("status") != "ok":
            err = resp.get("error") or {}
            raise ServeError(err.get("code", "internal"),
                            err.get("message", "non-ok response"), resp)
        return resp

    def upload_mechanism(self, mech_id, mech_text, therm_text,
                         warm=True):
        """POST one mechanism upload (``POST /mechanism`` —
        schema.validate_upload grammar); returns the parsed ``ok``
        response (fingerprint, species, warm state) or raises
        :class:`ServeError`."""
        body = json.dumps({"id": str(mech_id), "mech": mech_text,
                           "therm": therm_text,
                           "warm": bool(warm)}).encode()
        req = urllib.request.Request(
            self.url + "/mechanism", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                resp = json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                resp = json.loads(e.read().decode())
            except (ValueError, OSError):
                raise ServeError("internal",
                                 f"HTTP {e.code}: {e.reason}") from None
            err = resp.get("error") or {}
            raise ServeError(err.get("code", "internal"),
                             err.get("message", f"HTTP {e.code}"),
                             resp) from None
        if resp.get("status") != "ok":
            err = resp.get("error") or {}
            raise ServeError(err.get("code", "internal"),
                             err.get("message", "non-ok response"), resp)
        return resp


def with_trace_ctx(request, trace_id=None, span="client"):
    """Attach a distributed-trace envelope (``schema.trace_ctx_payload``
    — docs/observability.md "Fleet tracing") to a copy of ``request``.
    The default trace id derives from the request id (``t-<id>``) —
    DETERMINISTIC, no rng draw, so a seeded :func:`poisson_trace`
    schedule stays byte-identical with tracing on, and the bench can
    re-derive each record's trace id to join client latency against
    the stitched fleet waterfall."""
    from .schema import trace_ctx_payload

    req = dict(request)
    tid = (f"t-{req.get('id')}" if trace_id is None else trace_id)
    req["trace_ctx"] = trace_ctx_payload(tid, span=span)
    return req


def poisson_trace(n_requests, rate_hz, seed, make_request):
    """The seeded open-loop trace: ``[(send_at_s, request), ...]`` with
    exponential inter-arrival gaps at ``rate_hz`` mean arrivals/s.
    ``make_request(i, rng)`` builds request ``i`` (the rng is the
    trace's own — condition randomization stays inside the seed)."""
    rng = random.Random(int(seed))
    t = 0.0
    out = []
    for i in range(int(n_requests)):
        t += rng.expovariate(float(rate_hz))
        out.append((t, make_request(i, rng)))
    return out


def run_trace(client, trace, on_result=None):
    """Fire a :func:`poisson_trace` schedule open-loop: each request is
    posted from its own thread at its scheduled instant.  Returns one
    record per request: ``{"id", "send_at", "latency_s", "ok",
    "code", "response"}`` in trace order."""
    records = [None] * len(trace)
    threads = []
    t0 = time.perf_counter()

    def _fire(i, send_at, request):
        delay = send_at - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        sent = time.perf_counter()
        try:
            resp = client.solve(request)
            ok, code = True, None
        except ServeError as e:
            resp, ok, code = e.response, False, e.code
        except OSError as e:
            # transport-level failure (connection reset/refused under
            # overload, daemon gone): a record, not a dead thread — the
            # summary must account for every request fired
            resp, ok, code = {"error": str(e)}, False, "transport"
        records[i] = {"id": request.get("id", i), "send_at": send_at,
                      "latency_s": time.perf_counter() - sent,
                      "ok": ok, "code": code, "response": resp}
        if on_result is not None:
            on_result(records[i])

    for i, (send_at, request) in enumerate(trace):
        th = threading.Thread(target=_fire, args=(i, send_at, request),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    return records


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]


def summarize(records, wall_s):
    """The bench summary: counts,
    sustained cond/s over the trace wall, and latency percentiles over
    the ANSWERED requests."""
    ok = [r for r in records if r and r["ok"]]
    lat = sorted(r["latency_s"] for r in ok)
    lanes = sum(len((r["response"] or {}).get("t", []))
                for r in ok)
    return {
        "requests": len(records),
        "answered": len(ok),
        "rejected": sum(1 for r in records
                        if r and not r["ok"]),
        "lanes": lanes,
        "wall_s": round(wall_s, 4),
        "cond_per_s": round(lanes / wall_s, 3) if wall_s > 0 else None,
        "p50_ms": round(1e3 * _percentile(lat, 0.50), 3) if lat else None,
        "p95_ms": round(1e3 * _percentile(lat, 0.95), 3) if lat else None,
        "p99_ms": round(1e3 * _percentile(lat, 0.99), 3) if lat else None,
    }


def trace_summary(records, attribution_tol_ms=2000.0):
    """The SERVER-side half of the bench evidence, from the ``trace``
    sections of answered responses (requests sent with ``trace:
    true``): per-stage p50/p95/mean over the waterfall segments
    (obs/trace.py vocabulary), server total percentiles, and the
    client~server attribution check — client ``latency_s`` must cover
    the server ``submitted -> resolved`` wall (small negative slack
    for clock granularity) and exceed it by at most
    ``attribution_tol_ms`` of transport/thread-wakeup overhead, which
    pins the two clocks against stage-attribution bugs.  Returns
    ``None`` when no record carries a trace."""
    traced = [(r, r["response"]["trace"]) for r in records
              if r and r["ok"] and (r.get("response") or {}).get("trace")]
    if not traced:
        return None
    by_stage = {}
    for _r, tr in traced:
        for stage, dur in (tr.get("segments") or {}).items():
            by_stage.setdefault(stage, []).append(float(dur))

    def pct(vals, q):
        return _percentile(sorted(vals), q)

    totals = [float(tr["total_s"]) for _r, tr in traced]
    gaps_ms = [1e3 * (r["latency_s"] - float(tr["total_s"]))
               for r, tr in traced]
    violations = [
        {"id": r["id"], "gap_ms": round(g, 3)}
        for (r, _t), g in zip(traced, gaps_ms)
        if g < -5.0 or g > attribution_tol_ms]
    return {
        "server_stages": {
            stage: {"n": len(durs),
                    "mean_ms": round(1e3 * sum(durs) / len(durs), 3),
                    "p50_ms": round(1e3 * pct(durs, 0.50), 3),
                    "p95_ms": round(1e3 * pct(durs, 0.95), 3)}
            for stage, durs in sorted(by_stage.items())},
        "server_total_p50_ms": round(1e3 * pct(totals, 0.50), 3),
        "server_total_p95_ms": round(1e3 * pct(totals, 0.95), 3),
        "attribution": {
            "n": len(gaps_ms),
            "max_gap_ms": round(max(gaps_ms), 3),
            "p50_gap_ms": round(pct(gaps_ms, 0.50), 3),
            "tol_ms": attribution_tol_ms,
            "ok": not violations,
            "violations": violations[:8]},
    }


def stitched_attribution(records, stitched, attribution_tol_ms=2000.0):
    """The :func:`trace_summary` attribution check EXTENDED ACROSS THE
    ROUTER HOP (docs/observability.md "Fleet tracing"): client
    ``latency_s`` vs the stitched trace's end-to-end ``total_s``
    (``obs.stitch`` — the router's wall, which brackets every hop).
    Records join their trace by the :func:`with_trace_ctx` derivation
    ``t-<id>``.  Same gap rule as the single-host check: the client
    must cover the stitched wall (>= -5 ms clock slack) and exceed it
    by at most ``attribution_tol_ms``.  Returns ``None`` when nothing
    joined — the caller treats that as "tracing was off", not a
    pass."""
    by_trace = {}
    for t in stitched:
        if t.get("trace") is not None and t.get("total_s") is not None:
            by_trace.setdefault(t["trace"], t)
    gaps_ms, violations = [], []
    for r in records:
        if not r or not r["ok"]:
            continue
        t = by_trace.get(f"t-{r['id']}")
        if t is None:
            continue
        g = 1e3 * (r["latency_s"] - float(t["total_s"]))
        gaps_ms.append(g)
        if g < -5.0 or g > attribution_tol_ms:
            violations.append({"id": r["id"], "gap_ms": round(g, 3)})
    if not gaps_ms:
        return None
    return {"n": len(gaps_ms),
            "max_gap_ms": round(max(gaps_ms), 3),
            "p50_gap_ms": round(_percentile(sorted(gaps_ms), 0.50), 3),
            "tol_ms": attribution_tol_ms,
            "ok": not violations,
            "violations": violations[:8]}
