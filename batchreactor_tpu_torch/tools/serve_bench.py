"""Serving load generator: seeded Poisson trace -> cond/s + latency.

The counterpart of the JAX package's ``scripts/serve_bench.py``: stand up
a daemon of the port (in-process by default, over real localhost HTTP;
``--url`` targets an external one), warm it, fire a seeded open-loop
Poisson request trace through ``serving.client``, and report sustained
cond/s, p50/p95/p99 latency, scheduler rejections, and the warm contract
(no graph captured, no program built) over the serving window::

  python -m batchreactor_tpu_torch.tools.serve_bench \\
      --spec tests/fixtures/serve_h2o2.json --device cpu \\
      --requests 40 --rate 20 --seed 0 --out bench.json

The trace randomizes T within ``--T-lo/--T-hi`` and lane counts within
``--lanes`` (e.g. ``1,4``) from the seed's own rng, so two runs of one
seed issue identical schedules and identical conditions.

Requests carry ``trace: true`` by default (``--no-trace`` drops it), so
the summary reports the server-side stage decomposition next to the
client percentiles, and every answered request's client ``latency_s`` is
checked against the server ``submitted -> resolved`` wall (the gap must
stay under ``--attribution-tol-ms``).  ``--obs-out`` banks the
in-process session's obs report JSONL.

Fleet mode (``--router N``) stands up N in-process members and the
consistent-hash router, attaches a deterministic ``trace_ctx`` per
request (trace id ``t-<request id>``), stitches the members' and the
router's trace streams after the run (``obs.stitch``), and extends the
attribution check across the router hop.
"""

import argparse
import json
import os
import sys
import time

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", help="session spec JSON (required unless "
                                   "--url targets a running daemon)")
    ap.add_argument("--url", help="bench an already-running daemon "
                                  "instead of standing one up")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean request arrivals per second")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", default="1,4",
                    help="lane-count choices per request, comma list")
    ap.add_argument("--T-lo", type=float, default=1100.0)
    ap.add_argument("--T-hi", type=float, default=1500.0)
    ap.add_argument("--comp", default="H2=0.3,O2=0.15,N2=0.55",
                    help="inlet mole fractions, SP=x comma-separated")
    ap.add_argument("--mechs", action="append", default=[],
                    metavar="ID=MECH:THERM",
                    help="multi-mechanism preset: upload these extra "
                         "mechanisms over POST /mechanism before the "
                         "trace and route requests across the whole set "
                         "from the seed's rng; the summary gains "
                         "per-mechanism cond/s + the compile/wall "
                         "split.  Repeatable; "
                         "in-process daemons get the session store "
                         "automatically")
    ap.add_argument("--t1", type=float, default=5e-5,
                    help="integration horizon per request [s]")
    ap.add_argument("--t1-choices",
                    help="comma list of t1 horizons drawn per request "
                         "from the seed's rng (fleet benches: t1 is part "
                         "of the routing key, so a spread of horizons "
                         "spreads load across the hash ring; a single "
                         "t1 legitimately pins every request to ONE "
                         "member — that is affinity working)")
    ap.add_argument("--router", type=int, default=0, metavar="N",
                    help="fleet mode: stand up N in-process member "
                         "daemons + the consistent-hash router "
                         "(fleet.FleetRouter) and bench THROUGH the "
                         "router; the summary gains per-host cond/s "
                         "and the direct-vs-failover latency split")
    ap.add_argument("--fleet-dir",
                    help="fleet membership dir for --router (default: "
                         "a fresh temp dir)")
    ap.add_argument("--epochs", type=int, metavar="N",
                    help="override the spec's serve.resident_epochs "
                         "(capacity plane): N resident streaming "
                         "epochs pull from one shared admission queue; "
                         "the A/B lever for the multi-epoch PERF "
                         "rounds (needs --spec)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of in-process daemons (default: "
                         "cuda; 'cpu' serves on the CPU)")
    ap.add_argument("--out", help="write the summary JSON here too")
    ap.add_argument("--scrape-out",
                    help="save a MID-TRACE /metrics scrape here (the CI "
                         "serve-smoke artifact)")
    ap.add_argument("--require-success", action="store_true",
                    help="exit 1 unless every request is answered ok "
                         "with all-success per-lane provenance (and, "
                         "with traces on, client~server latency "
                         "attribution within tolerance)")
    ap.add_argument("--no-trace", action="store_true",
                    help="drop the trace:true request key (the "
                         "plain request shape; disables the "
                         "server-stage summary + attribution check)")
    ap.add_argument("--attribution-tol-ms", type=float, default=2000.0,
                    help="max client latency minus server "
                         "submitted->resolved wall per request "
                         "(transport + client-thread-wakeup overhead; "
                         "p50 is ~20 ms but open-loop thread "
                         "contention spikes the tail, so the default "
                         "stays CI-loose — an attribution BUG shows "
                         "as server > client or a gap of order the "
                         "total latency, far outside any band here)")
    ap.add_argument("--obs-out",
                    help="write the in-process session's obs report "
                         "JSONL here after the trace (histograms + "
                         "request_trace events; the obs_gate.py / "
                         "obs_trace.py input — needs --spec).  With "
                         "--router, writes the MERGED fleet report "
                         "(router route_seconds + every member's "
                         "serve_stage_seconds, obs.stitch."
                         "merge_reports)")
    args = ap.parse_args(argv)
    if not args.url and not args.spec:
        ap.error("--spec (in-process daemon) or --url (external) needed")
    if args.epochs is not None and not args.spec:
        ap.error("--epochs overrides the spec's serve.resident_epochs; "
                 "it needs --spec (an external daemon fixes its own)")
    spec_arg = args.spec
    if args.epochs is not None:
        with open(args.spec) as fh:
            spec_arg = json.load(fh)
        # a dict spec loses the file's directory, so pre-resolve the
        # relative mechanism paths the way load_spec(path) would
        base = os.path.dirname(os.path.abspath(args.spec))
        for k in ("mech", "therm"):
            p = (spec_arg.get("mechanism") or {}).get(k)
            if isinstance(p, str) and not os.path.isabs(p):
                spec_arg["mechanism"][k] = os.path.join(base, p)
        spec_arg.setdefault("serve", {})["resident_epochs"] = args.epochs
    if args.obs_out and args.url:
        ap.error("--obs-out reads the in-process session's recorder; "
                 "use --spec (an external daemon writes its own via "
                 "tools/serve.py --obs-out)")
    if args.router:
        if args.url:
            ap.error("--router stands up its own fleet; to bench an "
                     "external fleet, point --url at its router")
        if args.mechs:
            ap.error("--router does not combine with --mechs "
                     "(one session store vs N hosts)")

    from ..serving.client import (SolveClient,
                                                 poisson_trace,
                                                 run_trace,
                                                 stitched_attribution,
                                                 summarize,
                                                 trace_summary,
                                                 with_trace_ctx)

    comp = {}
    for part in args.comp.split(","):
        name, _, val = part.partition("=")
        comp[name.strip()] = float(val)
    lane_choices = [int(v) for v in args.lanes.split(",")]
    mech_specs = []
    for spec_str in args.mechs:
        mid, _, rest = spec_str.partition("=")
        mech, _, therm = rest.partition(":")
        if not (mid and mech and therm):
            ap.error(f"--mechs wants ID=MECH:THERM, got {spec_str!r}")
        mech_specs.append((mid, mech, therm))
    #: the routing choices the seeded rng draws from — None is the
    #: daemon's default mechanism; uploads join before the trace fires
    mech_choices = [None] + [m[0] for m in mech_specs]
    t1_choices = ([float(v) for v in args.t1_choices.split(",")]
                  if args.t1_choices else [args.t1])

    def make_request(i, rng):
        k = rng.choice(lane_choices)
        t1 = args.t1
        if len(t1_choices) > 1:
            # draw only with a real spread: an unconditional draw would
            # consume rng state and change every seeded baseline trace
            t1 = rng.choice(t1_choices)
        req = {"id": f"bench-{args.seed}-{i}",
               "T": [round(rng.uniform(args.T_lo, args.T_hi), 3)
                     for _ in range(k)],
               "X": comp, "t1": t1}
        if not args.no_trace:
            # no rng draw: the seeded schedule/conditions stay
            # identical with traces on or off
            req["trace"] = True
            # the distributed-trace envelope is deterministic too
            # (trace id t-<request id> — with_trace_ctx), so the bench
            # can join each client record against its stitched fleet
            # trace without responses carrying ids
            req = with_trace_ctx(req)
        if len(mech_choices) > 1:
            # draw only in multi-mechanism mode: an unconditional draw
            # would consume rng state and silently change every seeded
            # single-mechanism trace
            mech = rng.choice(mech_choices)
            if mech is not None:
                req["mech"] = mech
        return req

    trace = poisson_trace(args.requests, args.rate, args.seed,
                          make_request)

    session = server = store = None
    fleet_hosts, fleet_router = [], None
    if args.url:
        url = args.url
    elif args.router:
        # fleet mode: N member daemons in-process (real localhost HTTP
        # each), registered into one fleet dir, benched THROUGH the
        # consistent-hash router — requests spread across hosts only as
        # far as their routing keys spread (--t1-choices)
        import tempfile

        
        from ..fleet import FleetRouter, MemberRegistration
        from ..serving.scheduler import Scheduler
        from ..serving.server import ServingServer
        from ..serving.session import SolverSession

        fleet_dir = args.fleet_dir or tempfile.mkdtemp(
            prefix="br-fleet-bench-")
        for i in range(args.router):
            name = f"m{i + 1}"
            s = SolverSession.from_spec(spec_arg, device=args.device)
            if not args.no_warmup:
                s.warmup(log=lambda m: print(m, file=sys.stderr))
            s.__enter__()
            srv = ServingServer(s, Scheduler(s)).start()
            srv.membership = MemberRegistration(
                fleet_dir, name, srv.url, registry=s.registry,
                pid=f"{os.getpid()}-{name}").register()
            fleet_hosts.append((name, s, srv))
            print(f"[serve-bench] fleet member {name} @ {srv.url}",
                  file=sys.stderr)
        fleet_router = FleetRouter(fleet_dir).start()
        url = fleet_router.url
    else:
        
        from ..serving.scheduler import Scheduler
        from ..serving.server import ServingServer
        from ..serving.session import (SessionStore,
                                                      SolverSession)

        session = SolverSession.from_spec(spec_arg, device=args.device)
        if not args.no_warmup:
            session.warmup(log=lambda m: print(m, file=sys.stderr))
        session.__enter__()
        scheduler = Scheduler(session)
        if mech_specs:
            store = SessionStore(session, scheduler)
        server = ServingServer(session, scheduler, store=store).start()
        url = server.url

    client = SolveClient(url)
    upload_s = 0.0
    if mech_specs:
        # the upload path IS the measured surface: route the extra
        # mechanisms through POST /mechanism like any client would
        # (works against --url daemons too), timing the warm-in wall
        t_up = time.perf_counter()
        for mid, mech, therm in mech_specs:
            with open(mech) as f:
                mech_text = f.read()
            with open(therm) as f:
                therm_text = f.read()
            resp = client.upload_mechanism(mid, mech_text, therm_text,
                                           warm=not args.no_warmup)
            print(f"[serve-bench] mechanism {mid!r} resident "
                  f"(shape {resp.get('mech_shape')}, armed compiles "
                  f"{sum((resp.get('program_compiles') or {}).values())})",
                  file=sys.stderr)
        upload_s = time.perf_counter() - t_up
    scrapes = []
    answered = [0]

    def on_result(_rec):
        answered[0] += 1
        # one mid-trace scrape once the stream is demonstrably hot
        if args.scrape_out and len(scrapes) < 1 and answered[0] >= max(
                2, args.requests // 4):
            try:
                scrapes.append(client.metrics())
            except OSError:
                pass

    print(f"[serve-bench] {args.requests} requests @ ~{args.rate}/s "
          f"(seed {args.seed}) -> {url}", file=sys.stderr)
    t0 = time.perf_counter()
    records = run_trace(client, trace, on_result=on_result)
    wall = time.perf_counter() - t0
    if args.scrape_out and not scrapes:
        try:
            scrapes.append(client.metrics())
        except OSError:
            pass

    summary = summarize(records, wall)
    summary["seed"] = args.seed
    summary["rate_hz"] = args.rate
    summary["t1"] = args.t1
    if mech_specs:
        # per-mechanism split: lanes answered / shared trace wall (the
        # mechanisms ride ONE daemon, so per-mechanism cond/s sum to
        # the total) + the upload/warm-in wall
        per = {}
        for (_at, req), rec in zip(trace, records):
            key = req.get("mech") or "default"
            d = per.setdefault(key, {"requests": 0, "answered": 0,
                                     "lanes": 0})
            d["requests"] += 1
            if rec and rec["ok"]:
                d["answered"] += 1
                d["lanes"] += len((rec["response"] or {}).get("t", []))
        for d in per.values():
            d["cond_per_s"] = (round(d["lanes"] / wall, 3)
                               if wall > 0 else None)
        summary["per_mechanism"] = per
        summary["mech_upload_s"] = round(upload_s, 3)
    all_success = all(
        r and r["ok"]
        and all(p == "success"
                for p in (r["response"] or {}).get("provenance", ["x"]))
        for r in records)
    summary["all_success"] = bool(all_success)

    # the server-side half of the evidence: stage decomposition next to
    # the client percentiles + the client~server attribution check
    # (serving.client.trace_summary — a violation is a clock or
    # stage-attribution bug)
    attribution_ok = True
    tsum = trace_summary(records,
                         attribution_tol_ms=args.attribution_tol_ms)
    if tsum is not None:
        attribution_ok = tsum["attribution"]["ok"]
        summary.update(tsum)
        if not attribution_ok:
            print(f"[serve-bench] ATTRIBUTION violations (first 8): "
                  f"{tsum['attribution']['violations']}",
                  file=sys.stderr)

    if fleet_router is not None:
        # the fleet evidence: where each answer came from (response
        # provenance from the router's "router" block), per-host
        # cond/s, and the direct-vs-failover latency split
        per_host = {}
        direct, failover = [], []
        for rec in records:
            if not rec:
                continue
            rinfo = (rec["response"] or {}).get("router") or {}
            host = rinfo.get("host", "?")
            d = per_host.setdefault(host, {"requests": 0, "answered": 0,
                                           "lanes": 0, "failovers": 0})
            d["requests"] += 1
            if rec["ok"]:
                d["answered"] += 1
                d["lanes"] += len((rec["response"] or {}).get("t", []))
            if rinfo.get("failover"):
                d["failovers"] += 1
                failover.append(rec["latency_s"])
            else:
                direct.append(rec["latency_s"])
        for d in per_host.values():
            d["cond_per_s"] = (round(d["lanes"] / wall, 3)
                               if wall > 0 else None)

        def _lat(vals):
            if not vals:
                return None
            vals = sorted(vals)

            def _pct(p):
                k = min(len(vals) - 1, max(0, round(p * (len(vals) - 1))))
                return round(vals[int(k)] * 1e3, 1)

            return {"n": len(vals), "p50_ms": _pct(0.5),
                    "p95_ms": _pct(0.95), "max_ms": _pct(1.0)}

        summary["fleet"] = {
            "hosts": args.router,
            "per_host": per_host,
            "latency_direct": _lat(direct),
            "latency_failover": _lat(failover)}
        # per-host compile evidence: the warm-serving contract holds on
        # every member, not just in aggregate
        summary["per_host_compiles"] = {}
        for name, s, srv in fleet_hosts:
            srv.close()   # drain handshake: mark_draining -> deregister
            summary["per_host_compiles"][name] = s.program_compiles()
        summary["program_compiles"] = sum(
            sum(d.values()) for d in summary["per_host_compiles"].values())
        fleet_router.close()

        # the stitched cross-host story (docs/observability.md "Fleet
        # tracing"): every member's trace stream + the router's hop
        # ledger joined in-process — the attribution check
        # EXTENDED across the router hop (client latency must cover
        # the stitched end-to-end wall)
        from ..obs import build_report
        from ..obs.stitch import merge_reports
        from ..obs.stitch import stitch as stitch_fleet

        fleet_reports = [(name, s.obs_report())
                         for name, s, _srv in fleet_hosts]
        fleet_reports.append(("router", build_report(
            recorder=fleet_router.recorder,
            meta={"entry": "fleet-router", "bench_seed": args.seed,
                  "bench_rate_hz": args.rate})))
        stitched = stitch_fleet(fleet_reports)
        if not args.no_trace:
            sattr = stitched_attribution(
                records, stitched,
                attribution_tol_ms=args.attribution_tol_ms)
            if sattr is not None:
                summary["fleet"]["stitched_attribution"] = sattr
                attribution_ok = attribution_ok and sattr["ok"]
                if not sattr["ok"]:
                    print(f"[serve-bench] STITCHED attribution "
                          f"violations (first 8): "
                          f"{sattr['violations']}", file=sys.stderr)
        if args.obs_out:
            from ..obs import write_jsonl

            write_jsonl(args.obs_out, merge_reports(fleet_reports))
            print(f"[serve-bench] merged fleet obs report -> "
                  f"{args.obs_out}", file=sys.stderr)

        for _name, s, _srv in fleet_hosts:
            s.__exit__(None, None, None)

    if server is not None:
        if store is not None:
            # the capture/wall split per resident mechanism
            summary["per_mechanism_compiles"] = {
                "+".join(m["ids"]) or m["fingerprint"][:12]:
                    m["program_compiles"]
                for m in store.mechanisms()}
        server.close()
        if args.obs_out:
            from ..obs import write_jsonl

            write_jsonl(args.obs_out, session.obs_report(
                meta={"bench_seed": args.seed,
                      "bench_rate_hz": args.rate}))
            print(f"[serve-bench] obs report -> {args.obs_out}",
                  file=sys.stderr)
        w = session.compile_summary()
        # the capacity-plane levers this run served under + their
        # autoscaler evidence ride every summary
        summary["resident_epochs"] = int(
            getattr(session, "resident_epochs", 1))
        summary["mesh_resident"] = getattr(session, "mesh_resident",
                                           None)
        summary["bucket_upshifts"] = int(
            session.recorder.snapshot()[2].get("bucket_upshifts", 0))
        # program_compiles is the warm-serving contract (0 after
        # warmup): graphs captured and programs built on the armed
        # labels
        summary["program_compiles"] = session.program_compiles()
        summary["compiles"] = w["compiles"]
        summary["compile_s"] = round(w.get("compile_s", 0.0), 3)
        summary["retraces"] = w["retraces"]
        session.__exit__(None, None, None)
    if scrapes and args.scrape_out:
        with open(args.scrape_out, "w") as fh:
            fh.write(scrapes[-1])
        print(f"[serve-bench] mid-trace scrape -> {args.scrape_out}",
              file=sys.stderr)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    if args.require_success and not (all_success and attribution_ok):
        if not all_success:
            bad = [r["id"] for r in records
                   if not (r and r["ok"])][:8]
            print(f"[serve-bench] FAILED requests (first 8): {bad}",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
