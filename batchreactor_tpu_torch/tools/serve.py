"""The resident solver daemon of the port: sweep-as-a-service.

The counterpart of the JAX package's ``scripts/serve.py``, with the same
flags (less ``--cache-dir``: the port keeps no persistent program cache)
and the same startup line.  It loads a session spec (``serve.json``, the
reference's file), warms the session (every rung's graphs captured
before the first request) and serves a live request stream from one
warm, continuously batched resident program::

  # HTTP daemon on an ephemeral port (the bound port prints as JSON)
  python -m batchreactor_tpu_torch.tools.serve --spec serve.json

  # stdin-JSONL mode: one request per line in, one response per line
  # out (out-of-order; correlate by id); EOF drains
  python -m batchreactor_tpu_torch.tools.serve --spec serve.json \\
      --jsonl < requests.jsonl

Endpoints: ``POST /solve``, ``POST /mechanism`` (with ``--store``),
``GET /healthz``, ``GET /metrics``.  In HTTP mode SIGTERM (or SIGINT)
drains: the handler only sets an event; the main thread then refuses new
work with ``draining``, answers every accepted request, writes the
flight recorder's ``flight_*.jsonl`` and exits 0.  A CUDA error under a
serving epoch is not retried in this process: its requests fail with
``internal``, the daemon drains and exits 1, for its supervisor to start
a fresh one.  ``--device cpu`` serves on the CPU.
"""

import argparse
import json
import os
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True,
                    help="session spec JSON (serve.json)")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral; the bound port is "
                         "printed in the startup JSON line)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--jsonl", action="store_true",
                    help="stdin-JSONL mode instead of HTTP")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup (the first requests capture "
                         "their graphs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' serves on "
                         "the CPU)")
    ap.add_argument("--flight-dir", default=".",
                    help="directory for flight_*.jsonl postmortem dumps")
    ap.add_argument("--obs-out",
                    help="write the session obs report JSONL here at "
                         "drain: spans, serve_stage_seconds histograms "
                         "and per-request request_trace events")
    ap.add_argument("--store", action="store_true",
                    help="enable the multi-mechanism session store: "
                         "POST /mechanism uploads and per-request 'mech' "
                         "routing; the --spec mechanism is the pinned "
                         "default")
    ap.add_argument("--add-mech", action="append", default=[],
                    metavar="ID=MECH:THERM",
                    help="pre-admit extra mechanisms into the store "
                         "(implies --store); repeatable")
    ap.add_argument("--fleet-dir",
                    help="join a serving fleet: register in this shared "
                         "fleet dir, heartbeat and metrics snapshot while "
                         "alive, drain handshake on teardown")
    ap.add_argument("--member-name",
                    help="fleet member name (default m<pid>); only "
                         "meaningful with --fleet-dir")
    args = ap.parse_args(argv)
    if args.member_name and not args.fleet_dir:
        ap.error("--member-name needs --fleet-dir")
    if args.fleet_dir and args.jsonl:
        ap.error("--fleet-dir is HTTP-mode only (the router forwards "
                 "over HTTP)")
    member_name = (args.member_name or f"m{os.getpid()}"
                   if args.fleet_dir else None)

    from ..obs.live import arm_flight, flight_dump
    from ..serving.scheduler import Scheduler
    from ..serving.server import ServingServer, serve_jsonl
    from ..serving.session import SolverSession

    session = SolverSession.from_spec(args.spec, device=args.device)
    if not args.no_warmup:
        session.warmup(log=lambda m: print(m, file=sys.stderr))
        print(f"[serve] warmup {json.dumps(session.warmup_summary)}",
              file=sys.stderr)
    scheduler = Scheduler(session)
    store = None
    if args.store or args.add_mech:
        from ..serving.session import SessionStore

        store = SessionStore(session, scheduler)
        for spec_str in args.add_mech:
            mid, _, rest = spec_str.partition("=")
            mech, _, therm = rest.partition(":")
            if not (mid and mech and therm):
                ap.error(f"--add-mech wants ID=MECH:THERM, got "
                         f"{spec_str!r}")
            fp = store.add_mechanism(mech, therm, mech_id=mid,
                                     warm=not args.no_warmup)
            print(f"[serve] mechanism {mid!r} resident "
                  f"({fp[:12]}...)", file=sys.stderr)

    # HTTP mode drains on SIGTERM/SIGINT: this handler goes in first and
    # arm_flight wraps it, so SIGTERM dumps the flight ring and then sets
    # the event; the teardown runs on the main thread.  JSONL mode drains
    # on EOF (the parent owns stdin), so the dispositions stay default.
    stop = threading.Event()

    def _on_term(_signum, _frame):
        stop.set()

    if not args.jsonl:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    arm_flight(recorder=session.recorder, dir=args.flight_dir,
               install_signal=True)

    def _write_obs():
        if not args.obs_out:
            return
        from ..obs import write_jsonl

        write_jsonl(args.obs_out, session.obs_report())
        print(f"[serve] obs report -> {args.obs_out}", file=sys.stderr)

    with session:
        if args.jsonl:
            scheduler.start()
            accepted, rejected = serve_jsonl(session, scheduler,
                                             sys.stdin, sys.stdout)
            _write_obs()
            print(json.dumps({"served": {
                "accepted": accepted, "rejected": rejected,
                "compiles": session.compile_summary()["compiles"]}}),
                file=sys.stderr)
            return 1 if session.fatal is not None else 0
        with ServingServer(session, scheduler, port=args.port,
                           host=args.host, store=store) as srv:
            if args.fleet_dir:
                # register once the port is bound and the stream is live;
                # ServingServer.close runs the drain handshake
                from ..fleet import MemberRegistration

                srv.membership = MemberRegistration(
                    args.fleet_dir, member_name, srv.url,
                    pid=os.getpid(), registry=session.registry)
                srv.membership.register()
            print(json.dumps({"serving": {
                "url": srv.url, "port": srv.port, "pid": os.getpid(),
                "fingerprint": session.fingerprint,
                "bucket_cap": session.bucket_cap,
                "fleet": (None if not args.fleet_dir else
                          {"dir": args.fleet_dir, "member": member_name}),
                "store": (None if store is None else
                          [m["ids"] for m in store.mechanisms()]),
                "warmed": (None if session.warmed is None else
                           [f"{w['energy'] or 'isothermal'}/b{w['rung']}"
                            f"/{w['linsolve']}/{w['source']}"
                            for w in session.warmed])}}),
                  flush=True)
            while not stop.wait(0.25):
                if session.fatal is not None:
                    print(f"[serve] device fault: {session.fatal}; "
                          f"draining", file=sys.stderr)
                    break
            print("[serve] drain requested; answering in-flight work",
                  file=sys.stderr)
            # ServingServer.close drains the scheduler (every accepted
            # request answers) before stopping the HTTP thread
        flight_dump("serve-drain")
        _write_obs()
        w = session.compile_summary()
        print(json.dumps({"drained": {
            "compiles": w["compiles"], "retraces": w["retraces"],
            "fatal": (None if session.fatal is None
                      else f"{type(session.fatal).__name__}: "
                           f"{session.fatal}")}}),
            file=sys.stderr)
    return 1 if session.fatal is not None else 0


if __name__ == "__main__":
    sys.exit(main())
