"""The replicated serving tier under one supervisor.

The counterpart of the JAX package's ``scripts/serve_fleet.py``.  Spawns
N member daemons (``python -m batchreactor_tpu_torch.tools.serve``), each
registering into the shared fleet dir, then starts the in-process
:class:`fleet.FleetRouter` over them and prints one startup JSON line
with the router URL and every member's pid::

  python -m batchreactor_tpu_torch.tools.serve_fleet --spec serve.json \\
      -n 2 --fleet-dir fleet

  {"fleet": {"url": ..., "port": ..., "pid": ..., "members": [...]}}

Clients speak to the router exactly as they would to one daemon
(``POST /solve`` / ``POST /mechanism`` / ``GET /metrics`` /
``GET /healthz``); requests consistent-hash by (mechanism, pack key) so
each member's warmed graphs and resident epochs stay hot.  Kill a member
(``kill -9``) and its hash arcs reassign to the survivors: the router
fails the in-flight forwards over with retry provenance in the
response's ``router`` block, and the fleet keeps answering.

SIGTERM/SIGINT drains: members get SIGTERM (each answers its accepted
work, runs the drain handshake, deregisters), then the router stops.  A
member that dies on its own does not take the supervisor down.  The
supervisor touches no device: the routing plane must come up, and stay
up, on a host whose devices are wedged.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time


def _relay(proc, name):
    """Copy one member's stdout to our stderr, prefixed — the member's
    startup JSON and serve logs stay visible without stealing the
    supervisor's stdout (which carries OUR startup JSON line)."""

    def _pump():
        for line in proc.stdout:
            sys.stderr.write(f"[{name}] {line.decode(errors='replace')}")
            sys.stderr.flush()

    t = threading.Thread(target=_pump, daemon=True,
                         name=f"br-fleet-relay-{name}")
    t.start()
    return t


def spawn_member(args, name):
    cmd = [sys.executable, "-m", "batchreactor_tpu_torch.tools.serve",
           "--spec", args.spec, "--fleet-dir", args.fleet_dir,
           "--member-name", name, "--flight-dir", args.flight_dir]
    if args.device:
        cmd += ["--device", args.device]
    if args.obs_dir:
        # one trace stream per host, file stem = member name — the
        # obs.stitch join convention (fleet.member_obs_path layout)
        cmd += ["--obs-out", os.path.join(args.obs_dir,
                                          f"{name}.jsonl")]
    if args.no_warmup:
        cmd += ["--no-warmup"]
    if args.store:
        cmd += ["--store"]
    for spec_str in args.add_mech:
        cmd += ["--add-mech", spec_str]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=sys.stderr)
    _relay(proc, name)
    return proc


def wait_routable(fleet_dir, want, procs, timeout_s, dead_after_s):
    """Block until ``want`` members are routable in ``fleet_dir`` (each
    registers only after its port is bound and its stream is live).  A
    member that exits before registering aborts the launch loudly."""
    from ..fleet import read_members

    deadline = time.monotonic() + timeout_s
    while True:
        members = [m for m in read_members(fleet_dir, dead_after_s)
                   if m.routable]
        if len(members) >= want:
            return members
        for name, proc in procs.items():
            rc = proc.poll()
            if rc is not None:
                raise SystemExit(
                    f"[serve_fleet] member {name} exited rc={rc} "
                    f"before registering — aborting launch")
        if time.monotonic() >= deadline:
            raise SystemExit(
                f"[serve_fleet] {len(members)}/{want} members routable "
                f"after {timeout_s:.0f}s — aborting launch")
        time.sleep(0.2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True,
                    help="session spec JSON, shared by every member")
    ap.add_argument("-n", "--members", type=int, default=2,
                    help="member daemon count (default 2)")
    ap.add_argument("--fleet-dir", required=True,
                    help="shared membership/telemetry directory")
    ap.add_argument("--device", default=None,
                    help="the members' torch device (default: cuda)")
    ap.add_argument("--port", type=int, default=0,
                    help="router HTTP port (0 = ephemeral, printed in "
                         "the startup JSON)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--no-warmup", action="store_true",
                    help="members skip their warmup")
    ap.add_argument("--store", action="store_true",
                    help="members run the multi-mechanism store "
                         "(enables POST /mechanism replication)")
    ap.add_argument("--add-mech", action="append", default=[],
                    metavar="ID=MECH:THERM",
                    help="forwarded to every member (implies --store)")
    ap.add_argument("--flight-dir", default=".",
                    help="members' flight_*.jsonl postmortem directory")
    ap.add_argument("--obs-dir", nargs="?", const="auto", default=None,
                    metavar="DIR",
                    help="write per-host trace streams here at drain "
                         "(router.jsonl + one <member>.jsonl each — "
                         "the obs.stitch layout); bare --obs-dir means "
                         "<fleet_dir>/obs")
    ap.add_argument("--dead-after-s", type=float, default=None,
                    help="heartbeat age past which a member is dead "
                         "(default fleet.DEFAULT_DEAD_AFTER_S)")
    ap.add_argument("--startup-timeout", type=float, default=600.0,
                    help="seconds to wait for all members to warm up "
                         "and register")
    args = ap.parse_args(argv)
    if args.add_mech:
        args.store = True

    from ..fleet import DEFAULT_DEAD_AFTER_S, FleetRouter

    dead_after_s = (DEFAULT_DEAD_AFTER_S if args.dead_after_s is None
                    else args.dead_after_s)
    os.makedirs(args.fleet_dir, exist_ok=True)
    if args.obs_dir == "auto":
        from ..fleet import obs_dir as _fleet_obs_dir

        args.obs_dir = _fleet_obs_dir(args.fleet_dir)
    elif args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)

    procs = {}
    for i in range(args.members):
        name = f"m{i + 1}"
        procs[name] = spawn_member(args, name)
        print(f"[serve_fleet] member {name} pid={procs[name].pid}",
              file=sys.stderr)

    stop = threading.Event()

    def _on_term(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    try:
        wait_routable(args.fleet_dir, args.members, procs,
                      args.startup_timeout, dead_after_s)
    except SystemExit:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        raise

    with FleetRouter(args.fleet_dir, port=args.port, host=args.host,
                     dead_after_s=dead_after_s) as router:
        print(json.dumps({"fleet": {
            "url": router.url, "port": router.port, "pid": os.getpid(),
            "fleet_dir": args.fleet_dir,
            "members": [{"name": name, "pid": proc.pid}
                        for name, proc in procs.items()]}}),
              flush=True)
        stop.wait()
        print("[serve_fleet] drain requested; terminating members",
              file=sys.stderr)
        # members first (each drains its accepted work under SIGTERM),
        # router second — a request arriving mid-drain fails over until
        # the last member flags draining, then answers 503/internal
        # honestly rather than hanging on a dead connection
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for name, proc in procs.items():
            try:
                rc = proc.wait(timeout=60)
                print(f"[serve_fleet] member {name} exited rc={rc}",
                      file=sys.stderr)
            except subprocess.TimeoutExpired:
                print(f"[serve_fleet] member {name} drain timed out; "
                      f"killing", file=sys.stderr)
                proc.kill()
        if args.obs_dir:
            # the router's half of the stitched story: its hop ledgers
            # + route_seconds histograms, written AFTER the members so
            # every member's stream is already on disk (obs.stitch
            # reads the whole directory)
            from ..obs import build_report, write_jsonl

            path = os.path.join(args.obs_dir, "router.jsonl")
            write_jsonl(path, build_report(
                recorder=router.recorder,
                meta={"entry": "fleet-router",
                      "fleet_dir": args.fleet_dir}))
            print(f"[serve_fleet] router obs report -> {path}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
