"""Fault-injection smoke: replay the fault classes on a tiny ODE (the
port's ``scripts/fault_smoke.py``).

Every fault class of the resilience layer (hung fetch, corrupt chunk
file, NaN lane, killed process, and the serving plane's slow request) is
injected deterministically (``resilience/inject.py``) into a tiny
stiff-decay checkpointed sweep; recovery is asserted bit for bit against
an uninjected run, and the collected ``fault`` events and recovery
counters are written as an obs JSONL artifact (``fault_events.jsonl``).

  python -m batchreactor_tpu_torch.tools.fault_smoke \\
      [--out fault_events.jsonl] [--device cpu]

``--device`` defaults to the GPU (``cuda``).  The killed-process
scenario runs two child processes of this module (``--child``), one of
which ``os._exit``s before saving its first chunk.  Exit 0 means every
recovery path worked; a failed check raises.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B = 8


def rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def decay_problem(device):
    """The tiny stiff decay: B lanes of y' = -k y, k log-spaced in
    [10, 100]."""
    y0s = torch.tensor([1.0, 0.5], dtype=torch.float64,
                       device=device).expand(B, 2).clone()
    return y0s, {"k": torch.logspace(1.0, 2.0, B, dtype=torch.float64,
                                     device=device)}


def child_main(pid, n, ckpt, device):
    """One process of the killed-process scenario: the elastic tier on
    the decay problem; prints ``RESULT <json>``."""
    from batchreactor_tpu_torch.obs.recorder import Recorder
    from batchreactor_tpu_torch.parallel import multihost as mh
    from batchreactor_tpu_torch.solver.common import SUCCESS

    y0s, cfgs = decay_problem(device)
    rec = Recorder()
    res = mh.elastic_checkpointed_sweep(
        rhs, y0s, 0.0, 1.0, cfgs, ckpt, process_id=pid, num_processes=n,
        chunk_size=4, heartbeat_s=0.2, timeout_s=120.0, recorder=rec)
    assert bool((res.status == SUCCESS).all()), res.status
    _s, events, counters = rec.snapshot()
    print("RESULT " + json.dumps({
        "y": res.y.cpu().numpy().tolist(), "t": res.t.cpu().numpy().tolist(),
        "counters": counters,
        "fault_events": [e for e in events if e["name"] == "fault"]}),
        flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="fault_events.jsonl",
                    help="fault-event JSONL artifact path")
    ap.add_argument("--scrape-out", default="fault_scrape.prom",
                    help="where to save the live /metrics scrape taken "
                         "while the injected sweep runs")
    ap.add_argument("--flight-dir", default=None,
                    help="directory for flight_*.jsonl postmortem dumps "
                         "(default: the --out directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--child", nargs=3, metavar=("PID", "N", "CKPT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from batchreactor_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.child:
        pid, n, ckpt = args.child
        return child_main(int(pid), int(n), ckpt, device)

    from batchreactor_tpu_torch.obs import export, report
    from batchreactor_tpu_torch.obs.live import (LiveRegistry, MetricsServer,
                                                 arm_flight, disarm_flight)
    from batchreactor_tpu_torch.obs.recorder import Recorder
    from batchreactor_tpu_torch.parallel.checkpoint import checkpointed_sweep
    from batchreactor_tpu_torch.resilience import inject

    y0s, cfgs = decay_problem(device)
    # one recorder across every faulted run: the artifact aggregates all
    # the recovery paths
    rec = Recorder()
    # the flight recorder is armed for the whole smoke: the hung-fetch
    # wedge below dumps a flight_*.jsonl postmortem
    flight_dir = args.flight_dir or (os.path.dirname(
        os.path.abspath(args.out)) or ".")
    arm_flight(recorder=rec, dir=flight_dir, install_signal=True)

    def sweep(d, **kw):
        return checkpointed_sweep(rhs, y0s, 0.0, 1.0, cfgs, d,
                                  chunk_size=4, **kw)

    def assert_bit_exact(a, b, what):
        for f in ("t", "y", "status", "n_accepted", "n_rejected"):
            np.testing.assert_array_equal(
                getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy(),
                err_msg=f"{what}: field {f}")
        print(f"[fault-smoke] {what}: recovered bit-exact", file=sys.stderr)

    with tempfile.TemporaryDirectory() as base:
        clean = sweep(os.path.join(base, "clean"))

        # 1 — hung fetch: watchdog breach -> WedgeError -> chunk retry,
        # with the live /metrics endpoint up and scraped while the
        # injected sweep runs
        inject.arm("hang_fetch:delay=10")
        registry = LiveRegistry(recorder=rec, meta={"smoke": "fault"})
        scrapes = []
        stop = threading.Event()
        with MetricsServer(registry, port=0) as srv:
            url = srv.url + "/metrics"

            def scraper():
                while not stop.is_set():
                    try:
                        scrapes.append(
                            urllib.request.urlopen(url).read().decode())
                    except OSError:
                        pass
                    stop.wait(0.05)

            t = threading.Thread(target=scraper, daemon=True)
            t.start()
            try:
                res = sweep(os.path.join(base, "hang"),
                            chunk_budget_s=0.3,
                            retry={"max_retries": 2, "backoff_s": 0.0},
                            recorder=rec)
            finally:
                stop.set()
                t.join()
        assert_bit_exact(clean, res, "hung fetch")
        assert scrapes and any("br_" in s for s in scrapes), \
            "no live scrape landed while the injected sweep ran"
        # the last scrape carries the wedge
        # (br_fault_events_total{kind="hung_fetch"})
        with open(args.scrape_out, "w") as fh:
            fh.write(scrapes[-1])
        print(f"[fault-smoke] {len(scrapes)} live scrapes during the "
              f"wedged sweep -> {args.scrape_out}", file=sys.stderr)
        flights = glob.glob(os.path.join(flight_dir, "flight_*.jsonl"))
        assert flights, "hung-fetch wedge left no flight_*.jsonl dump"
        with open(sorted(flights)[-1]) as fh:
            tail = [json.loads(ln) for ln in fh][-8:]
        assert any(r.get("kind") == "event" and r.get("name") == "fault"
                   for r in tail), tail
        assert any(r.get("kind") == "counter_snapshot" for r in tail), tail
        print(f"[fault-smoke] flight recorder dumped "
              f"{os.path.basename(sorted(flights)[-1])} (fault event + "
              f"counter snapshot in the tail)", file=sys.stderr)

        # 2 — corrupt chunk: torn after the save; the resume validates
        # and re-solves it
        inject.arm("corrupt_chunk:chunk=1")
        d = os.path.join(base, "corrupt")
        sweep(d, recorder=rec)
        res = sweep(d, recorder=rec)
        assert_bit_exact(clean, res, "corrupt chunk")

        # 3 — NaN lane: the quarantine's retry pass recovers it
        inject.arm("nan_lane:lane=3")
        res = sweep(os.path.join(base, "nan"), quarantine=True,
                    recorder=rec)
        assert_bit_exact(clean, res, "NaN lane")
        assert int(res.provenance[3]) == 1, res.provenance

        # 4 — killed process: the elastic tier reassigns the dead owner's
        # chunk to the survivor (real OS processes; p1 dies on its first
        # chunk, whose claim lands at startup)
        ck = os.path.join(base, "elastic")
        env = {**os.environ, "PYTHONPATH": REPO}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "batchreactor_tpu_torch.tools.fault_smoke",
             "--device", str(device), "--child", str(i), "2", ck],
            env=({**env, "BR_FAULT_INJECT": "kill:chunk=1"} if i else env),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert procs[1].returncode == 137, (
            f"victim survived (rc={procs[1].returncode}):\n{outs[1][-2000:]}")
        assert procs[0].returncode == 0, (
            f"survivor failed (rc={procs[0].returncode}):\n{outs[0][-2000:]}")
        got = json.loads(next(ln for ln in outs[0].splitlines()
                              if ln.startswith("RESULT "))[len("RESULT "):])
        assert got["counters"].get("chunks_reassigned") == 1, got["counters"]
        np.testing.assert_array_equal(np.asarray(got["y"]),
                                      clean.y.cpu().numpy(),
                                      err_msg="killed process: field y")
        print("[fault-smoke] killed process: survivor completed, bit-exact",
              file=sys.stderr)
        # fold the survivor's telemetry into the artifact recorder
        for e in got["fault_events"]:
            rec.event(e["name"], **e["attrs"])
        for k, v in got["counters"].items():
            rec.counter(k, v)

        # 5 — slow request: a deterministic stall between a request's
        # admission into the resident stream and its harvest.  The daemon
        # still answers every request with success provenance; the stall
        # shows as latency on the victim and as a fault event
        from batchreactor_tpu_torch.serving.client import SolveClient
        from batchreactor_tpu_torch.serving.scheduler import Scheduler
        from batchreactor_tpu_torch.serving.server import ServingServer
        from batchreactor_tpu_torch.serving.session import SolverSession

        fixtures = os.path.join(REPO, "tests", "fixtures")
        session = SolverSession.from_spec(
            {"mechanism": {"mech": os.path.join(fixtures, "h2o2.dat"),
                           "therm": os.path.join(fixtures, "therm.dat")},
             "solver": {"segment_steps": 64, "stats": True},
             "serve": {"resident": 4, "refill": 1, "buckets": [4],
                       "poll_every": 1}}, recorder=rec, device=device)
        inject.arm("slow_request:delay=0.4,request=victim")
        comp = {"H2": 0.3, "O2": 0.15, "N2": 0.55}
        with session:
            sched = Scheduler(session)
            with ServingServer(session, sched) as srv:
                client = SolveClient(srv.url)
                rs = [client.solve({"id": rid, "T": [1150.0 + 50.0 * i],
                                    "X": comp, "t1": 5e-5})
                      for i, rid in enumerate(["pre", "victim", "post"])]
        assert all(r["provenance"] == ["success"] for r in rs), rs
        assert rs[1]["elapsed_ms"] >= 400, rs[1]["elapsed_ms"]
        print(f"[fault-smoke] slow request: victim stalled "
              f"{rs[1]['elapsed_ms']:.0f}ms between admission and "
              f"harvest, all 3 answered success", file=sys.stderr)

    disarm_flight()
    rep = report.build_report(recorder=rec,
                              meta={"smoke": "fault-injection",
                                    "device": str(device),
                                    "faults": ["hang_fetch",
                                               "corrupt_chunk", "nan_lane",
                                               "kill", "slow_request"]})
    export.write_jsonl(args.out, rep)
    _spans, events, counters = rec.snapshot()
    kinds = sorted({e["attrs"].get("kind") for e in events
                    if e["name"] == "fault"})
    print(json.dumps({"ok": True, "out": args.out, "fault_kinds": kinds,
                      "counters": counters}))
    # the artifact must carry every injected fault kind
    missing = {"hung_fetch", "corrupt_chunk", "lane_quarantine",
               "dead_host_reassign", "slow_request"} - set(kinds)
    assert not missing, f"fault kinds missing from the artifact: {missing}"
    return 0


if __name__ == "__main__":
    sys.exit(main())
