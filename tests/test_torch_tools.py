"""The serving and observability CLIs of the port (``tools/obs_gate.py``,
``obs_trace.py``, ``obs_slo.py``, ``obs_fleet.py``, ``fault_smoke.py``)
against the JAX package's ``scripts/`` on the same report files.

Each CLI is driven through ``main(argv)``, as the JAX package's tests
drive the scripts: the return codes are equal and so is the standard
output (or the ``--json`` output).  The fault smoke runs on the CPU in a
child process (the JAX package's is not run here).
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest
import torch

from batchreactor_tpu.obs import Recorder as JRecorder
from batchreactor_tpu.obs import build_report as j_build_report
from batchreactor_tpu.obs import trace as j_trace
from batchreactor_tpu.obs import write_jsonl
from batchreactor_tpu_torch.tools import (obs_fleet, obs_gate, obs_slo,
                                          obs_trace)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _script(name):
    """The JAX package's ``scripts/<name>.py`` as a module (its own
    ``sys.path`` edits import the JAX package and sibling scripts)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _script(n) for n in ("obs_gate", "obs_trace", "obs_slo",
                                    "obs_fleet")}


def _both(capsys, port_main, jax_main, argv):
    """(rc, stdout, stderr) of the port's CLI and the JAX script."""
    out = []
    for fn in (port_main, jax_main):
        rc = fn(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def _bench_like_report():
    """The JAX package's scripted serving report (``tests/test_trace.py``):
    five requests with stage marks at fixed offsets."""
    r = JRecorder()
    r.counter("serve_requests", 5)
    r.counter("serve_answered", 5)
    for i in range(5):
        tr = j_trace.RequestTrace(f"req-{i}",
                                  pack_key=(1e-4, 1e-6, 1e-10, None),
                                  lanes=1)
        tr.marks["submitted"] = 1000.0
        t0 = tr.at("submitted")
        tr.mark("coalesced", at=t0 + 0.001 * (i + 1))
        tr.mark("admitted", at=t0 + 0.002 * (i + 1))
        tr.mark("first_harvest", at=t0 + 0.01 * (i + 1))
        tr.mark("resolved", at=t0 + 0.012 * (i + 1))
        for stage, dur in tr.segments().items():
            r.observe("serve_stage_seconds", dur, stage=stage)
        r.observe("serve_stage_seconds", tr.total_s(), stage="total")
        r.event("request_trace", **tr.to_attrs())
    return j_build_report(recorder=r, meta={"entry": "serving"})


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    path = tmp_path_factory.mktemp("rep") / "rep.jsonl"
    write_jsonl(str(path), _bench_like_report())
    return str(path)


GATE = {"schema": "br-obs-gate-v1",
        "counters": {"serve_answered": {"equals": 5},
                     "serve_failed": {"max": 0}},
        "histograms": {"serve_stage_seconds": {
            "stage=total": {"count": {"equals": 5}, "p50_s": {"max": 1.0},
                            "p99_s": {"max": 2.0}}}},
        "compile": {"retraces": {"max": 0}}}


def _perturbed(kind):
    base = json.loads(json.dumps(GATE))
    if kind == "breach":
        base["histograms"]["serve_stage_seconds"]["stage=total"][
            "p50_s"]["max"] = 1e-6
        base["counters"]["serve_answered"]["equals"] = 7
    elif kind == "missing":
        base["histograms"]["serve_stage_seconds"] = {
            "stage=nonexistent": {"p50_s": {"max": 1.0}}}
    return base


@pytest.mark.parametrize("kind", ["pass", "breach", "missing"])
def test_obs_gate_matches_the_script(tmp_path, capsys, scripts, report,
                                     kind):
    base = tmp_path / "base.json"
    base.write_text(json.dumps(_perturbed(kind)))
    port, ref = _both(capsys, obs_gate.main, scripts["obs_gate"].main,
                      ["--baseline", str(base), "--report", report])
    assert port == ref
    assert port[0] == (0 if kind == "pass" else 1)


def test_obs_gate_banked_fixture_and_loud_grammar(capsys, scripts, report):
    """The banked serving baseline parses in both; unknown sections and
    band keys raise the same errors."""
    fixture = str(REPO / "tests" / "fixtures" / "serve_gate_baseline.json")
    port, ref = _both(capsys, obs_gate.main, scripts["obs_gate"].main,
                      ["--baseline", fixture, "--report", report])
    assert port == ref
    rep = _bench_like_report()
    for bad, msg in (({"frontier": {}}, "unknown gate section"),
                     ({"counters": {"x": {"atmost": 1}}},
                      "unknown band key")):
        for run_gate in (obs_gate.run_gate, scripts["obs_gate"].run_gate):
            with pytest.raises(ValueError, match=msg):
                run_gate(bad, rep)


@pytest.mark.parametrize("argv", [["--slowest", "2"],
                                  ["--threshold-ms", "40", "--json"],
                                  []],
                         ids=["slowest", "threshold-json", "all"])
def test_obs_trace_matches_the_script(tmp_path, capsys, scripts, report,
                                      argv):
    port, ref = _both(capsys, obs_trace.main, scripts["obs_trace"].main,
                      [report, *argv])
    assert port == ref and port[0] == 0
    if argv == ["--slowest", "2"]:
        assert port[1].index("req-4") < port[1].index("req-3")


def _fleet_dir(tmp_path):
    """The scripted two-member fleet of ``tests/test_torch_trace.py``,
    written as the ``--obs-dir`` layout by the JAX package."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from test_torch_trace import _fleet_reports
    finally:
        sys.path.remove(str(REPO / "tests"))
    d = tmp_path / "obs"
    d.mkdir()
    for host, rep in _fleet_reports("jax"):
        write_jsonl(str(d / f"{host}.jsonl"), rep)
    return str(d)


@pytest.mark.parametrize("argv", [["--slowest", "2"], ["--json"]],
                         ids=["slowest", "json"])
def test_obs_trace_fleet_matches_the_script(tmp_path, capsys, scripts,
                                            argv):
    d = _fleet_dir(tmp_path)
    port, ref = _both(capsys, obs_trace.main, scripts["obs_trace"].main,
                      ["--fleet", d, *argv])
    assert port == ref and port[0] == 0
    with pytest.raises(SystemExit):
        obs_trace.main([])


SLO = {"schema": "br-slo-gate-v1",
       "objectives": {
           "latency_p95": {"kind": "latency", "budget": 0.05,
                           "threshold_s": 2.5,
                           "bad_fraction": {"max": 0.05}},
           "error_rate": {"kind": "error", "budget": 0.01,
                          "bad": {"max": 0}},
           "failover_rate": {"kind": "failover", "budget": 0.6,
                             "bad_fraction": {"max": 0.6}}},
       "requests": {"min": 2}}


@pytest.mark.parametrize("case", ["pass", "breach-json", "table"])
def test_obs_slo_matches_the_script(tmp_path, capsys, scripts, case):
    d = _fleet_dir(tmp_path)
    base = json.loads(json.dumps(SLO))
    argv = ["--fleet", d]
    if case == "breach-json":
        base["objectives"]["failover_rate"]["budget"] = 0.05
        base["objectives"]["failover_rate"]["bad_fraction"]["max"] = 0.05
        base["requests"] = {"min": 50}
        argv.append("--json")
    if case != "table":
        path = tmp_path / "slo.json"
        path.write_text(json.dumps(base))
        argv += ["--gate", "--baseline", str(path)]
    port, ref = _both(capsys, obs_slo.main, scripts["obs_slo"].main, argv)
    assert port == ref
    assert port[0] == (1 if case == "breach-json" else 0)


def _snapshot(d, pid, counters, gauges, age_s):
    hosts = d / "hosts"
    hosts.mkdir(exist_ok=True)
    (hosts / f"p{pid}.metrics.json").write_text(json.dumps({
        "pid": pid, "time": time.time() - age_s, "counters": counters,
        "gauges": gauges}))


@pytest.mark.parametrize("fmt", ["--json", "--prom"])
def test_obs_fleet_matches_the_script(tmp_path, capsys, scripts, fmt):
    _snapshot(tmp_path, 0, {"chunks_reassigned": 1, "lane_attempts": 300,
                            "lane_capacity": 400}, {"chunks_done": 2}, 1.0)
    _snapshot(tmp_path, 1, {"lane_attempts": 100, "lane_capacity": 200},
              {"chunks_done": 3}, 2.0)
    port, ref = _both(capsys, obs_fleet.main, scripts["obs_fleet"].main,
                      [str(tmp_path), fmt])
    # the snapshot ages move between the two calls
    age = re.compile(r"(snapshot_age_seconds\{[^}]*\}) [0-9.e+-]+")
    assert [age.sub(r"\1 AGE", v) if isinstance(v, str) else v
            for v in port] == [age.sub(r"\1 AGE", v)
                               if isinstance(v, str) else v for v in ref]
    assert port[0] == 0 and (fmt != "--prom" or "AGE" in age.sub(
        r"\1 AGE", port[1]))
    # the table carries snapshot ages, which move between the two calls
    rc = obs_fleet.main([str(tmp_path)])
    text = capsys.readouterr().out
    assert rc == 0 and "fleet: 2 host(s)" in text and "occupancy" in text
    empty = tmp_path / "empty"
    empty.mkdir()
    port, ref = _both(capsys, obs_fleet.main, scripts["obs_fleet"].main,
                      [str(empty)])
    assert port == ref and port[0] == 1


def test_fault_smoke_on_the_cpu(tmp_path):
    """``tools/fault_smoke.py --device cpu`` in a child process: exit 0,
    every fault class in its ``fault_events.jsonl``, and a flight dump."""
    out = tmp_path / "fault_events.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "batchreactor_tpu_torch.tools.fault_smoke",
         "--device", "cpu", "--out", str(out), "--scrape-out",
         str(tmp_path / "scrape.prom"), "--flight-dir", str(tmp_path)],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    with open(out) as f:
        kinds = {json.loads(ln).get("attrs", {}).get("kind") for ln in f}
    assert {"hung_fetch", "corrupt_chunk", "lane_quarantine",
            "dead_host_reassign", "slow_request"} <= kinds
    assert list(tmp_path.glob("flight_*.jsonl"))
    assert (tmp_path / "scrape.prom").read_text().startswith("#")
