"""The port's live telemetry plane (``obs/live.py``) on the CPU: the
``BR_METRICS_PORT`` grammar against the JAX package's, a ``/metrics``
endpoint on an ephemeral port scraped in the middle of a streaming sweep,
a bind failure that raises, and the flight recorder's dump on a hung
wait under ``fetch_deadline``.
"""

import json
import os
import socket
import urllib.request

import numpy as np
import pytest
import torch

from batchreactor_tpu.obs import live as live_j
from batchreactor_tpu_torch import obs
from batchreactor_tpu_torch.obs import live
from batchreactor_tpu_torch.parallel import sweep as S
from batchreactor_tpu_torch.resilience import WedgeError, inject

torch.set_num_threads(1)

B = 8


def _rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _jac(t, y, cfg):
    eye = torch.eye(2, dtype=torch.float64)
    return -cfg["k"][:, None, None] * eye.expand(y.shape[0], 2, 2)


def _lanes():
    return (torch.tensor(np.tile([1.0, 0.5], (B, 1))),
            {"k": torch.tensor(np.logspace(1.0, 3.0, B))})


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


@pytest.mark.parametrize("env,arg", [
    ("", None), ("9107", None), ("", False), ("", True), ("", 0),
    ("", 9108), ("", -1), ("", 70000), ("0", None), ("x", None)])
def test_resolve_live_metrics_matches_jax(monkeypatch, env, arg):
    monkeypatch.setenv("BR_METRICS_PORT", env)

    def run(fn):
        try:
            return fn(arg)
        except Exception as e:  # noqa: BLE001 — the type is compared
            return type(e).__name__

    assert run(live.resolve_live_metrics) == run(
        live_j.resolve_live_metrics)


def test_metrics_scraped_mid_stream():
    """A streaming sweep publishes at every poll; a scrape made from the
    progress callback (the driver's poll point, mid-sweep) shows the
    in-flight sweep gauges, and the occupancy moves between polls."""
    rec = obs.Recorder()
    reg = live.LiveRegistry(recorder=rec, meta={"entry": "test"})
    y0, cfg = _lanes()
    scrapes = []
    with live.MetricsServer(reg, port=0) as server:
        def progress(_payload):
            scrapes.append(_get(server.url + "/metrics"))

        res = S.ensemble_solve_segmented(
            _rhs, y0, 0.0, 1.0, cfg, linsolve="lu", jac=_jac,
            segment_steps=16, admission=3, refill=1, poll_every=1,
            recorder=rec, live=reg, progress=progress)
        health = json.loads(_get(server.url + "/healthz"))
    assert int((res.status == 1).sum()) == B
    inflight = [t for t in scrapes if "br_sweep_backlog_depth" in t]
    assert len(inflight) >= 2
    occ = {ln for t in inflight for ln in t.splitlines()
           if ln.startswith("br_sweep_occupancy ")}
    assert len(occ) >= 2
    assert health["ok"] and health["meta"] == {"entry": "test"}
    # retired on return: the final occupancy pair folded onto the recorder,
    # no overlay left
    assert reg.gauges() == {}
    assert rec.counters["lane_attempts"] == int(
        (res.n_accepted + res.n_rejected).sum())
    assert rec.counters["metrics_scrapes"] == len(scrapes)


def test_bind_failure_raises():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen(1)
        port = sock.getsockname()[1]
        with pytest.raises(OSError):
            live.MetricsServer(live.LiveRegistry(), port=port).start()


def test_flight_dump_on_hung_fetch(tmp_path):
    """``BR_FAULT_INJECT=hang_fetch`` holds a flag read past the sweep's
    ``fetch_deadline``: the watchdog raises ``WedgeError`` and the armed
    flight recorder dumps its ring, the fault's counters at its tail."""
    rec = obs.Recorder()
    fl = obs.arm_flight(rec, dir=str(tmp_path), install_signal=False)
    y0, cfg = _lanes()
    try:
        inject.arm("hang_fetch:delay=30")
        with pytest.raises(WedgeError):
            S.ensemble_solve_segmented(_rhs, y0, 0.0, 1.0, cfg,
                                       linsolve="lu", jac=_jac,
                                       segment_steps=16, recorder=rec,
                                       fetch_deadline=0.2)
    finally:
        inject.arm("")
        obs.disarm_flight()
    dumps = sorted(p for p in os.listdir(tmp_path)
                   if p.startswith("flight_"))
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["kind"] == "flight"
    assert lines[0]["reason"].startswith("hung_fetch")
    kinds = [r["kind"] for r in lines[1:]]
    assert "counter_snapshot" in kinds
    assert rec.counters["fetch_timeouts"] == 1
    assert rec.counters["flight_dumps"] == 1
    assert [e["attrs"]["kind"] for e in rec.events
            if e["name"] == "fault"] == ["hung_fetch"]
    assert fl.records()
