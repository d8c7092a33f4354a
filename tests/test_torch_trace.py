"""Request tracing, the SLO monitor and fleet stitching of the port
(``obs/trace.py``, ``obs/slo.py``, ``obs/stitch.py``) against the JAX
package's modules on the same events, with injected clocks: equal
payloads, equal evaluations, equal expositions, and reports of either
package stitched by either package's code.
"""

import json

import pytest
import torch

from batchreactor_tpu.obs import Recorder as JRecorder
from batchreactor_tpu.obs import build_report as j_build_report
from batchreactor_tpu.obs import slo as j_slo
from batchreactor_tpu.obs import stitch as j_stitch
from batchreactor_tpu.obs import trace as j_trace
from batchreactor_tpu_torch.obs import Recorder as TRecorder
from batchreactor_tpu_torch.obs import build_report as t_build_report
from batchreactor_tpu_torch.obs import counters as TC
from batchreactor_tpu_torch.obs import slo as t_slo
from batchreactor_tpu_torch.obs import stitch as t_stitch
from batchreactor_tpu_torch.obs import trace as t_trace
from batchreactor_tpu_torch.obs import write_jsonl

torch.set_num_threads(1)

PKGS = {"jax": (j_trace, j_slo, j_stitch, JRecorder, j_build_report),
        "torch": (t_trace, t_slo, t_stitch, TRecorder, t_build_report)}

#: the one ``perf_counter`` base of the scripted fleet's member traces in
#: both packages: an offset such as ``(t + 0.01) - t`` rounds by the size
#: of ``t``, so reports built at two clock readings would carry histogram
#: sums that differ in the last bits
CLOCK_BASE = 1000.0


def _scripted_trace(T, rid="r1", ctx=None, stall=False):
    """A trace with every mark at a scripted offset (the injected clock)."""
    tr = T.RequestTrace(rid, pack_key=(1e-4, 1e-6, 1e-10, None), lanes=3)
    if ctx is not None:
        tr.adopt(*ctx)
    t0 = tr.at("submitted")
    tr.mark("coalesced", at=t0 + 0.125)
    tr.mark("admitted", at=t0 + 0.25)
    tr.mark("first_harvest", at=t0 + 0.5)
    assert not tr.mark("first_harvest", at=t0 + 0.75)   # first wins
    if stall:
        tr.mark("stalled", at=t0 + 0.625)
    tr.mark("resolved", at=t0 + 1.0)
    return tr


def _strip_wall(attrs):
    return {k: v for k, v in attrs.items() if k != "wall_start"}


@pytest.mark.parametrize("ctx", [None, ("t-7", "route:1", 1)])
@pytest.mark.parametrize("stall", [False, True])
def test_request_trace_matches_jax(ctx, stall):
    a = _scripted_trace(j_trace, ctx=ctx, stall=stall)
    b = _scripted_trace(t_trace, ctx=ctx, stall=stall)
    assert a.stages() == pytest.approx(b.stages(), abs=1e-12)
    assert list(a.stages()) == list(b.stages())
    assert a.to_payload() == b.to_payload()
    assert _strip_wall(a.to_attrs()) == _strip_wall(b.to_attrs())
    assert t_trace.STAGE_ORDER == j_trace.STAGE_ORDER
    assert t_trace.TRACE_VERSION == j_trace.TRACE_VERSION
    json.dumps(b.to_attrs())
    with pytest.raises(ValueError, match="unknown trace stage"):
        b.mark("harvested")
    with pytest.raises(ValueError, match="non-empty trace id"):
        t_trace.RequestTrace("x").adopt("")


def _feed_monitor(S, rec):
    mon = S.SloMonitor(recorder=rec, window_s=300.0, fast_window_s=30.0)
    t0 = 1_000_000.0
    for i in range(20):
        mon.record(3.5, ok=(i % 7 != 0), failover=(i % 5 == 0), at=t0 + i)
    first = mon.evaluate(now=t0 + 20)
    for i in range(40):
        mon.record(0.01, ok=True, at=t0 + 60 + i)
    second = mon.evaluate(now=t0 + 100)
    prom = mon.prometheus(now=t0 + 100)
    return first, second, prom


def test_slo_monitor_matches_jax():
    jr, tr = JRecorder(), TRecorder()
    ja, jb, jp = _feed_monitor(j_slo, jr)
    ta, tb, tp = _feed_monitor(t_slo, tr)
    assert (ta, tb) == (ja, jb)
    assert tp == jp
    assert ta["latency_p95"]["alerting"] is True
    assert tb["latency_p95"]["alerting"] is False

    def alerts(rec):
        _s, events, counters = rec.snapshot()
        return ([(e["attrs"]["objective"], e["attrs"]["state"])
                 for e in events if e["name"] == "slo_alert"],
                counters.get("slo_alerts"))

    assert alerts(tr) == alerts(jr)
    assert [m for m in TC.FAMILIES.values()
            if tuple(m["keys"]) == TC.SLO_KEYS][0]["missing_zero"]


def test_slo_objectives_and_offline_evaluation_match_jax():
    traces = ([{"total_s": 0.1, "failover": False}] * 8
              + [{"total_s": 9.0, "failover": True}]
              + [{"total_s": 0.2, "failed": True, "code": "internal"}]
              + [{"total_s": None}])

    def objs(S):
        return (S.Objective("lat", "latency", 0.5, threshold_s=2.5),
                S.Objective("err", "error", 0.05),
                S.Objective("fo", "failover", 0.05))

    assert (t_slo.evaluate_traces(traces, objs(t_slo))
            == j_slo.evaluate_traces(traces, objs(j_slo)))
    assert ([o.describe() for o in t_slo.DEFAULT_OBJECTIVES]
            == [o.describe() for o in j_slo.DEFAULT_OBJECTIVES])
    for kw, match in (({"objectives": ()}, "at least one"),
                      ({"fast_window_s": 400.0}, "must sit inside"),
                      ({"burn_alert": 0.0}, "burn_alert")):
        with pytest.raises(ValueError, match=match):
            t_slo.SloMonitor(**kw)


def _fleet_reports(pkg, skew_s=0.0):
    """A scripted two-member fleet run (the JAX package's
    ``tests/test_trace.py`` scenario) written by ``pkg``'s recorder,
    traces and report builder: ``fo`` fails over m1 -> m2, ``ok`` routes
    direct to m1, ``lone`` hit m2 without a router."""
    T, _S, _St, Rec, build = PKGS[pkg]
    t0 = 1_700_000_000.0
    router = Rec()
    router.counter("route_requests", 2)
    router.counter("route_failovers", 1)
    router.observe("route_seconds", 0.3, path="failover")
    router.observe("route_seconds", 0.05, path="direct")
    router.event("request_trace", request="fo", v=1, span="route",
                 trace="t-fo", parent_span="client", minted=False,
                 hop=0, wall_start=t0, total_s=0.3, failover=True,
                 tried=["m1"], host="m2", hops=[
                     {"member": "m1", "hop": 1, "send_wall": t0,
                      "recv_wall": t0 + 0.05, "outcome": "transport"},
                     {"member": "m2", "hop": 2, "send_wall": t0 + 0.06,
                      "recv_wall": t0 + 0.3, "outcome": "ok"}])
    router.event("request_trace", request="ok", v=1, span="route",
                 trace="r-deadbeef", minted=True, hop=0,
                 wall_start=t0 + 1.0, total_s=0.05, failover=False,
                 tried=[], host="m1", hops=[
                     {"member": "m1", "hop": 1, "send_wall": t0 + 1.0,
                      "recv_wall": t0 + 1.05, "outcome": "ok"}])

    def pinned(rid):
        tr = T.RequestTrace(rid, lanes=1)
        tr.marks["submitted"] = CLOCK_BASE
        return tr

    def member(rid, tid, hop, wall, total, parent):
        rec = Rec()
        rec.counter("serve_answered", 1)
        tr = pinned(rid)
        tr.adopt(tid, parent_span=parent, hop=hop)
        t_sub = tr.at("submitted")
        tr.mark("coalesced", at=t_sub + 0.01)
        tr.mark("admitted", at=t_sub + 0.02)
        tr.mark("first_harvest", at=t_sub + total - 0.01)
        tr.mark("resolved", at=t_sub + total)
        for stage, dur in tr.segments().items():
            rec.observe("serve_stage_seconds", dur, stage=stage)
        attrs = tr.to_attrs()
        attrs["wall_start"] = round(wall, 6)
        attrs["total_s"] = round(total, 6)
        rec.event("request_trace", **attrs)
        return rec

    m2 = member("fo", "t-fo", 2, t0 + 0.08 + skew_s, 0.2, "route:2")
    lone = pinned("lone")
    lone.mark("resolved", at=lone.at("submitted") + 0.4)
    lone_attrs = lone.to_attrs()
    lone_attrs["wall_start"] = round(t0 + 2.0, 6)
    m2.event("request_trace", **lone_attrs)
    m1 = member("ok", "r-deadbeef", 1, t0 + 1.01 + skew_s, 0.03,
                "route:1")
    return [("m1", build(recorder=m1)), ("m2", build(recorder=m2)),
            ("router", build(recorder=router,
                             meta={"entry": "fleet-router"}))]


def _comparable(traces):
    """Stitched traces with the stage offsets rounded (the scripted marks
    ride ``perf_counter`` bases that differ between the two runs)."""
    return json.loads(json.dumps(traces, sort_keys=True),
                      parse_float=lambda s: round(float(s), 6))


@pytest.mark.parametrize("skew", [0.0, -7.5, 42.0])
def test_stitch_matches_jax_both_ways(skew):
    j_reps, t_reps = _fleet_reports("jax", skew), _fleet_reports("torch",
                                                                 skew)
    ref = _comparable(j_stitch.stitch(j_reps))
    # the port's stitch on the port's reports and on the JAX package's,
    # and the JAX stitch on the port's reports: one answer
    assert _comparable(t_stitch.stitch(t_reps)) == ref
    assert _comparable(t_stitch.stitch(j_reps)) == ref
    assert _comparable(j_stitch.stitch(t_reps)) == ref
    fo = next(t for t in t_stitch.stitch(t_reps) if t["request"] == "fo")
    assert fo["failover"] and fo["tried"] == ["m1"] and fo["host"] == "m2"
    dead, alive = fo["hops"]
    assert dead["outcome"] == "transport" and "member_trace" not in dead
    assert alive["wall_start_corrected"] == pytest.approx(
        1_700_000_000.0 + 0.08, abs=1e-6)
    assert alive["skew_s"] == pytest.approx(skew, abs=1e-3)


def test_merge_and_render_match_jax(tmp_path):
    j_reps, t_reps = _fleet_reports("jax"), _fleet_reports("torch")
    jm, tm = j_stitch.merge_reports(j_reps), t_stitch.merge_reports(t_reps)
    assert tm["counters"] == jm["counters"]
    assert tm["histograms"] == jm["histograms"]
    assert tm["schema"] == jm["schema"]
    text = t_stitch.render_fleet(t_stitch.stitch(t_reps), slowest=5)
    assert "fo" in text and "m2" in text
    # a port report stream on disk loads through the JAX package's loader
    for host, rep in t_reps:
        write_jsonl(str(tmp_path / f"{host}.jsonl"), rep)
    loaded = j_stitch.load_fleet(str(tmp_path))
    assert [h for h, _ in loaded] == ["m1", "m2", "router"]
    assert (_comparable(j_stitch.stitch(loaded))
            == _comparable(t_stitch.stitch(t_reps)))
    with pytest.raises(ValueError, match="unreadable"):
        t_stitch.load_fleet(str(tmp_path / "missing"))
