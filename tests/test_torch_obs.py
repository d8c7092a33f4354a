"""Port parity: observability (batchreactor_tpu_torch ``obs/``, the solvers'
``stats=``/``timeline=``/``step_audit=``, the drivers' recorder and the
API's ``telemetry=``) against the JAX package, on the CPU.

Integer counters are held equal to the JAX package's; the timeline's and
the step audit's floating-point payloads agree to 1e-6 relative (the two
packages' ``pow`` round the step-size factor differently from the second
attempt on, and the difference grows to ~3e-8 over the ~160 attempts of
these solves); reports built from the same records render, export and
diff to equal text in both packages.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu import obs as obs_j
from batchreactor_tpu.obs import live as live_j
from batchreactor_tpu.solver import bdf as bdf_j
from batchreactor_tpu.solver import sdirk as sdirk_j
from batchreactor_tpu.utils import profiling as prof_j
from batchreactor_tpu_torch import obs
from batchreactor_tpu_torch.obs import counters as C
from batchreactor_tpu_torch.obs import live
from batchreactor_tpu_torch.parallel import sweep as S
from batchreactor_tpu_torch.solver import bdf, graphs, sdirk
from batchreactor_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_reference_programs():
    """The JAX package's own telemetry test counts the programs its first
    file-driven run compiles (``tests/test_obs.py``); this file runs the
    same program, so it drops JAX's compiled programs when it ends rather
    than leave them to a later file in the same worker."""
    yield
    jax.clear_caches()

B = 8
K = np.logspace(1.0, 3.0, B)
Y0 = np.tile([1.0, 0.5], (B, 1))
TIMELINE = 16
# the tolerance of the rings' t and h and of the audit matrix (module doc)
RING_RTOL = 1e-6

CASES = {
    "bdf_jw1": (bdf_j.solve, bdf.solve, dict(jac_window=1)),
    "bdf_jw4": (bdf_j.solve, bdf.solve, dict(jac_window=4)),
    "bdf_economy": (bdf_j.solve, bdf.solve,
                    dict(jac_window=4, setup_economy=True)),
    "bdf_freeze": (bdf_j.solve, bdf.solve,
                   dict(jac_window=4, freeze_precond=True)),
    "sdirk": (sdirk_j.solve, sdirk.solve, {}),
}
FLOAT_KEYS = ("timeline_t", "timeline_h", "it_matrix")


def _rhs_j(t, y, cfg):
    return -cfg["k"] * y


def _jac_j(t, y, cfg):
    return -cfg["k"] * jnp.eye(2)


def _rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _jac(t, y, cfg):
    eye = torch.eye(2, dtype=torch.float64)
    return -cfg["k"][:, None, None] * eye.expand(y.shape[0], 2, 2)


def _lanes():
    return torch.tensor(Y0), {"k": torch.tensor(K)}


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    """The linear-ODE lanes through one solver configuration in both
    packages, with the counters, a 16-slot ring and (BDF) the audit."""
    solve_j, solve_t, kw = CASES[request.param]
    extra = dict(stats=True, timeline=TIMELINE, **kw)
    if solve_t is bdf.solve:
        extra["step_audit"] = True
    ref = jax.vmap(lambda y, k: solve_j(
        _rhs_j, y, 0.0, 1.0, {"k": k}, linsolve="lu", jac=_jac_j,
        **extra))(jnp.asarray(Y0), jnp.asarray(K))
    y0, cfg = _lanes()
    got = solve_t(_rhs, y0, 0.0, 1.0, cfg, linsolve="lu", jac=_jac, **extra)
    return request.param, ref, got


def test_counters_equal_jax(solved):
    name, ref, got = solved
    assert set(got.stats) == set(ref.stats), name
    for k, v in ref.stats.items():
        if k in FLOAT_KEYS:
            continue
        want = np.asarray(v)
        have = got.stats[k].numpy()
        assert have.dtype == want.dtype, (name, k)
        np.testing.assert_array_equal(have, want, err_msg=f"{name} {k}")


def test_counter_identities(solved):
    name, _, got = solved
    st = {k: v.numpy() for k, v in got.stats.items()}
    np.testing.assert_array_equal(st["err_rejects"] + st["conv_rejects"],
                                  st["n_rejected"])
    np.testing.assert_array_equal(st["n_accepted"],
                                  got.n_accepted.numpy())
    if "order_hist" in st:
        np.testing.assert_array_equal(st["order_hist"].sum(axis=1),
                                      st["n_accepted"])
    if name == "bdf_economy":
        np.testing.assert_array_equal(
            st["setup_reuses"] + st["factorizations"], st["jac_builds"])
        assert (st["setup_reuses"] > 0).all()


def test_timeline_and_audit_match_jax(solved):
    name, ref, got = solved
    np.testing.assert_array_equal(got.stats["timeline_code"].numpy(),
                                  np.asarray(ref.stats["timeline_code"]))
    for k in FLOAT_KEYS:
        if k not in ref.stats:
            continue
        np.testing.assert_allclose(got.stats[k].numpy(),
                                   np.asarray(ref.stats[k]),
                                   rtol=RING_RTOL, atol=0,
                                   err_msg=f"{name} {k}")
    if "accept_ring" in ref.stats:
        np.testing.assert_array_equal(got.accept_ring.numpy(),
                                      np.asarray(ref.accept_ring))
        assert got.it_matrix is got.stats["it_matrix"]


@pytest.mark.parametrize("pipeline", [True, False])
def test_segmented_ring_equals_monolithic(pipeline):
    """At jac_window=1 the ring resumed across segments (the global
    attempt base) is the monolithic solve's, bit for bit, in each gear."""
    y0, cfg = _lanes()
    kw = dict(linsolve="lu", jac=_jac, stats=True, timeline=TIMELINE)
    mono = S.ensemble_solve(_rhs, y0, 0.0, 1.0, cfg, **kw)
    seg = S.ensemble_solve_segmented(_rhs, y0, 0.0, 1.0, cfg,
                                     segment_steps=16, pipeline=pipeline,
                                     **kw)
    assert set(seg.stats) == set(mono.stats)
    for k in mono.stats:
        assert torch.equal(seg.stats[k], mono.stats[k]), k


def test_admission_stats_unshuffled():
    """Streamed through 3 resident slots, each lane's counters and ring
    come back in the caller's order, equal to one program's."""
    y0, cfg = _lanes()
    kw = dict(linsolve="lu", jac=_jac, stats=True, timeline=TIMELINE,
              segment_steps=16)
    one = S.ensemble_solve_segmented(_rhs, y0, 0.0, 1.0, cfg, **kw)
    rec = obs.Recorder()
    streamed = S.ensemble_solve_segmented(_rhs, y0, 0.0, 1.0, cfg,
                                          admission=3, refill=1,
                                          recorder=rec, **kw)
    for k in one.stats:
        assert torch.equal(streamed.stats[k], one.stats[k]), k
    assert rec.counters["admitted_lanes"] == B - 3
    assert rec.counters["compactions"] >= 1
    assert rec.by_name()["compact"]["count"] == rec.counters["compactions"]


def test_padded_lanes_are_stripped():
    y0, cfg = _lanes()
    res = S.ensemble_solve_segmented(_rhs, y0[:5], 0.0, 1.0,
                                     {"k": cfg["k"][:5]}, linsolve="lu",
                                     jac=_jac, stats=True, buckets=(8,))
    ref = S.ensemble_solve_segmented(_rhs, y0, 0.0, 1.0, cfg, linsolve="lu",
                                     jac=_jac, stats=True)
    for k, v in res.stats.items():
        assert v.shape[0] == 5
        assert torch.equal(v, ref.stats[k][:5]), k


# ---------------------------------------------------------------------------
# reports, exports and the recorder API
# ---------------------------------------------------------------------------

class _Watch:
    """A stand-in compile watch whose summary both packages render."""

    def __init__(self, summary):
        self._summary = summary

    def summary(self):
        return copy.deepcopy(self._summary)


def _records():
    """One port recorder with spans, events, counters and histograms, and
    a JAX recorder holding the same records (timestamps normalised)."""
    rec = obs.Recorder()
    with rec.span("solve", lanes=8):
        with rec.span("segment", index=0):
            pass
        with rec.span("poll", upto=0):
            pass
    rec.event("fault", kind="hung_fetch", label="flag")
    rec.event("retrace", label="sweep-segment", program="b8/window")
    for name, v in (("blocking_syncs", 52), ("lane_attempts", 1200),
                    ("lane_capacity", 2048), ("poll_wait_s", 0.125),
                    ("fetch_timeouts", 1)):
        rec.counter(name, v)
    for v in (0.0003, 0.02, 1.5, 90.0):
        rec.observe("serve_stage_seconds", v, stage="total")
    for i, s in enumerate(rec.spans):
        s["start"], s["dur"] = 1000.0 + i, 0.25 * (i + 1)
    for e in rec.events:
        e["time"] = 1000.5
    rec_j = obs_j.Recorder()
    rec_j.spans = copy.deepcopy(rec.spans)
    rec_j.events = copy.deepcopy(rec.events)
    rec_j.counters = dict(rec.counters)
    rec_j.histograms = copy.deepcopy(rec.histograms)
    return rec, rec_j


STATS = {"n_accepted": np.array([120, 131], np.int32),
         "n_rejected": np.array([10, 12], np.int32),
         "newton_iters": np.array([300, 310], np.int32),
         "jac_builds": np.array([40, 42], np.int32),
         "factorizations": np.array([30, 33], np.int32),
         "err_rejects": np.array([8, 9], np.int32),
         "conv_rejects": np.array([2, 3], np.int32),
         "setup_reuses": np.array([10, 9], np.int32),
         "precond_age": np.array([3, 4], np.int32),
         "order_hist": np.array([[0, 2, 8, 20, 40, 50],
                                 [0, 1, 10, 30, 40, 50]], np.int32)}
WATCH = {"available": True, "compiles": 3, "traces": 1, "retraces": 0,
         "compile_s": 1.25, "cache_hits": 0, "cache_misses": 0,
         "by_label": {"sweep-segment": {
             "traces": 1, "compiles": 3, "compile_s": 1.25, "cache_hits": 0,
             "cache_misses": 0, "cache_load_s": 0.0, "retraces": 0,
             "single_program": True,
             "programs": {"b8/begin": 1, "b8/window": 1, "b8/end": 1}}}}


@pytest.fixture(scope="module")
def reports():
    rec, rec_j = _records()
    meta = {"entry": "batch_reactor_sweep", "lanes": 2}
    stats_t = {k: torch.as_tensor(v) for k, v in STATS.items()}
    got = obs.build_report(rec, solver_stats=stats_t, watch=_Watch(WATCH),
                           meta=meta)
    want = obs_j.build_report(rec_j, solver_stats=STATS,
                              watch=_Watch(WATCH), meta=meta)
    return got, want


def test_report_exports_equal_jax(reports):
    got, want = reports
    assert got == want
    assert obs.to_jsonl(got) == obs_j.to_jsonl(want)
    assert obs.to_prometheus(got) == obs_j.to_prometheus(want)
    assert obs.render(got) == obs_j.render(want)
    other = copy.deepcopy(got)
    other["counters"]["blocking_syncs"] = 2569
    other["solver_stats"]["totals"]["newton_iters"] += 5
    other["spans"][0]["dur"] = 4.0
    assert obs.diff(got, other) == obs_j.diff(want, other)
    assert "blocking_syncs: 52 -> 2569" in obs.diff(got, other)


def test_jsonl_reads_across_packages(reports, tmp_path):
    got, want = reports
    obs_j.write_jsonl(str(tmp_path / "j.jsonl"), want)
    obs.write_jsonl(str(tmp_path / "t.jsonl"), got)
    assert obs.read_jsonl(str(tmp_path / "j.jsonl")) == want
    assert obs_j.read_jsonl(str(tmp_path / "t.jsonl")) == got
    assert obs.from_jsonl(obs.to_jsonl(got)) == got


def test_fleet_snapshots_merge_across_packages(tmp_path):
    rec, rec_j = _records()
    live.write_fleet_snapshot(str(tmp_path), 1,
                              live.LiveRegistry(recorder=rec))
    live_j.write_fleet_snapshot(str(tmp_path), 2,
                                live_j.LiveRegistry(recorder=rec_j))
    snaps = live.read_fleet_snapshots(str(tmp_path))
    snaps_j = live_j.read_fleet_snapshots(str(tmp_path))
    assert [s["pid"] for s in snaps] == [1, 2] and snaps == snaps_j
    merged = live.merge_fleet(snaps)
    assert merged == live_j.merge_fleet(snaps_j)
    assert merged["counters"]["blocking_syncs"] == 104
    assert merged["histograms"]["serve_stage_seconds"][0]["count"] == 8


def test_recorder_api_matches_jax():
    h, h_j = C.hist_new(), obs_j.counters.hist_new()
    for v in (1e-5, 3e-4, 0.01, 0.01, 2.0, 1e3):
        C.hist_observe(h, v)
        obs_j.counters.hist_observe(h_j, v)
    assert h == h_j
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert C.hist_quantile(h, q) == obs_j.counters.hist_quantile(h_j, q)
    live_mask = np.array([True, False])
    seg = {k: v for k, v in STATS.items()}
    acc = acc_j = None
    for _ in range(2):
        acc = C.accumulate(acc, seg, live_mask)
        acc_j = obs_j.counters.accumulate(acc_j, seg, live_mask)
    for k in acc:
        np.testing.assert_array_equal(acc[k], acc_j[k])
    # the gauge keeps its peak across segments, the counters add
    assert acc["precond_age"].tolist() == [3, 0]
    assert acc["n_accepted"].tolist() == [240, 0]
    assert C.totals(acc) == obs_j.counters.totals(acc_j)
    ph, ph_j = prof.Phases(), prof_j.Phases()
    for p in (ph, ph_j):
        for name in ("parse", "solve", "solve"):
            with p(name):
                pass
    assert ph.counts == ph_j.counts == {"parse": 1, "solve": 2}
    assert set(ph.summary()) == set(ph_j.summary())


# ---------------------------------------------------------------------------
# the compile watch on the CPU (programs built)
# ---------------------------------------------------------------------------

def _watched(watch, y0, cfg, **kw):
    return S.ensemble_solve_segmented(_rhs, y0, 0.0, 0.05, cfg,
                                      linsolve="lu", jac=_jac,
                                      segment_steps=8, watch=watch, **kw)


def test_compile_watch_counts_programs_built():
    y0, cfg = _lanes()
    graphs.clear_programs()
    with obs.CompileWatch() as cold:
        _watched(cold, y0, cfg)
    with obs.CompileWatch() as warm:
        _watched(warm, y0, cfg)
    assert cold.summary()["traces"] == 1
    assert warm.summary()["traces"] == 0 and warm.retraces == 0
    # a new bucket is a first build of another program key, not a retrace
    rec = obs.Recorder()
    graphs.clear_programs()
    with obs.CompileWatch(recorder=rec) as w:
        _watched(w, y0, cfg)
        _watched(w, y0[:4], {"k": cfg["k"][:4]})
        assert w.summary()["traces"] == 2 and w.retraces == 0
        # the same program built again under the same key (its cache
        # dropped): a retrace, with its event on the recorder
        graphs.clear_programs()
        _watched(w, y0, cfg)
    assert w.retraces == 1
    assert [e["name"] for e in rec.events] == ["retrace"]
    assert w.summary()["by_label"]["sweep-segment"]["programs"] == {
        "b8": 2, "b4": 1}


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


H2O2_T = np.linspace(1100.0, 1500.0, B)
H2O2_X = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


def test_gas_sweep_counters_against_jax(h2o2):
    """The h2o2 sweep at B = 8, float64 ``lu``: per-lane counters equal the
    JAX package's where the two packages take the same steps; the lanes
    whose step counts differ are reported (ROADMAP tolerance tiers)."""
    gm_j, th_j, gm_t, th_t = h2o2
    ref = br.batch_reactor_sweep(
        H2O2_X, H2O2_T, 1e5, 5e-4, chem=br.Chemistry(gaschem=True),
        thermo_obj=th_j, md=gm_j, jac_window=1, linsolve="lu",
        telemetry=True, timeline=TIMELINE)
    out = bt.batch_reactor_sweep(
        H2O2_X, H2O2_T, 1e5, 5e-4, chem=bt.Chemistry(gaschem=True),
        thermo_obj=th_t, md=gm_t, linsolve="lu", telemetry=True,
        timeline=TIMELINE, device="cpu")
    pl = out["telemetry"]["solver_stats"]["per_lane"]
    pl_j = ref["telemetry"]["solver_stats"]["per_lane"]
    assert set(pl) == set(pl_j)
    same = np.array([pl["n_accepted"][i] == pl_j["n_accepted"][i]
                     and pl["n_rejected"][i] == pl_j["n_rejected"][i]
                     for i in range(B)])
    print(f"h2o2 lanes with equal step counts: {int(same.sum())} of {B}")
    assert same.any()
    for k in pl:
        if k in ("timeline_t", "timeline_h"):
            continue
        a, b = np.asarray(pl[k])[same], np.asarray(pl_j[k])[same]
        np.testing.assert_array_equal(a, b, err_msg=k)
    st = out["telemetry"]["solver_stats"]["totals"]
    assert st["err_rejects"] + st["conv_rejects"] == st["n_rejected"]
    assert out["telemetry"]["meta"]["timeline"] == TIMELINE


def test_sweep_telemetry_off_keeps_the_return_shape(h2o2):
    _, _, gm_t, th_t = h2o2
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th_t, md=gm_t,
              linsolve="lu", device="cpu", segment_steps=64)
    plain = bt.batch_reactor_sweep(H2O2_X, H2O2_T[:2], 1e5, 5e-4, **kw)
    tel = bt.batch_reactor_sweep(H2O2_X, H2O2_T[:2], 1e5, 5e-4,
                                 telemetry=True, **kw)
    assert "telemetry" not in plain and set(tel) == set(plain) | {
        "telemetry"}
    for k in ("t", "status"):
        np.testing.assert_array_equal(tel[k], plain[k])
    rep = tel["telemetry"]
    assert rep["schema"] == "br-obs-v1"
    assert {s["name"] for s in rep["spans"]} >= {"solve", "segment"}
    assert rep["counters"]["blocking_syncs"] > 0
    assert rep["solver_stats"]["per_lane"]["n_accepted"] == [
        int(v) for v in rep["solver_stats"]["per_lane"]["n_accepted"]]


def test_batch_reactor_telemetry_totals_equal_jax(fixtures_dir, tmp_path):
    xml = str(tmp_path / "batch_h2o2.xml")
    shutil.copy(os.path.join(fixtures_dir, "batch_h2o2.xml"), xml)
    status, rep = bt.batch_reactor(xml, fixtures_dir, gaschem=True,
                                   verbose=False, telemetry=True,
                                   device="cpu")
    xml_j = str(tmp_path / "j" / "batch_h2o2.xml")
    os.makedirs(os.path.dirname(xml_j))
    shutil.copy(os.path.join(fixtures_dir, "batch_h2o2.xml"), xml_j)
    status_j, rep_j = br.batch_reactor(xml_j, fixtures_dir, gaschem=True,
                                       verbose=False, telemetry=True)
    assert status == status_j == "Success"
    assert {s["name"] for s in rep["spans"]} >= {"parse", "solve", "write"}
    assert rep["solver_stats"]["totals"] == rep_j["solver_stats"]["totals"]
    assert rep["compile"]["retraces"] == 0
    # telemetry off: the status string alone
    assert bt.batch_reactor(xml, fixtures_dir, gaschem=True, verbose=False,
                            device="cpu") == "Success"


# ---------------------------------------------------------------------------
# the checkpointed, elastic and sensitivity drivers
# ---------------------------------------------------------------------------

def test_checkpointed_stats_persist_and_read_in_jax(tmp_path):
    """``stats=True`` persists each lane's counters in its chunk under the
    JAX package's ``stat_*`` keys: a resume returns them unchanged and the
    JAX package reads them."""
    from batchreactor_tpu.parallel import checkpoint as ck_j
    from batchreactor_tpu_torch.parallel import checkpoint as ck

    y0, cfg = _lanes()
    kw = dict(chunk_size=4, linsolve="lu", jac=_jac, stats=True,
              segment_steps=16)
    rec = obs.Recorder()
    first = ck.checkpointed_sweep(_rhs, y0, 0.0, 0.2, cfg, str(tmp_path),
                                  recorder=rec, **kw)
    again = ck.checkpointed_sweep(_rhs, y0, 0.0, 0.2, cfg, str(tmp_path),
                                  **kw)
    for k in first.stats:
        assert torch.equal(first.stats[k], again.stats[k]), k
    np.testing.assert_array_equal(first.stats["n_accepted"].numpy(),
                                  first.n_accepted.numpy())
    res_j, _ = ck_j.load_result(str(tmp_path / "chunk_00001.npz"))
    for k, v in res_j.stats.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      first.stats[k][4:].numpy())
    names = rec.by_name()
    assert names["chunk_solve"]["count"] == 2
    assert names["chunk_save"]["count"] == 2
    assert names["segment"]["count"] >= 2


def test_elastic_fleet_snapshot_reads_in_jax(tmp_path):
    from batchreactor_tpu_torch.parallel import multihost as mh

    y0, cfg = _lanes()
    rec = obs.Recorder()
    mh.elastic_checkpointed_sweep(_rhs, y0, 0.0, 0.1, cfg, str(tmp_path),
                                  process_id=0, num_processes=1,
                                  chunk_size=4, linsolve="lu", jac=_jac,
                                  segment_steps=16, recorder=rec)
    snaps = live_j.read_fleet_snapshots(str(tmp_path))
    assert [s["pid"] for s in snaps] == [0]
    assert snaps == live.read_fleet_snapshots(str(tmp_path))
    assert snaps[0]["gauges"]["chunks_total"] == 2
    assert snaps[0]["counters"]["lane_attempts"] > 0
    assert rec.counters["fleet_snapshots"] >= 2


def test_sensitivity_runs_record_spans_and_counters():
    from batchreactor_tpu_torch.sensitivity import adjoint, forward

    y0, cfg = _lanes()

    def rhs_theta(t, y, theta, c):
        return -(c["k"] * torch.exp(theta["s"][..., 0]))[:, None] * y

    theta = {"s": torch.zeros(1, dtype=torch.float64)}
    rec = obs.Recorder()
    res = forward.solve_forward(rhs_theta, y0, 0.0, 0.1, theta, cfg,
                                linsolve="lu", stats=True, recorder=rec)
    np.testing.assert_array_equal(res.stats["n_accepted"].numpy(),
                                  res.n_accepted.numpy())
    assert rec.spans[0]["name"] == "sens_forward"
    assert rec.spans[0]["attrs"]["n_accepted"] == int(res.n_accepted.sum())
    qoi, grad, aux = adjoint.solve_adjoint(
        rhs_theta, adjoint.final_species_qoi(0), y0[:2], 0.0, 0.05, theta,
        {"k": cfg["k"][:2]}, linsolve="lu", grid_size=64, stats=True,
        recorder=rec)
    assert [s["name"] for s in rec.spans[1:]] == ["adjoint_pin",
                                                  "adjoint_grad"]
    np.testing.assert_array_equal(aux["stats"]["n_accepted"].numpy(),
                                  aux["n_accepted"].numpy())


def test_device_trace_means_cuda_and_traces_the_cpu_by_name(tmp_path):
    """``device_trace(dir)`` means ``cuda``, as every entry point of the
    port: without a card it raises instead of quietly tracing the host;
    ``device="cpu"`` writes a Chrome trace of the host."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with prof.device_trace(str(tmp_path / "none")):
                pass
        assert not (tmp_path / "none" / "trace.json").exists()
    with prof.device_trace(str(tmp_path / "cpu"), device="cpu") as path:
        torch.ones(4, dtype=torch.float64).sum()
    with open(path) as f:
        assert "traceEvents" in f.read()
