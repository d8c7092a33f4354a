"""serving/ of the port: the schema, the scheduler, the streaming driver's
live feed, the session and the daemon, held to the JAX package's
``batchreactor_tpu/serving`` on the CPU.

* **schema** — one table of good and bad requests through both packages'
  ``validate_request``: equal ``Request`` fields, equal error messages;
* **scheduler** — the reference's fake-session invariants, run against
  the port's scheduler (packing, out-of-order harvest, backpressure,
  drain exactly once, pack-key isolation, the feed, stream death,
  slow-request injection, the adaptive window, the two-epoch spray), and
  one script through both schedulers with equal results;
* **the live feed** — a scripted ``_feed`` through the port's streaming
  driver and the JAX package's on the same lanes;
* **end to end over HTTP** on 127.0.0.1 with the vendored h2o2 fixture:
  served lanes equal the port's own streamed run bit for bit, and both
  packages' ``batch_reactor_sweep`` at 10 rtol; a warmed session captures
  and builds nothing; the JSONL face; the store's routing and eviction;
  two epochs; an energy session in operand mode;
* **the daemon** — ``tools/serve.py`` in a child process, drained by
  SIGTERM while two requests are stalled.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.obs.recorder import Recorder as JRecorder
from batchreactor_tpu.parallel.sweep import \
    ensemble_solve_segmented as j_segmented
from batchreactor_tpu.resilience import inject as jinject
from batchreactor_tpu.serving import schema as jschema
from batchreactor_tpu.serving.scheduler import Scheduler as JScheduler
from batchreactor_tpu_torch.obs.recorder import Recorder
from batchreactor_tpu_torch.parallel.sweep import ensemble_solve_segmented
from batchreactor_tpu_torch.resilience import inject
from batchreactor_tpu_torch.serving import schema
from batchreactor_tpu_torch.serving.scheduler import (Draining, Overloaded,
                                                      Scheduler)
from batchreactor_tpu_torch.solver import graphs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
_COMP = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


@pytest.fixture(autouse=True)
def _disarm_inject():
    yield
    inject.disarm()
    jinject.disarm()


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_reference_programs():
    """This file compiles the JAX package's streaming and energy sweeps;
    drop them when it ends, so a later file in the same worker that counts
    the compiles of its own first run sees them."""
    yield
    import jax

    jax.clear_caches()


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------
def _req(**over):
    base = {"id": "r1", "T": [1200.0, 1300.0],
            "X": {"H2": 0.3, "O2": 0.15, "N2": 0.55}, "t1": 1e-4}
    base.update(over)
    return base


_GOOD = [
    _req(), _req(p=2e5, rtol=1e-7), _req(T=1250.0, X={"H2": [0.3, 0.2]}),
    _req(energy="adiabatic_v"), _req(trace=True),
    _req(trace_ctx={"trace": "t-1", "span": "client", "hop": 2}),
    _req(mech="gri", Asv=[1.0, 2.0], n_save=0, v=1),
]
_BAD = [
    _req(T=[]), _req(T=-5.0), _req(T="hot"), _req(T=[[1200.0]]),
    _req(p=0.0), _req(X={}), _req(X={"H2": -0.1}), _req(X={"H2": 0.0}),
    _req(X={"H2": [0.3, 0.0]}), _req(t1=0.0), _req(n_save=16), _req(v=2),
    _req(bogus=1), _req(T=[1.0, 2.0], p=[1e5, 1e5, 1e5]),
    _req(energy="adiabatic_x"), _req(energy="adiabatic_p"),
    _req(energy="adiabatic_v", Asv=2.0), _req(trace="yes"),
    _req(trace_ctx={"trace": ""}), _req(trace_ctx={"trace": "t", "x": 1}),
    _req(trace_ctx={"trace": "t", "hop": -1}), _req(mech=""),
    _req(X={"XE": 1.0}), _req(T=[1.0] * 9), {"T": 1.0}, "not an object",
]
_VKW = dict(species=("H2", "O2", "N2", "H2O"), max_lanes=8,
            energy_modes=("adiabatic_v",))


def _fields(r):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else
                {n: a.tolist() for n, a in v.items()} if isinstance(v, dict)
                else v) for k, v in vars(r).items()}


@pytest.mark.parametrize("obj", _GOOD + _BAD, ids=range(len(_GOOD + _BAD)))
def test_validate_request_matches_the_reference(obj):
    def run(mod):
        try:
            r = mod.validate_request(obj, default_id="auto-1", **_VKW)
        except ValueError as e:
            return "error", str(e)
        return "ok", _fields(r), r.pack_key(), r.n_lanes

    got, ref = run(schema), run(jschema)
    assert got == ref
    assert (got[0] == "ok") == (obj in _GOOD)


def test_schema_constants_and_builders_match_the_reference():
    from batchreactor_tpu_torch.energy.eqns import ENERGY_MODES

    assert schema.ERROR_CODES == jschema.ERROR_CODES
    assert schema.ENERGY_MODES == jschema.ENERGY_MODES == ENERGY_MODES
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert schema.TRACE_CTX_VERSION == jschema.TRACE_CTX_VERSION
    for args in (("a", "overloaded", "full"), (None, "invalid", "x")):
        assert schema.error_response(*args) == jschema.error_response(*args)
    assert (schema.ok_response("a", {"lanes": 1})
            == jschema.ok_response("a", {"lanes": 1}))
    with pytest.raises(ValueError, match="error code"):
        schema.error_response("a", "nope", "x")
    for up in ({"id": "m", "mech": "M", "therm": "T"},
               {"id": "m", "mech": "", "therm": "T"}, {"id": "m"},
               {"id": "m", "mech": "M", "therm": "T", "warm": "no"}):
        def run(mod):
            try:
                return mod.validate_upload(up)
            except ValueError as e:
                return str(e)
        assert run(schema) == run(jschema)
    ctx = schema.trace_ctx_payload("t-9", span="s", hop=3)
    assert ctx == jschema.trace_ctx_payload("t-9", span="s", hop=3)
    assert schema.validate_trace_ctx(ctx) == ("t-9", "s", 3)


# --------------------------------------------------------------------------
# scheduler invariants (a fake session: no device, no HTTP)
# --------------------------------------------------------------------------
_SPEC = dict(max_queue_lanes=16, idle_timeout_s=0.05, coalesce_s=0.0,
             rtol=1e-6, atol=1e-10, request_timeout_s=10.0,
             max_lanes_per_request=None)


class FakeSession:
    """The scheduler-facing session surface with a scripted driver: lanes
    "solve" to ``y0 + 1000`` at ``t = t1``, harvested in a configurable
    order and chunking (the reference's fake session)."""

    def __init__(self, harvest="fifo", chunk=3, hold=None, fail=False,
                 recorder=None, **spec_over):
        self.spec = types.SimpleNamespace(**{**_SPEC, **spec_over})
        self.bucket_cap = 4
        self.recorder = Recorder() if recorder is None else recorder
        self.registry = None
        self.streams = []
        self.sources = []
        self.harvest = harvest
        self.chunk = chunk
        self.hold = hold
        self.fail = fail

    def request_lanes(self, req):
        y0 = np.stack([np.asarray(req.T), np.asarray(req.Asv)], axis=1)
        return y0, {"T": np.asarray(req.T), "Asv": np.asarray(req.Asv)}

    def stream(self, y0s, cfgs, *, t1, rtol, atol, on_harvest, feed, **kw):
        self.streams.append((t1, rtol, atol))
        self.sources.append(kw.get("live_source"))
        if self.hold is not None:
            self.hold.wait(5.0)
        if self.fail:
            raise RuntimeError("injected stream death")
        rows = {g: np.asarray(y0s)[g] for g in range(len(y0s))}
        pending = list(rows)
        while True:
            order = list(pending)
            if self.harvest == "reverse":
                order = order[::-1]
            elif self.harvest == "scramble":
                order = order[1::2] + order[0::2]
            for i in range(0, len(order), self.chunk):
                gids = np.asarray(order[i:i + self.chunk], dtype=np.int64)
                if not gids.size:
                    continue
                k = gids.size
                on_harvest(gids, {
                    "t": np.full((k,), t1),
                    "y": np.stack([rows[g] + 1000.0 for g in gids]),
                    "status": np.full((k,), 1, dtype=np.int32),
                    "h": np.full((k,), 1e-6),
                    "n_accepted": np.full((k,), 7, dtype=np.int64),
                    "n_rejected": np.zeros((k,), dtype=np.int64)})
            pending = []
            if feed is None:
                break
            got = feed(4, True)
            if got is None:
                break
            y_new, _cfg_new = got
            base = len(rows)
            for j in range(np.asarray(y_new).shape[0]):
                rows[base + j] = np.asarray(y_new)[j]
                pending.append(base + j)
            if not pending:
                break


def _request(rid, T, t1=1e-4, mod=schema, **over):
    return mod.validate_request(_req(id=rid, T=T, t1=t1, **over))


def _results(futures, timeout=10.0):
    return [f.result(timeout=timeout) for f in futures]


def test_concurrent_start_is_safe():
    for _ in range(10):
        sched = Scheduler(FakeSession())
        barrier = threading.Barrier(8)
        errors = []

        def go():
            try:
                barrier.wait(5.0)
                sched.start()
            except BaseException as e:  # noqa: BLE001 — the assert
                errors.append(e)

        threads = [threading.Thread(target=go) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert errors == [] and sched._worker.is_alive()
        sched.drain(5.0)


def test_packing_round_trip():
    sched = Scheduler(FakeSession()).start()
    futs = [sched.submit(_request("a", [1000.0, 1100.0, 1200.0])),
            sched.submit(_request("b", [2000.0])),
            sched.submit(_request("c", [3000.0, 3100.0]))]
    ra, rb, rc = _results(futs)
    sched.drain(5.0)
    np.testing.assert_array_equal(ra.y[:, 0], [2000.0, 2100.0, 2200.0])
    np.testing.assert_array_equal(rb.y[:, 0], [3000.0])
    np.testing.assert_array_equal(rc.y[:, 0], [4000.0, 4100.0])
    assert all(p == "success" for r in (ra, rb, rc) for p in r.provenance)
    np.testing.assert_array_equal(ra.t, [1e-4] * 3)
    assert ra.n_accepted.tolist() == [7, 7, 7]


@pytest.mark.parametrize("order", ["reverse", "scramble"])
def test_out_of_order_harvest(order):
    sched = Scheduler(FakeSession(harvest=order, chunk=2)).start()
    futs = [sched.submit(_request(f"r{i}", [1000.0 * (i + 1) + j
                                            for j in range(1 + i % 3)]))
            for i in range(5)]
    res = _results(futs)
    sched.drain(5.0)
    for i, r in enumerate(res):
        np.testing.assert_array_equal(
            r.y[:, 0], [1000.0 * (i + 1) + j + 1000.0
                        for j in range(1 + i % 3)])


def test_backpressure_overloaded():
    hold = threading.Event()
    sess = FakeSession(hold=hold, max_queue_lanes=4)
    sched = Scheduler(sess).start()
    futs = [sched.submit(_request("a", [1000.0, 1100.0]))]
    accepted = []
    with pytest.raises(Overloaded):
        for i in range(9):
            accepted.append(sched.submit(_request(f"q{i}", [1500.0 + i])))
    assert sess.recorder.snapshot()[2]["serve_rejects_overload"] >= 1
    hold.set()
    for r in _results(futs + accepted):
        assert all(p == "success" for p in r.provenance)
    sched.drain(5.0)


def test_drain_answers_exactly_once_then_rejects():
    hold = threading.Event()
    sess = FakeSession(hold=hold)
    sched = Scheduler(sess).start()
    futs = [sched.submit(_request(f"d{i}", [1000.0 + i])) for i in range(6)]
    t = threading.Thread(target=lambda: (time.sleep(0.05), hold.set()))
    t.start()
    assert sched.drain(10.0)
    t.join()
    assert len(_results(futs, timeout=1.0)) == 6
    with pytest.raises(Draining):
        sched.submit(_request("late", [999.0]))
    counters = sess.recorder.snapshot()[2]
    assert counters["serve_answered"] == 6
    assert counters["serve_rejects_draining"] == 1


def test_pack_key_isolation():
    sess = FakeSession()
    sched = Scheduler(sess).start()
    futs = [sched.submit(_request("a", [1000.0], t1=1e-4)),
            sched.submit(_request("b", [1001.0], t1=2e-4)),
            sched.submit(_request("c", [1002.0], t1=1e-4, rtol=1e-8))]
    res = _results(futs)
    sched.drain(5.0)
    assert res[0].t[0] == 1e-4 and res[1].t[0] == 2e-4
    assert {(t1, rtol) for t1, rtol, _ in sess.streams} == {
        (1e-4, 1e-6), (2e-4, 1e-6), (1e-4, 1e-8)}


def test_feed_joins_resident_epoch():
    sess = FakeSession(idle_timeout_s=1.0)
    sched = Scheduler(sess).start()
    sched.submit(_request("a", [1000.0])).result(5.0)
    r2 = sched.submit(_request("b", [2000.0, 2100.0])).result(5.0)
    sched.drain(5.0)
    np.testing.assert_array_equal(r2.y[:, 0], [3000.0, 3100.0])
    assert len(sess.streams) == 1
    assert sess.recorder.snapshot()[2]["serve_epochs"] == 1


def test_stream_death_answers_with_error():
    sess = FakeSession(fail=True)
    sched = Scheduler(sess).start()
    fut = sched.submit(_request("a", [1000.0]))
    with pytest.raises(RuntimeError, match="stream ended"):
        fut.result(5.0)
    sess.fail = False
    assert sched.submit(_request("b", [1200.0])).result(5.0).provenance \
        == ["success"]
    sched.drain(5.0)


def test_fatal_device_fault_halts_the_scheduler():
    """A session that reports a fatal fault (a CUDA error, never retried
    in-process) makes the scheduler refuse new work and fail what is
    queued, so the daemon can drain and exit non-zero."""
    hold = threading.Event()
    sess = FakeSession(fail=True, hold=hold)
    sess.fatal = RuntimeError("CUDA error: an illegal memory access")
    sched = Scheduler(sess).start()
    first = sched.submit(_request("a", [1000.0]))
    time.sleep(0.05)
    queued = sched.submit(_request("b", [1100.0], t1=2e-4))
    hold.set()
    with pytest.raises(RuntimeError, match="stream ended"):
        first.result(5.0)
    with pytest.raises(RuntimeError, match="serves no more"):
        queued.result(5.0)
    with pytest.raises(Draining):
        sched.submit(_request("c", [1200.0]))
    sched.drain(5.0)


def test_slow_request_injection():
    inject.arm("slow_request:delay=0.3,request=slow")
    sess = FakeSession()
    sched = Scheduler(sess).start()
    t0 = time.perf_counter()
    f_slow = sched.submit(_request("slow", [1000.0]))
    f_fast = sched.submit(_request("fast", [1100.0]))
    r_slow = f_slow.result(5.0)
    f_fast.result(5.0)
    wall = time.perf_counter() - t0
    sched.drain(5.0)
    assert r_slow.provenance == ["success"]
    assert wall >= 0.3 and r_slow.elapsed_s >= 0.3
    _s, events, counters = sess.recorder.snapshot()
    assert counters["serve_stalls"] == 1
    assert any(e["name"] == "fault" and e["attrs"].get("kind")
               == "slow_request" for e in events)
    assert r_slow.trace.segments()["resolved"] >= 0.3


def test_slow_request_delay_matches_the_reference(monkeypatch):
    spec = "slow_request:delay=0.25,request=x,count=2;slow_request:delay=0.5"
    inject.arm(spec)
    jinject.arm(spec)
    for rid in ("y", "x", "x", "x", "z"):
        assert (inject.slow_request_delay(rid)
                == jinject.slow_request_delay(rid)), rid
    inject.disarm()
    assert inject.slow_request_delay("x") == 0.0


def _p50_coalesce_wait(adaptive, n=3):
    sess = FakeSession(coalesce_s=0.6, coalesce_adaptive=adaptive)
    sched = Scheduler(sess).start()
    for i in range(n):
        sched.submit(_request(f"u{i}", [1000.0 + i])).result(10.0)
        time.sleep(0.2)
    sched.drain(5.0)
    waits = sorted(e["attrs"]["stages"]["coalesced"]
                   for e in sess.recorder.snapshot()[1]
                   if e["name"] == "request_trace")
    assert len(waits) == n
    return waits[n // 2]


def test_adaptive_coalesce_window():
    """The fixed window holds a lone request for ~coalesce_s; the adaptive
    one collapses it while the resident tier has room; a burst that fills
    the program seeds at once under both."""
    fixed = _p50_coalesce_wait(adaptive=False)
    adaptive = _p50_coalesce_wait(adaptive=True)
    assert fixed >= 0.5, fixed
    assert adaptive <= 0.1, adaptive
    for flag in (False, True):
        sess = FakeSession(coalesce_s=0.6, coalesce_adaptive=flag)
        sched = Scheduler(sess).start()
        t0 = time.monotonic()
        sched.submit(_request("burst", [1000.0, 1100.0, 1200.0,
                                        1300.0])).result(10.0)
        assert time.monotonic() - t0 < 0.4
        sched.drain(5.0)
        assert len(sess.streams) == 1


def test_two_epochs_spray_and_unshuffle():
    hold = threading.Event()
    sess = FakeSession(harvest="scramble", chunk=2, hold=hold,
                       resident_epochs=2, idle_timeout_s=0.05)
    sched = Scheduler(sess)
    assert sched.epochs == 2 and len(sched._workers) == 2
    futs = [sched.submit(_request(f"m{i}", [1000.0 * (i + 1) + j
                                            for j in range(1 + i % 2)]))
            for i in range(6)]
    sched.start()
    deadline = time.monotonic() + 5.0
    while len(sess.streams) < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(sess.streams) == 2
    hold.set()
    res = _results(futs)
    sched.drain(5.0)
    for i, r in enumerate(res):
        np.testing.assert_array_equal(
            r.y[:, 0], [1000.0 * (i + 1) + j + 1000.0
                        for j in range(1 + i % 2)])
    assert sorted(sess.sources) == ["sweep-e0", "sweep-e1"]
    counters = sess.recorder.snapshot()[2]
    assert counters["epoch_spray"] >= 1 and counters["serve_answered"] == 6


def test_one_script_through_both_schedulers():
    """The same requests through the JAX package's scheduler and the
    port's, each over its own fake session: equal results, provenance
    and recorder counters."""
    def run(Sched, mod, Rec, inj):
        inj.arm("slow_request:delay=0.05,request=r2")
        sess = FakeSession(harvest="scramble", chunk=2, recorder=Rec())
        sched = Sched(sess).start()
        futs = [sched.submit(_request(f"r{i}", [1000.0 * (i + 1) + j
                                                for j in range(1 + i % 3)],
                                      t1=(1e-4, 2e-4)[i % 2], mod=mod))
                for i in range(6)]
        res = _results(futs)
        sched.drain(5.0)
        with pytest.raises(Exception) as ei:
            sched.submit(_request("late", [1.0], mod=mod))
        counters = sess.recorder.snapshot()[2]
        keep = ("serve_requests", "serve_lanes", "serve_answered",
                "serve_stalls", "serve_rejects_draining")
        return ([(r.y.tolist(), r.t.tolist(), r.status.tolist(),
                  r.provenance, r.request.pack_key()) for r in res],
                {k: counters.get(k) for k in keep},
                type(ei.value).__name__, sorted(set(sess.streams)))

    assert (run(Scheduler, schema, Recorder, inject)
            == run(JScheduler, jschema, JRecorder, jinject))


# --------------------------------------------------------------------------
# the streaming driver's live feed, against the JAX package's
# --------------------------------------------------------------------------
def test_feed_requires_admission():
    y0 = torch.ones((2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="_feed"):
        ensemble_solve_segmented(
            lambda t, y, c: -y, y0, 0.0, 1.0, {}, segment_steps=16,
            linsolve="lu", _feed=lambda n, idle: None)


@pytest.mark.parametrize("stats", [False, True])
def test_scripted_feed_matches_the_reference(stats):
    """Two lanes up front and six through the feed, in blocks of two and
    one empty answer while lanes still run: the port's stream and the JAX
    package's give equal statuses, x within 10 rtol, and take the fed
    lanes at the same indices."""
    k = np.logspace(1.0, 2.5, 8)
    y0 = np.tile([1.0, 0.5], (8, 1))

    def script():
        blocks = [(y0[2:4], {"k": k[2:4]}), (np.zeros((0, 2)),
                                              {"k": np.zeros((0,))}),
                  (y0[4:6], {"k": k[4:6]}), (y0[6:8], {"k": k[6:8]})]
        asks = []

        def feed(n_space, idle):
            asks.append((int(n_space), bool(idle)))
            return blocks.pop(0) if blocks else None
        return feed, asks, blocks

    kw = dict(segment_steps=16, max_segments=400, poll_every=1,
              admission=2, refill=1, rtol=RTOL, atol=1e-10, stats=stats)
    f_t, asks_t, left_t = script()
    rec = Recorder()
    got = ensemble_solve_segmented(
        lambda t, y, c: -c["k"][:, None] * y,
        torch.as_tensor(y0[:2]), 0.0, 1.0, {"k": torch.as_tensor(k[:2])},
        linsolve="lu", _feed=f_t, recorder=rec, **kw)
    f_j, asks_j, left_j = script()
    ref = j_segmented(
        lambda t, y, cfg: -cfg["k"] * y, jnp.asarray(y0[:2]), 0.0, 1.0,
        {"k": jnp.asarray(k[:2])}, _feed=f_j, **kw)
    assert not left_t and not left_j
    # the same asks at the same polls: free slots, idle or not
    assert asks_t == asks_j
    assert all(n >= 1 for n, _ in asks_t)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(ref.status))
    assert got.status.shape == (8,)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y),
                               rtol=10 * RTOL, atol=1e-12)
    np.testing.assert_allclose(got.y.numpy(),
                               y0 * np.exp(-k)[:, None], rtol=1e-3,
                               atol=1e-8)
    assert rec.snapshot()[2]["fed_lanes"] == 6
    if stats:
        assert got.stats["n_accepted"].shape[0] == 8
        np.testing.assert_array_equal(got.stats["n_accepted"].numpy(),
                                      got.n_accepted.numpy())


def test_fed_lanes_equal_a_static_backlog():
    """Lanes appended through the feed solve bit for bit as the same
    lanes given as a static backlog (same resident bucket), at their
    sequential indices."""
    k = torch.logspace(1.0, 2.5, 6, dtype=torch.float64)
    y0 = torch.tensor([[1.0, 0.5]] * 6, dtype=torch.float64)
    kw = dict(segment_steps=16, max_segments=400, poll_every=1,
              admission=2, refill=1, linsolve="lu")
    rhs = (lambda t, y, c: -c["k"][:, None] * y)
    ref = ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {"k": k}, **kw)
    blocks = [(y0[2:4].numpy(), {"k": k[2:4].numpy()}),
              (y0[4:6].numpy(), {"k": k[4:6].numpy()})]
    live = ensemble_solve_segmented(
        rhs, y0[:2].clone(), 0.0, 1.0, {"k": k[:2].clone()},
        _feed=lambda n, idle: blocks.pop(0) if blocks else None, **kw)
    for f in ("t", "y", "status", "n_accepted", "n_rejected", "h"):
        assert torch.equal(getattr(live, f), getattr(ref, f)), f


# --------------------------------------------------------------------------
# end to end: a real session, real HTTP, the vendored h2o2 fixture
# --------------------------------------------------------------------------
def _spec(lib_dir, **serve_over):
    # one rung [8] and a wide coalesce window: every concurrent request
    # joins one seed, so served lanes sit where a direct streamed run of
    # the same conditions puts them (the reference's bit-exactness recipe)
    serve = {"resident": 8, "refill": 1, "buckets": [8], "poll_every": 1,
             "max_queue_lanes": 64, "idle_timeout_s": 0.3,
             "coalesce_s": 2.0}
    serve.update(serve_over)
    return {"mechanism": {"mech": f"{lib_dir}/h2o2.dat",
                          "therm": f"{lib_dir}/therm.dat"},
            "solver": {"segment_steps": 8, "stats": True,
                       "ignition_marker": "H2"},
            "serve": serve}


@pytest.fixture(scope="module")
def h2o2_session(lib_dir):
    from batchreactor_tpu_torch.serving.session import SolverSession

    session = SolverSession.from_spec(_spec(lib_dir), device="cpu")
    session.warmup()
    with session:
        yield session
    session.release()


def _direct_stream(session, Ts, t1):
    """The port's own streamed run of the conditions, with the session's
    callables and flags (no feed, the same single rung)."""
    req = schema.validate_request({"id": "d", "T": list(Ts), "X": _COMP,
                                   "t1": t1})
    y0, cfg = session.request_lanes(req)
    res = session._run(y0, cfg, t1=t1, rtol=session.spec.rtol,
                       atol=session.spec.atol, energy=None,
                       live_source="sweep", admission=8)
    return res, session.fractions(res.y.numpy())


def test_load_spec_reads_the_reference_fixture(fixtures_dir):
    from batchreactor_tpu.serving.session import load_spec as j_load
    from batchreactor_tpu_torch.serving.session import load_spec

    for name in ("serve_h2o2.json", "serve_mechshape.json"):
        path = os.path.join(fixtures_dir, name)
        assert (load_spec(path).__dict__ == j_load(path).__dict__)
    for bad, match in (({"mechanism": {"mech": "a"}}, "needs 'therm'"),
                       ({"mechanism": {"mech": "a", "therm": "b"},
                         "solver": {"rtoll": 1}}, "unknown solver"),
                       ({"mechanism": {"mech": "a", "therm": "b"},
                         "serve": {"upshift": 2}}, "upshift must be")):
        with pytest.raises(ValueError, match=match):
            load_spec(bad)


def test_http_request_equals_own_stream_and_both_sweeps(h2o2_session):
    from batchreactor_tpu_torch.serving.client import SolveClient
    from batchreactor_tpu_torch.serving.server import ServingServer

    session = h2o2_session
    before = graphs.captures(), session.program_compiles()
    N, t1 = 8, 5e-5
    Ts = [1150.0 + 37.0 * i for i in range(N)]
    with ServingServer(session, Scheduler(session)) as srv:
        resp = SolveClient(srv.url).solve(
            {"id": "exact", "T": Ts, "X": _COMP, "t1": t1})
    assert resp["solver_status"] == ["Success"] * N
    assert resp["provenance"] == ["success"] * N
    # the warm contract: nothing captured, no program built
    assert all(v == 0 for v in session.program_compiles().values()), \
        session.program_compiles()
    assert graphs.captures() == before[0]
    res, x = _direct_stream(session, Ts, t1)
    np.testing.assert_array_equal(resp["t"], res.t.numpy())
    for k, sp in enumerate(session.species):
        np.testing.assert_array_equal(resp["x"][sp], x[:, k], err_msg=sp)
    np.testing.assert_array_equal(resp["n_accepted"],
                                  res.n_accepted.numpy())
    # both packages' batch_reactor_sweep on the same conditions
    kw = dict(segment_steps=8, admission=8, refill=1, buckets=(8,),
              poll_every=1)
    out_t = bt.batch_reactor_sweep(
        _COMP, np.asarray(Ts), 1e5, t1, chem=bt.Chemistry(gaschem=True),
        thermo_obj=session.thermo, md=session.gm, device="cpu", **kw)
    gm = br.compile_gaschemistry(session.spec.mech)
    th = br.create_thermo(list(gm.species), session.spec.therm)
    out_j = br.batch_reactor_sweep(
        _COMP, np.asarray(Ts), 1e5, t1, chem=br.Chemistry(gaschem=True),
        thermo_obj=th, md=gm, **kw)
    for out in (out_t, out_j):
        for sp in session.species:
            np.testing.assert_allclose(resp["x"][sp],
                                       np.asarray(out["x"][sp]),
                                       rtol=10 * RTOL, atol=1e-14,
                                       err_msg=sp)
    assert len(resp["tau"]) == N
    assert resp["stats"]["newton_iters"][0] > 0


def test_concurrent_requests_trace_and_live_scrapes(h2o2_session):
    from batchreactor_tpu_torch.serving.client import SolveClient
    from batchreactor_tpu_torch.serving.server import ServingServer

    session = h2o2_session
    N, t1 = 8, 5e-5
    Ts = [1150.0 + 37.0 * i for i in range(N)]
    inject.arm("slow_request:delay=0.05,count=4")
    responses = [None] * N
    scrapes = []
    with ServingServer(session, Scheduler(session)) as srv:
        client = SolveClient(srv.url)
        stop = threading.Event()

        def scraper():
            while not stop.is_set():
                try:
                    scrapes.append(client.metrics())
                except OSError:
                    pass
                stop.wait(0.02)

        scr = threading.Thread(target=scraper, daemon=True)
        scr.start()

        def fire(i):
            responses[i] = client.solve({"id": f"e{i}", "T": [Ts[i]],
                                         "X": _COMP, "t1": t1,
                                         "trace": True})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(N)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stop.set()
        scr.join()
        health = client.healthz()
    assert health["serving"]["fingerprint"] == session.fingerprint
    assert health["serving"]["program_compiles"] == 0
    res, x = _direct_stream(session, Ts, t1)
    for i, resp in enumerate(responses):
        assert resp["solver_status"] == ["Success"]
        assert resp["t"][0] == float(res.t[i])
        for k, sp in enumerate(session.species):
            np.testing.assert_allclose(resp["x"][sp][0], x[i, k],
                                       rtol=1e-12, err_msg=sp)
        tr = resp["trace"]
        assert list(tr["stages"]) == sorted(tr["stages"],
                                            key=tr["stages"].get)
        assert sum(tr["segments"].values()) == pytest.approx(
            tr["total_s"], abs=5e-5)
    assert all(v == 0 for v in session.program_compiles().values())
    assert any("br_serve_stage_seconds_bucket{" in s for s in scrapes)
    assert any(ln.startswith("br_sweep_serve_inflight_lanes ")
               and float(ln.split()[-1]) > 0
               for s in scrapes for ln in s.splitlines())


def test_invalid_overload_and_jsonl_faces(h2o2_session):
    from batchreactor_tpu_torch.serving.client import (ServeError,
                                                       SolveClient)
    from batchreactor_tpu_torch.serving.server import (ServingServer,
                                                       serve_jsonl)

    session = h2o2_session
    with ServingServer(session, Scheduler(session,
                                          max_queue_lanes=1)) as srv:
        client = SolveClient(srv.url)
        with pytest.raises(ServeError) as ei:
            client.solve({"id": "bad", "T": [1200.0], "X": {"XE": 1.0},
                          "t1": 1e-5})
        assert ei.value.code == "invalid"
        with pytest.raises(ServeError) as ei:
            client.solve({"id": "big", "T": [1200.0, 1300.0], "X": _COMP,
                          "t1": 1e-5})
        assert ei.value.code == "overloaded"
    sched = Scheduler(session).start()
    lines = [json.dumps({"id": "j1", "T": [1200.0], "X": _COMP,
                         "t1": 5e-5}),
             json.dumps({"id": "j2", "T": "bogus", "X": _COMP, "t1": 5e-5}),
             json.dumps({"T": [1300.0], "X": _COMP, "t1": 5e-5})]
    out = io.StringIO()
    accepted, rejected = serve_jsonl(session, sched,
                                     io.StringIO("\n".join(lines)), out)
    assert (accepted, rejected) == (2, 1)
    got = {o["id"]: o for o in map(json.loads, out.getvalue().splitlines())}
    assert got["j1"]["status"] == "ok"
    assert got["j2"]["error"]["code"] == "invalid"
    assert [o["status"] for r, o in got.items()
            if r not in ("j1", "j2")] == ["ok"]


def test_warm_contract_needs_the_warmup(lib_dir):
    """Without warmup the first stream builds its programs (the watch sees
    them); after warmup a stream builds none, and the warmed programs are
    pinned past the program cache's cap."""
    from batchreactor_tpu_torch.serving.session import SolverSession

    cold = SolverSession.from_spec(_spec(lib_dir, buckets=[2, 4],
                                         resident=4), device="cpu")
    rhs0 = cold.rhs
    req = schema.validate_request({"id": "c", "T": [1200.0, 1250.0, 1300.0],
                                   "X": _COMP, "t1": 2e-5})
    with cold:
        y0, cfg = cold.request_lanes(req)
        cold.stream(y0, cfg, t1=2e-5, rtol=1e-6, atol=1e-10)
    assert sum(cold.program_compiles().values()) >= 1
    graphs.clear_programs()
    warm = SolverSession.from_spec(_spec(lib_dir, buckets=[2, 4],
                                         resident=4), device="cpu")
    assert warm.rhs is not rhs0      # a fresh parse: fresh callables
    warm.warmup()
    assert warm.warmup_summary["pinned"] >= 2
    # more unpinned programs than the cap: the pinned ones stay
    old_cap = graphs.MAX_PROGRAMS
    graphs.MAX_PROGRAMS = 1
    try:
        for B in (3, 5):
            ensemble_solve_segmented(
                lambda t, y, c: -y, torch.ones((B, 1), dtype=torch.float64),
                0.0, 1e-3, {}, linsolve="lu", segment_steps=8)
        with warm:
            y0, cfg = warm.request_lanes(req)
            res = warm.stream(y0, cfg, t1=2e-5, rtol=1e-6, atol=1e-10)
        assert all(v == 0 for v in warm.program_compiles().values()), \
            warm.program_compiles()
        assert (res.status.numpy() == 1).all()
    finally:
        graphs.MAX_PROGRAMS = old_cap
        warm.release()
    assert graphs.pinned_programs(warm._pin) == 0


def test_two_epochs_own_their_programs(lib_dir):
    """resident_epochs=2 on one device: each epoch replays its own
    programs (their keys carry the epoch), both run at once, and every
    lane equals the one-epoch session's."""
    from batchreactor_tpu_torch.serving.client import SolveClient
    from batchreactor_tpu_torch.serving.server import ServingServer
    from batchreactor_tpu_torch.serving.session import SolverSession

    session = SolverSession.from_spec(
        _spec(lib_dir, resident_epochs=2, coalesce_s=0.5), device="cpu")
    assert session.epoch_sources() == ("sweep-e0", "sweep-e1")
    session.warmup()
    assert {w["source"] for w in session.warmed} == {"sweep-e0",
                                                     "sweep-e1"}
    assert session.warmup_summary["pinned"] == 2
    Ts = [1150.0 + 37.0 * i for i in range(8)]
    responses = {}
    inject.arm("slow_request:delay=0.1,count=2")
    try:
        with session, ServingServer(session, Scheduler(session)) as srv:
            client = SolveClient(srv.url)

            def fire(t1):
                responses[t1] = client.solve({"id": f"k{t1}", "T": Ts,
                                              "X": _COMP, "t1": t1})

            threads = [threading.Thread(target=fire, args=(t1,))
                       for t1 in (5e-5, 1e-4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            counters = session.recorder.snapshot()[2]
        assert all(v == 0 for v in session.program_compiles().values())
        assert counters["serve_epochs"] >= 2
        for t1, resp in responses.items():
            assert resp["solver_status"] == ["Success"] * 8
            res, x = _direct_stream(session, Ts, t1)
            np.testing.assert_array_equal(resp["t"], res.t.numpy())
            for k, sp in enumerate(session.species):
                np.testing.assert_array_equal(resp["x"][sp], x[:, k])
    finally:
        session.release()


def test_energy_session_in_operand_mode_matches_the_sweeps(lib_dir):
    """``mech_operands=True`` with an energy mode: the session's bundle
    builder (``api._segmented_builder(energy=)``) serves adiabatic lanes
    that equal the padded energy sweep of the port and the JAX package's
    energy sweep."""
    from batchreactor_tpu_torch.api import _segmented_builder
    from batchreactor_tpu_torch.serving.session import SolverSession

    spec = {"mechanism": {"mech": f"{lib_dir}/h2o2.dat",
                          "therm": f"{lib_dir}/therm.dat"},
            "solver": {"segment_steps": 32, "stats": False,
                       "mech_operands": True,
                       "energy_modes": ["adiabatic_v"]},
            "serve": {"resident": 4, "buckets": [4], "coalesce_s": 0.0}}
    session = SolverSession.from_spec(spec, device="cpu")
    assert session.mech_shape == (16, 32)
    assert session._mode_fns["adiabatic_v"][0] is _segmented_builder(
        "gas", None, False, True, False, "adiabatic_v")
    Ts, t1 = [1150.0, 1250.0], 2e-5
    req = schema.validate_request({"id": "e", "T": Ts, "X": _COMP,
                                   "t1": t1, "energy": "adiabatic_v"},
                                  energy_modes=("adiabatic_v",))
    y0, cfg = session.request_lanes(req)
    assert y0.shape == (2, 17) and cfg["_atol_scale"].shape == (2, 17)
    with session:
        res = session.stream(y0, cfg, t1=t1, rtol=1e-6, atol=1e-10,
                             energy="adiabatic_v")
    session.release()
    T_end = res.y.numpy()[:, -1]
    kw = dict(energy="adiabatic_v", segment_steps=32)
    out_t = bt.batch_reactor_sweep(
        _COMP, np.asarray(Ts), 1e5, t1, chem=bt.Chemistry(gaschem=True),
        thermo_obj=session.thermo, md=session.gm, device="cpu",
        mech_operands=True, **kw)
    gm = br.compile_gaschemistry(session.spec.mech)
    th = br.create_thermo(list(gm.species), session.spec.therm)
    out_j = br.batch_reactor_sweep(
        _COMP, np.asarray(Ts), 1e5, t1, chem=br.Chemistry(gaschem=True),
        thermo_obj=th, md=gm, **kw)
    assert (res.status.numpy() == 1).all()
    for out in (out_t, out_j):
        np.testing.assert_allclose(T_end, np.asarray(out["T"]),
                                   rtol=10 * RTOL)
    x = session.fractions(res.y.numpy())
    for k, sp in enumerate(session.species):
        np.testing.assert_allclose(x[:, k], np.asarray(out_j["x"][sp]),
                                   rtol=10 * RTOL, atol=1e-12)
    d = res.observed
    assert "ign_tau_dT" in d


def test_store_routing_and_lru_eviction(lib_dir):
    from batchreactor_tpu_torch.serving.session import (SessionStore,
                                                        SolverSession,
                                                        UnknownMechanism)

    spec = _spec(lib_dir, max_mechanisms=2, buckets=[2], resident=2)
    base = SolverSession.from_spec(spec, device="cpu")
    store = SessionStore(base)
    try:
        fp_n = store.add_mechanism(f"{lib_dir}/h2o2_n.dat",
                                   f"{lib_dir}/therm.dat", mech_id="n",
                                   warm=False)
        assert fp_n != base.fingerprint
        s_n, _sch = store.resolve("n")
        assert s_n.fingerprint == fp_n
        assert store.resolve(fp_n[:16])[0] is s_n
        assert store.resolve()[0] is base
        with pytest.raises(UnknownMechanism):
            store.resolve("nope")
        # a third mechanism over capacity evicts the LRU unpinned one
        # (never the pinned default)
        with open(f"{lib_dir}/h2o2.dat") as f:
            text = f.read()
        with open(f"{lib_dir}/therm.dat") as f:
            therm = f.read()
        # a third mechanism (one rate constant changed) over capacity
        # evicts the least recently used unpinned one, never the default
        fp_u, info = store.add_upload(schema.validate_upload(
            {"id": "u", "mech": text.replace("1.7E13", "1.9E13"),
             "therm": therm, "warm": False}))
        assert fp_u not in (base.fingerprint, fp_n)
        ids = {tuple(m["ids"]) for m in store.mechanisms()}
        assert ids == {("default",), ("u",)}
        with pytest.raises(UnknownMechanism):
            store.resolve("n")
        assert store.recorder.snapshot()[2]["mech_evicted"] == 1
        assert info["species"] == list(base.species)
        # the same text again is the same mechanism: no new session
        fp_again, _ = store.add_upload(schema.validate_upload(
            {"id": "u2", "mech": text.replace("1.7E13", "1.9E13"),
             "therm": therm, "warm": False}))
        assert fp_again == fp_u and store.resolve("u2")[0] is \
            store.resolve("u")[0]
    finally:
        store.drain(5.0)


# --------------------------------------------------------------------------
# the daemon: SIGTERM drain of tools/serve.py in a child process
# --------------------------------------------------------------------------
def test_sigterm_drains_the_daemon(lib_dir, tmp_path):
    """SIGTERM while two accepted requests are stalled: new work gets
    ``draining`` (probes fire concurrently, so one lands between the flag
    and the shutdown), every accepted request is answered, a flight dump
    is written and the daemon exits 0."""
    from batchreactor_tpu_torch.serving.client import (ServeError,
                                                       SolveClient)

    spec = _spec(lib_dir, resident=4, buckets=[4], coalesce_s=0.0)
    spec_path = tmp_path / "serve.json"
    spec_path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "BR_FAULT_INJECT": "slow_request:delay=2.0,count=2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "batchreactor_tpu_torch.tools.serve",
         "--spec", str(spec_path), "--device", "cpu", "--flight-dir",
         str(tmp_path), "--no-warmup"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    results, probes = [], []
    try:
        line = {}
        t = threading.Thread(target=lambda: line.update(
            v=proc.stdout.readline()), daemon=True)
        t.start()
        t.join(60)
        assert line.get("v"), "the daemon printed no startup line"
        info = json.loads(line["v"])["serving"]
        client = SolveClient(info["url"], timeout=60)

        def fire(i, sink, rid):
            try:
                sink.append(("ok", client.solve(
                    {"id": rid, "T": [1200.0 + 10 * i], "X": _COMP,
                     "t1": 2e-5})))
            except ServeError as e:
                sink.append((e.code, None))
            except OSError:
                sink.append(("transport", None))

        threads = [threading.Thread(target=fire, args=(i, results, f"d{i}"))
                   for i in range(3)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:      # the stalls engaged
            h = client.healthz()["serving"]
            if h["inflight_lanes"] + h["queued_lanes"] == 0 and results:
                break
            if h["inflight_lanes"] >= 2:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        pthreads = []
        for i in range(20):
            th = threading.Thread(target=fire,
                                  args=(i, probes, f"late{i}"))
            th.start()
            pthreads.append(th)
            time.sleep(0.1)
        for th in threads + pthreads:
            th.join(60)
        rc = proc.wait(timeout=60)
        _out, err = proc.communicate(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert rc == 0, err[-2000:]
    assert [c for c, _ in results] == ["ok"] * 3, results
    assert all(r["provenance"] == ["success"] for _, r in results)
    assert "draining" in [c for c, _ in probes], probes
    assert list(tmp_path.glob("flight_*.jsonl"))
    assert '"drained"' in err
