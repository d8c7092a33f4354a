"""Port parity: the resilience layer (batchreactor_tpu_torch/resilience)
against the JAX package's ``resilience/``, on the CPU.

The policy normalizations and the fault-injection spec parser give the
same results (or raise the same exception type) over one table of inputs;
the wedge watchdog raises ``WedgeError`` past its deadline at the choke
point of both gears and adds nothing without one; the sweep API's
quarantine recovers a lane the way the JAX package's does.  ROADMAP C6:
a CUDA runtime error is never retried in-process.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.resilience import inject as inject_j
from batchreactor_tpu.resilience import policy as policy_j
from batchreactor_tpu.resilience import watchdog as watchdog_j
from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
from batchreactor_tpu_torch.parallel import checkpoint as ck
from batchreactor_tpu_torch.resilience import (QuarantinePolicy, RetryPolicy,
                                               WedgeError, clear_suspects,
                                               cuda_error, inject,
                                               normalize_quarantine,
                                               normalize_retry,
                                               resolve_fetch_deadline,
                                               retryable, run_guarded,
                                               suspect_devices)
from batchreactor_tpu_torch.resilience import heartbeat as hb
from batchreactor_tpu_torch.solver.common import SUCCESS

torch.set_num_threads(1)

H2O2_X = {"H2": 0.25, "O2": 0.25, "N2": 0.5}


@pytest.fixture(autouse=True)
def _disarm():
    """No armed plan (or suspect entry) may leak across tests."""
    inject.disarm()
    inject_j.disarm()
    clear_suspects()
    yield
    inject.disarm()
    inject_j.disarm()
    clear_suspects()


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay(B=8):
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64).expand(B, 2).clone()
    return y0, {"k": torch.logspace(1.0, 2.0, B, dtype=torch.float64)}


def _outcome(fn, arg):
    """The normalized policy as a comparable tuple, or the exception
    type."""
    try:
        p = fn(arg)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return None if p is None else (type(p).__name__,
                                   tuple(vars(p).items()))


POLICY_CASES = [
    ("retry", None), ("retry", False), ("retry", True), ("retry", 0),
    ("retry", 3), ("retry", -1), ("retry", {"max_retries": 1,
                                            "backoff_s": 0.0}),
    ("retry", {"nope": 1}), ("retry", {"backoff_factor": 0.5}),
    ("retry", "yes"), ("retry", 1.5),
    ("quarantine", None), ("quarantine", False), ("quarantine", True),
    ("quarantine", {"rtol_factor": 0.1, "max_steps_factor": 8.0}),
    ("quarantine", {"rtol_factor": 3.0}), ("quarantine", {"nope": 1}),
    ("quarantine", {"max_steps_factor": 0.5}), ("quarantine", "yes"),
    ("quarantine", {"oracle": True}), ("quarantine", 2),
]


@pytest.mark.parametrize("kind,arg", POLICY_CASES,
                         ids=[f"{k}-{a!r}" for k, a in POLICY_CASES])
def test_policy_normalization_matches_jax(kind, arg):
    port = normalize_retry if kind == "retry" else normalize_quarantine
    ref = (policy_j.normalize_retry if kind == "retry"
           else policy_j.normalize_quarantine)
    assert _outcome(port, arg) == _outcome(ref, arg)


def test_policy_instances_pass_through_and_backoff():
    p = RetryPolicy(max_retries=1, backoff_s=1.0)
    assert normalize_retry(p) is p and p.delay(2) == 4.0
    q = QuarantinePolicy()
    assert normalize_quarantine(q) is q


INJECT_SPECS = [
    "", "hang_fetch", "hang_fetch:delay=2,count=2;nan_lane:lane=3",
    "kill:chunk=2", " corrupt_chunk : chunk=1 ; kill ",
    "slow_request:delay=0.4,request=r7", "melt_chip", "kill:chunk",
    "nan_lane:lane=3,,count=2", "hang_fetch:=3",
]


@pytest.mark.parametrize("spec", INJECT_SPECS)
def test_inject_spec_parser_matches_jax(spec):
    def parsed(mod):
        try:
            return [(p.kind, p.params, p.count) for p in mod._parse(spec)]
        except Exception as e:  # noqa: BLE001 — the type is compared
            return type(e).__name__

    assert parsed(inject) == parsed(inject_j)


def test_inject_firing_counts_match_jax():
    spec = "hang_fetch:delay=2,count=2;kill:chunk=5"
    inject.arm(spec)
    inject_j.arm(spec)
    for _ in range(3):
        assert inject.fetch_hang_delay() == inject_j.fetch_hang_delay()
    assert inject.active() == inject_j.active()
    inject.kill_now(4)   # another chunk: no firing
    assert inject.active()


def test_fetch_deadline_resolution_matches_jax(monkeypatch):
    for env, arg in (("", None), ("7.5", None), ("0", None), ("", 5.0),
                     ("", 0), ("", -1.0)):
        monkeypatch.setenv("BR_FETCH_DEADLINE_S", env)
        got = [_try(resolve_fetch_deadline, arg),
               _try(watchdog_j.resolve_fetch_deadline, arg)]
        assert got[0] == got[1], (env, arg, got)


def _try(fn, arg):
    try:
        return fn(arg)
    except Exception as e:  # noqa: BLE001 — the type is compared
        return type(e).__name__


def test_watchdog_hang_raises_and_marks_suspect():
    from batchreactor_tpu_torch.resilience.watchdog import fetch_with_deadline

    x = torch.arange(4.0)
    np.testing.assert_array_equal(fetch_with_deadline((x,), 30.0)[0],
                                  np.arange(4.0))
    inject.arm("hang_fetch:delay=10")
    t0 = time.perf_counter()
    with pytest.raises(WedgeError) as ei:
        fetch_with_deadline((x,), 0.3, label="test-fetch")
    assert time.perf_counter() - t0 < 5.0   # the deadline, not the hang
    assert ei.value.deadline_s == 0.3
    assert "cpu" in suspect_devices()


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "blocking"])
def test_segmented_fetch_deadline_surfaces_wedge(pipeline):
    """The deadline reaches the flag reads of the pipelined gear and the
    loop breaks of the blocking gear (one choke point), and the faulted
    program is not reused: the next sweep equals a clean one."""
    y0, cfg = _decay(4)
    kw = dict(segment_steps=64, max_segments=50, linsolve="lu",
              pipeline=pipeline)
    clean = ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg, **kw)
    inject.arm("hang_fetch:delay=10")
    with pytest.raises(WedgeError):
        ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg,
                                 fetch_deadline=0.3, **kw)
    again = ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg,
                                     fetch_deadline=30.0, **kw)
    assert torch.equal(clean.y, again.y)
    assert torch.equal(clean.status, again.status)


def test_no_deadline_adds_no_guarded_wait(monkeypatch):
    """With fetch_deadline=None the choke point never reaches the
    watchdog (no event, poll or thread), and an armed hang stays
    unconsumed."""
    from batchreactor_tpu_torch.resilience import watchdog

    def boom(*a, **k):
        raise AssertionError("guarded wait without a deadline")

    monkeypatch.setattr(watchdog, "block_with_deadline", boom)
    monkeypatch.delenv("BR_FETCH_DEADLINE_S", raising=False)
    inject.arm("hang_fetch:delay=10")
    y0, cfg = _decay(4)
    for pipeline in (True, False):
        res = ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg,
                                       segment_steps=64, linsolve="lu",
                                       pipeline=pipeline)
        assert bool((res.status == SUCCESS).all())
    assert inject.active()


# ----------------------------------------------------------------- C6
CUDA_ERRORS = ["CUDA error: an illegal memory access was encountered",
               "CUDA driver error: unknown error",
               "CUBLAS_STATUS_EXECUTION_FAILED when calling cublasDgemm"]


@pytest.mark.parametrize("msg", CUDA_ERRORS)
def test_c6_cuda_error_is_not_retried(tmp_path, monkeypatch, msg):
    """ROADMAP C6: the JAX package retries every RuntimeError; the port
    re-raises a CUDA runtime error at once (a sticky one leaves the
    context unusable) and still retries other runtime faults."""
    calls = []
    real = ck._solve_chunk

    def failing(err):
        def solve(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError(err)
            return real(*a, **k)
        return solve

    y0, cfg = _decay(4)
    monkeypatch.setattr(ck, "_solve_chunk", failing(msg))
    assert policy_j.RETRYABLE and isinstance(RuntimeError(msg),
                                             policy_j.RETRYABLE)
    with pytest.raises(RuntimeError, match="CUDA|CUBLAS"):
        ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                              str(tmp_path / "c6"), chunk_size=4,
                              retry={"max_retries": 2, "backoff_s": 0.0},
                              linsolve="lu")
    assert len(calls) == 1
    rows = json.load(open(tmp_path / "c6" / "manifest.json"))["attempts"]
    assert [r["outcome"] for r in rows["0"]] == ["error"]
    # a runtime fault that is not CUDA's is retried, as in the JAX package
    calls.clear()
    monkeypatch.setattr(ck, "_solve_chunk", failing("transient glitch"))
    res = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                str(tmp_path / "ok"), chunk_size=4,
                                retry={"max_retries": 2, "backoff_s": 0.0},
                                linsolve="lu")
    assert len(calls) == 2 and bool((res.status == SUCCESS).all())


def test_c6_classification():
    assert cuda_error(RuntimeError(CUDA_ERRORS[0]))
    assert not cuda_error(WedgeError("blocking device wait [x] exceeded"))
    assert retryable(WedgeError("x")) and retryable(OSError("disk"))
    assert retryable(RuntimeError("transient"))
    assert not retryable(RuntimeError(CUDA_ERRORS[0]))
    assert not retryable(ValueError("bug"))
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            err = accel("CUDA error: misaligned address")
        except TypeError:
            err = None
        if err is not None:
            assert cuda_error(err) and not retryable(err)


# ------------------------------------------------------- the API knobs
@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    return (gm_j, br.create_thermo(list(gm_j.species), therm),
            gm_t, bt.create_thermo(list(gm_t.species), therm, device="cpu"))


def test_api_validates_resilience_knobs_as_jax(h2o2):
    gm_j, th_j, gm_t, th_t = h2o2
    for kw, err in (({"fetch_deadline": 5.0}, "segmented-path knobs"),
                    ({"quarantine": "yes"}, "quarantine must be"),
                    ({"quarantine": {"rtol_factor": 3.0}}, "TIGHTENS")):
        with pytest.raises(ValueError, match=err):
            br.batch_reactor_sweep(H2O2_X, [1200.0], 1e5, 1e-5,
                                   chem=br.Chemistry(gaschem=True),
                                   thermo_obj=th_j, md=gm_j, **kw)
        with pytest.raises(ValueError, match=err):
            bt.batch_reactor_sweep(H2O2_X, [1200.0], 1e5, 1e-5,
                                   chem=bt.Chemistry(gaschem=True),
                                   thermo_obj=th_t, md=gm_t, device="cpu",
                                   **kw)
    # the oracle rung runs (ROADMAP A16): armed, with no failed lane to
    # hand it, the sweep is the quarantine-off sweep
    out = bt.batch_reactor_sweep(H2O2_X, [1200.0], 1e5, 1e-5,
                                 chem=bt.Chemistry(gaschem=True),
                                 thermo_obj=th_t, md=gm_t, device="cpu",
                                 quarantine={"oracle": True})
    assert out["report"]["counts"] == {"success": 1}
    assert out["provenance"].tolist() == [0]


def test_api_oracle_is_isothermal_only_as_jax(h2o2):
    """The native BDF runtime is isothermal: an energy sweep with the
    oracle rung raises the JAX package's error."""
    gm_j, th_j, gm_t, th_t = h2o2
    q = {"quarantine": {"oracle": True}, "energy": "adiabatic_v"}
    with pytest.raises(ValueError, match="isothermal-only"):
        br.batch_reactor_sweep(H2O2_X, [1200.0], 1e5, 1e-5,
                               chem=br.Chemistry(gaschem=True),
                               thermo_obj=th_j, md=gm_j, **q)
    with pytest.raises(ValueError, match="isothermal-only"):
        bt.batch_reactor_sweep(H2O2_X, [1200.0], 1e5, 1e-5,
                               chem=bt.Chemistry(gaschem=True),
                               thermo_obj=th_t, md=gm_t, device="cpu", **q)


# ------------------------------------------------- the oracle rung
ORACLE_T = np.linspace(1100.0, 1400.0, 4)
ORACLE_BAD = (1, 2)
ORACLE_T1 = 1e-4


def _poison_t(res, T, bad_T, pkg):
    """``res`` with the lanes whose temperature is in ``bad_T`` failed as
    a NaN blowup (y NaN, status DT_UNDERFLOW), in ``pkg``'s arrays."""
    import dataclasses

    hit = np.isin(np.asarray(T), list(bad_T))
    if pkg == "torch":
        from batchreactor_tpu_torch.solver.common import DT_UNDERFLOW

        m = torch.as_tensor(hit)
        return dataclasses.replace(
            res, y=torch.where(m[:, None], float("nan"), res.y),
            status=torch.where(m, DT_UNDERFLOW, res.status))
    import jax.numpy as jnp

    from batchreactor_tpu.solver.sdirk import DT_UNDERFLOW as DT_J

    m = jnp.asarray(hit)
    return dataclasses.replace(
        res, y=jnp.where(m[:, None], jnp.nan, res.y),
        status=jnp.where(m, DT_J, res.status))


def _oracle_case(h2o2, pkg):
    """The quarantine ladder over 4 h2o2 lanes, lanes ORACLE_BAD failed
    on every device pass, with the package's ``native_oracle``: (result,
    provenance, the passes asked)."""
    import jax.numpy as jnp

    from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
    from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
    from batchreactor_tpu.parallel import ensemble_solve as solve_j
    from batchreactor_tpu.parallel import sweep_solution_vectors as svv_j
    from batchreactor_tpu.resilience import quarantine as quarantine_j
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import ensemble_solve
    from batchreactor_tpu_torch.resilience import quarantine as qr

    gm_j, th_j, gm_t, th_t = h2o2
    sp = list(gm_t.species)
    X = np.zeros((len(ORACLE_T), len(sp)))
    for k, v in H2O2_X.items():
        X[:, sp.index(k)] = v
    bad_T = {float(ORACLE_T[i]) for i in ORACLE_BAD}
    passes = []
    if pkg == "torch":
        T = torch.tensor(ORACLE_T)
        y0 = bt.get_solution_vector(X, th_t.molwt, T, 1e5)
        rhs, jac = make_gas_rhs(gm_t, th_t), make_gas_jac(gm_t, th_t)

        def solve(y, c, rtol=1e-6, atol=1e-10, max_steps=200_000):
            return ensemble_solve(rhs, y, 0.0, ORACLE_T1, c, jac=jac,
                                  linsolve="lu", rtol=rtol, atol=atol,
                                  max_steps=max_steps)
        mod, cfg = qr, {"T": T}
        take_T = lambda c: c["T"].numpy()  # noqa: E731
    else:
        T = jnp.asarray(ORACLE_T)
        y0 = svv_j(jnp.asarray(X), th_j.molwt, T, 1e5)
        rhs, jac = rhs_j(gm_j, th_j), jac_j(gm_j, th_j)

        def solve(y, c, rtol=1e-6, atol=1e-10, max_steps=200_000):
            return solve_j(rhs, y, 0.0, ORACLE_T1, c, jac=jac,
                           linsolve="lu", rtol=rtol, atol=atol,
                           max_steps=max_steps)
        mod, cfg = quarantine_j, {"T": T}
        take_T = lambda c: np.asarray(c["T"])  # noqa: E731
    pol = (QuarantinePolicy if pkg == "torch"
           else policy_j.QuarantinePolicy)(oracle=True)

    def subset(y, c, pass_name):
        passes.append((pass_name, int(y.shape[0])))
        kw = ({} if pass_name == "retry" else
              {"rtol": 1e-6 * pol.rtol_factor, "atol": 1e-10 * pol.atol_factor,
               "max_steps": int(200_000 * pol.max_steps_factor)})
        return _poison_t(solve(y, c, **kw), take_T(c), bad_T, pkg)

    res0 = _poison_t(solve(y0, cfg), ORACLE_T, bad_T, pkg)
    oracle = mod.native_oracle(rhs, 0.0, ORACLE_T1, rtol=1e-6, atol=1e-10)
    res, prov = mod.resolve(res0, y0, cfg, subset, policy=pol,
                            oracle=oracle)
    return res, np.asarray(prov), passes


def test_resolve_oracle_rung_matches_jax(h2o2):
    """Lanes that fail every device pass reach the oracle in both
    packages: the same passes asked, the same provenance, every lane
    successful, the oracle lanes' state at the rtol scale of the JAX
    package's and their native step counts equal."""
    from batchreactor_tpu_torch.resilience import quarantine as qr

    res_t, prov_t, passes_t = _oracle_case(h2o2, "torch")
    res_j, prov_j, passes_j = _oracle_case(h2o2, "jax")
    assert passes_t == passes_j == [("retry", 4), ("fallback", 2)]
    np.testing.assert_array_equal(prov_t, prov_j)
    assert [qr.PROVENANCE_NAMES[c] for c in prov_t] == [
        "primary", "oracle", "oracle", "primary"]
    assert bool((res_t.status == SUCCESS).all())
    bad = list(ORACLE_BAD)
    np.testing.assert_allclose(res_t.y.numpy()[bad],
                               np.asarray(res_j.y)[bad], rtol=1e-9,
                               atol=1e-15)
    np.testing.assert_array_equal(res_t.n_accepted.numpy()[bad],
                                  np.asarray(res_j.n_accepted)[bad])
    np.testing.assert_array_equal(res_t.t.numpy(), np.asarray(res_j.t))


def test_native_oracle_raises_where_jax_warns(h2o2, tmp_path, monkeypatch):
    """The port differs from the JAX package on purpose (ROADMAP A16): a
    runtime that cannot build raises ``NativeUnavailable`` (the JAX
    package warns and skips the rung), and an exception inside a lane's
    solve propagates (the JAX package reads it as "no answer")."""
    from batchreactor_tpu_torch.native import NativeUnavailable, bindings
    from batchreactor_tpu_torch.resilience import quarantine as qr

    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64)

    def broken(t, y, cfg):
        raise ArithmeticError("lane blew up")

    oracle = qr.native_oracle(broken, 0.0, 1.0)
    with pytest.raises(ArithmeticError, match="lane blew up"):
        oracle(y0, {"k": torch.tensor(1.0, dtype=torch.float64)})
    bad = tmp_path / "br_native.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_SRC", str(bad))
    monkeypatch.setattr(bindings, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(NativeUnavailable):
        qr.native_oracle(_decay_rhs, 0.0, 1.0)


def test_api_quarantine_fallback_matches_jax(h2o2):
    """A lane that exhausts ``max_steps`` is recovered by the fallback
    pass in both packages: the same provenance codes and counts, every
    lane successful, the recovered x within 10 rtol of the JAX package's,
    and the live lanes equal to the quarantine-off sweep's bit for bit."""
    gm_j, th_j, gm_t, th_t = h2o2
    T = [1150.0, 1250.0, 1350.0]
    q = {"max_steps_factor": 100.0}
    kw_j = dict(chem=br.Chemistry(gaschem=True), thermo_obj=th_j, md=gm_j,
                max_steps=40)
    kw_t = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th_t, md=gm_t,
                max_steps=40, device="cpu")
    base = bt.batch_reactor_sweep(H2O2_X, T, 1e5, 1e-5, **kw_t)
    bad = base["status"] != SUCCESS
    assert bad.any(), "expected max_steps=40 to exhaust some lane"
    out = bt.batch_reactor_sweep(H2O2_X, T, 1e5, 1e-5, quarantine=q, **kw_t)
    ref = br.batch_reactor_sweep(H2O2_X, T, 1e5, 1e-5, quarantine=q, **kw_j)
    np.testing.assert_array_equal(out["provenance"],
                                  np.asarray(ref["provenance"]))
    assert out["report"]["quarantine"] == ref["report"]["quarantine"]
    assert np.all(out["status"] == SUCCESS)
    for sp in out["x"]:
        np.testing.assert_allclose(out["x"][sp], np.asarray(ref["x"][sp]),
                                   rtol=1e-5, atol=1e-12, err_msg=sp)
        np.testing.assert_array_equal(out["x"][sp][~bad],
                                      base["x"][sp][~bad], err_msg=sp)
    assert "provenance" not in base


# ------------------------------------------------ guard and heartbeat
def test_run_guarded_clean_and_timeout():
    ok = run_guarded([sys.executable, "-c", "print('hi')"], timeout=30)
    assert (ok.rc, ok.stdout.strip(), ok.timed_out) == (0, "hi", False)
    slow = run_guarded([sys.executable, "-c", "import time; "
                        "time.sleep(30)"], timeout=0.5, grace_s=5)
    assert slow.timed_out and slow.rc != 0 and slow.wall_s < 20


def test_heartbeat_liveness(tmp_path):
    path = str(tmp_path / "p0.hb")
    assert hb.file_age(path) is None and not hb.is_alive(path, 5.0)
    beat = hb.Heartbeat(path, 0.05)
    beat.start()
    try:
        time.sleep(0.2)
        assert hb.is_alive(path, 5.0)
    finally:
        beat.stop()
        beat.join(5)
    assert not beat.is_alive()
    assert not hb.is_alive(path, 1.0, now=time.time() + 10)
