"""Port parity: checkpointed sweeps (batchreactor_tpu_torch/parallel/
checkpoint.py) against the JAX package's, on the CPU.

A chunk written by either package reads back in the other with equal
fields; the h2o2 checkpointed sweep (B = 8, chunks of 4) takes the JAX
package's statuses with final states within 10 rtol; resume loads without
solving, a changed sweep raises, a torn chunk, a killed process and a hung
wait each recover to the clean run's values bit for bit, and a NaN lane's
quarantine gives the JAX package's provenance.  The resume fingerprint is
the same in two fresh processes.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
from batchreactor_tpu.parallel import checkpoint as ck_j
from batchreactor_tpu.parallel import sweep_solution_vectors as svv_j
from batchreactor_tpu.resilience import inject as inject_j
from batchreactor_tpu.resilience import quarantine as quarantine_j
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import checkpoint as ck
from batchreactor_tpu_torch.resilience import inject, quarantine
from batchreactor_tpu_torch.solver.common import SUCCESS

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-6
T1 = 1e-4
B = 8


@pytest.fixture(autouse=True)
def _disarm():
    inject.disarm()
    inject_j.disarm()
    yield
    inject.disarm()
    inject_j.disarm()


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay(n=B):
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64).expand(n, 2).clone()
    return y0, {"k": torch.logspace(1.0, 2.0, n, dtype=torch.float64)}


def _decay_sweep(d, **kw):
    y0, cfg = _decay()
    return ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg, str(d),
                                 chunk_size=4, linsolve="lu", **kw)


def _equal(a, b):
    for f in ("t", "y", "status", "n_accepted", "n_rejected", "h"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    sp = list(gm_t.species)
    X = np.zeros((B, len(sp)))
    X[:, sp.index("H2")], X[:, sp.index("O2")], X[:, sp.index("N2")] = (
        0.3, 0.15, 0.55)
    T = np.linspace(1100.0, 1500.0, B)
    y0_j = svv_j(jnp.asarray(X), th_j.molwt, jnp.asarray(T), 1e5)
    y0_t = bt.get_solution_vector(X, th_t.molwt, torch.tensor(T), 1e5)
    return dict(rhs_j=rhs_j(gm_j, th_j), jac_j=jac_j(gm_j, th_j),
                rhs_t=make_gas_rhs(gm_t, th_t), jac_t=make_gas_jac(gm_t, th_t),
                y0_j=y0_j, y0_t=y0_t, T=T)


def _h2o2_port(h, d, **kw):
    return ck.checkpointed_sweep(
        h["rhs_t"], h["y0_t"], 0.0, T1, {"T": torch.tensor(h["T"])}, str(d),
        chunk_size=4, jac=h["jac_t"], linsolve="lu", **kw)


def _h2o2_jax(h, d, **kw):
    return ck_j.checkpointed_sweep(
        h["rhs_j"], h["y0_j"], 0.0, T1, {"T": jnp.asarray(h["T"])}, str(d),
        chunk_size=4, jac=h["jac_j"], linsolve="lu", **kw)


# ------------------------------------------------------------- chunk files
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunk_file_reads_back_in_the_other_package(tmp_path, writer):
    y0, cfg = _decay(4)
    res = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                str(tmp_path / "src"), chunk_size=4,
                                linsolve="lu", quarantine=True)
    res = ck.host_result(res)
    obs = {"tau": torch.linspace(0.1, 0.4, 4, dtype=torch.float64)}
    res = type(res)(**{**vars(res), "observed": obs})
    path = str(tmp_path / "chunk_00000.npz")
    if writer == "port":
        ck.save_result(path, res, cfg)
        got, cfgs = ck_j.load_result(path)
        conv = np.asarray
    else:
        import jax
        from batchreactor_tpu.solver.sdirk import SolveResult as SR_j

        res_j = SR_j(**{f: jnp.asarray(getattr(res, f).numpy())
                        for f in ck._FIELDS},
                     observed={k: jnp.asarray(v.numpy())
                               for k, v in obs.items()},
                     provenance=jnp.asarray(res.provenance.numpy()))
        jax.block_until_ready(res_j.y)
        ck_j.save_result(path, res_j, {"k": jnp.asarray(cfg["k"].numpy())})
        got, cfgs = ck.load_result(path)
        conv = np.asarray
    for f in ck._FIELDS:
        np.testing.assert_array_equal(conv(getattr(got, f)),
                                      getattr(res, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(conv(got.observed["tau"]),
                                  obs["tau"].numpy())
    np.testing.assert_array_equal(conv(got.provenance),
                                  res.provenance.numpy())
    np.testing.assert_array_equal(conv(cfgs["k"]), cfg["k"].numpy())


# ------------------------------------------- the h2o2 sweep against JAX
@pytest.fixture(scope="module")
def port_clean(h2o2, tmp_path_factory):
    d = tmp_path_factory.mktemp("port_clean")
    return d, _h2o2_port(h2o2, d)


def test_checkpointed_sweep_matches_jax_and_resumes(tmp_path, h2o2,
                                                    port_clean):
    d, got = port_clean
    ref = _h2o2_jax(h2o2, tmp_path / "j")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert bool((got.status == SUCCESS).all())
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y),
                               rtol=10 * RTOL, atol=1e-12)
    # the JAX package reads the port's chunks and concatenates the same
    for i in range(2):
        part, _ = ck_j.load_result(str(d / f"chunk_{i:05d}.npz"))
        np.testing.assert_array_equal(np.asarray(part.y),
                                      got.y[4 * i:4 * i + 4].numpy())
    # resume: every chunk loads, none is solved
    ck.reset_counts()
    again = _h2o2_port(h2o2, d)
    assert ck.COUNTS["chunks_solved"] == 0
    _equal(got, again)
    # another sweep in the same directory raises
    with pytest.raises(ValueError, match="different sweep"):
        ck.checkpointed_sweep(
            h2o2["rhs_t"], h2o2["y0_t"], 0.0, T1,
            {"T": torch.tensor(h2o2["T"]) + 1.0}, str(d),
            chunk_size=4, jac=h2o2["jac_t"], linsolve="lu")


def test_nan_lane_quarantine_provenance_matches_jax(tmp_path, h2o2,
                                                    port_clean):
    inject.arm("nan_lane:lane=5")
    inject_j.arm("nan_lane:lane=5")
    got = _h2o2_port(h2o2, tmp_path / "p", quarantine=True)
    ref = _h2o2_jax(h2o2, tmp_path / "j", quarantine=True)
    assert quarantine.provenance_counts(got.provenance.numpy()) == \
        quarantine_j.provenance_counts(np.asarray(ref.provenance)) == \
        {"retry": 1}
    np.testing.assert_array_equal(got.provenance.numpy(),
                                  np.asarray(ref.provenance))
    assert bool((got.status == SUCCESS).all())
    _equal(port_clean[1], got)   # the retry pass re-solves unchanged


# ----------------------------------------------------- the oracle rung
BAD_LANES = (5, 6)   # both in chunk 1: its fallback pass runs 2 lanes


def _bad_rhs(h):
    """The h2o2 RHS, NaN for the lanes marked ``cfg["bad"]`` whenever it
    is called on more than one lane: those lanes fail every device pass
    (the full-chunk retry, and the two-lane fallback), and the oracle,
    which calls it one lane at a time, solves them."""
    rhs = h["rhs_t"]

    def bad_rhs(t, y, cfg):
        dy = rhs(t, y, cfg)
        if y.shape[0] > 1:
            dy = torch.where(cfg["bad"][:, None] > 0, float("nan"), dy)
        return dy

    return bad_rhs


def _oracle_cfg(h):
    bad = torch.zeros(B, dtype=torch.float64)
    bad[list(BAD_LANES)] = 1.0
    return {"T": torch.tensor(h["T"]), "bad": bad}


@pytest.mark.parametrize("tier", ["checkpointed", "elastic"])
def test_oracle_rung_answers_lanes_every_pass_fails(tmp_path, h2o2,
                                                    port_clean, tier):
    """``quarantine={"oracle": True}`` on h2o2 in chunks of 4: the two
    lanes that fail every device pass come back from the native oracle
    with provenance ``oracle``, their state within 10 rtol of the clean
    sweep's; every other lane equals the clean sweep to the bit."""
    from batchreactor_tpu_torch.parallel import multihost as mh

    kw = dict(chunk_size=4, jac=h2o2["jac_t"], linsolve="lu",
              quarantine={"oracle": True})
    rec_args = (_bad_rhs(h2o2), h2o2["y0_t"], 0.0, T1, _oracle_cfg(h2o2),
                str(tmp_path / "o"))
    if tier == "checkpointed":
        got = ck.checkpointed_sweep(*rec_args, **kw)
    else:
        got = mh.elastic_checkpointed_sweep(*rec_args, process_id=0,
                                            num_processes=1,
                                            heartbeat_s=0.2, **kw)
    clean = port_clean[1]
    prov = got.provenance.numpy()
    assert [quarantine.PROVENANCE_NAMES[c] for c in prov[list(BAD_LANES)]
            ] == ["oracle", "oracle"]
    assert int((prov != 0).sum()) == 2
    assert bool((got.status == SUCCESS).all())
    live = np.setdiff1d(np.arange(B), BAD_LANES)
    np.testing.assert_array_equal(got.y.numpy()[live],
                                  clean.y.numpy()[live])
    np.testing.assert_allclose(got.y.numpy()[list(BAD_LANES)],
                               clean.y.numpy()[list(BAD_LANES)],
                               rtol=10 * RTOL, atol=1e-12)


# ----------------------------------------------------- recovery paths
def test_resume_survives_a_corrupt_chunk(tmp_path):
    clean = _decay_sweep(tmp_path / "clean")
    inject.arm("corrupt_chunk:chunk=1")
    _decay_sweep(tmp_path / "f")            # tears chunk 1 after its save
    ck.reset_counts()
    resumed = _decay_sweep(tmp_path / "f")  # re-solves it
    assert ck.COUNTS == {"chunks_solved": 1, "chunks_corrupt": 1}
    assert (tmp_path / "f" / "chunk_00001.npz.corrupt").exists()
    _equal(clean, resumed)


def test_hung_wait_retries_with_a_two_attempt_ledger(tmp_path):
    clean = _decay_sweep(tmp_path / "clean", segment_steps=64)
    inject.arm("hang_fetch:delay=10")
    res = _decay_sweep(tmp_path / "f", segment_steps=64, fetch_deadline=0.3,
                       retry={"max_retries": 1, "backoff_s": 0.0})
    _equal(clean, res)
    rows = json.load(open(tmp_path / "f" / "manifest.json"))["attempts"]
    assert [r["outcome"] for r in rows["0"]] == ["error", "ok"]
    assert rows["0"][0]["kind"] == "WedgeError"
    # the per-chunk budget is the other watchdog surface; without a retry
    # its breach propagates
    inject.arm("hang_fetch:delay=10")
    with pytest.raises(Exception, match="deadline"):
        _decay_sweep(tmp_path / "g", chunk_budget_s=0.3)


KILL_CHILD = r"""
import sys
import torch
from batchreactor_tpu_torch.parallel import checkpoint as ck
from batchreactor_tpu_torch.resilience import inject
inject.arm("kill:chunk=" + sys.argv[2])
def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y
y0 = torch.tensor([1.0, 0.5], dtype=torch.float64).expand(8, 2).clone()
cfg = {"k": torch.logspace(1.0, 2.0, 8, dtype=torch.float64)}
ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg, sys.argv[1],
                      chunk_size=2, linsolve="lu")
"""


def test_killed_process_resumes_bit_exact(tmp_path):
    """A child killed (``os._exit(137)``) before saving chunk 2 leaves
    chunks 0-1 on disk; the resume here loads them and solves the rest."""
    script = tmp_path / "child.py"
    script.write_text(KILL_CHILD)
    d = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, str(script), str(d), "2"],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert sorted(p.name for p in d.glob("chunk_*.npz")) == [
        "chunk_00000.npz", "chunk_00001.npz"]
    rhs = _decay_rhs
    y0, cfg = _decay()
    ck.reset_counts()
    resumed = ck.checkpointed_sweep(rhs, y0, 0.0, 0.1, cfg, str(d),
                                    chunk_size=2, linsolve="lu")
    assert ck.COUNTS["chunks_solved"] == 2
    clean = ck.checkpointed_sweep(rhs, y0, 0.0, 0.1, cfg,
                                  str(tmp_path / "clean"), chunk_size=2,
                                  linsolve="lu")
    _equal(clean, resumed)


def test_admission_backlog_matches_the_chunked_sweep(tmp_path):
    chunked = _decay_sweep(tmp_path / "a", segment_steps=64)
    streamed = _decay_sweep(tmp_path / "b", segment_steps=64, admission=2)
    _equal(chunked, streamed)
    manifest = json.load(open(tmp_path / "b" / "manifest.json"))
    assert manifest["admission"]["resident"] == 2
    # the chunk files of the stream are the chunked sweep's
    for i in range(2):
        a, _ = ck.load_result(str(tmp_path / "a" / f"chunk_{i:05d}.npz"))
        b, _ = ck.load_result(str(tmp_path / "b" / f"chunk_{i:05d}.npz"))
        _equal(a, b)


def test_lane_cost_orders_chunks_and_returns_caller_order(tmp_path):
    y0, cfg = _decay()
    plain = _decay_sweep(tmp_path / "a")
    cost = np.arange(B)[::-1].copy()
    res = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                str(tmp_path / "b"), chunk_size=4,
                                lane_cost=cost, linsolve="lu")
    np.testing.assert_allclose(res.y.numpy(), plain.y.numpy(), rtol=1e-9)
    first, _ = ck.load_result(str(tmp_path / "b" / "chunk_00000.npz"))
    np.testing.assert_array_equal(first.y.numpy(), res.y[4:].numpy()[::-1])


def test_deferred_options_name_their_items(tmp_path):
    y0, cfg = _decay(4)
    # recorder= landed (ROADMAP A14): one chunk_solve span per chunk
    from batchreactor_tpu_torch.obs import Recorder

    rec = Recorder()
    ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                          str(tmp_path / "r"), chunk_size=2, linsolve="lu",
                          recorder=rec)
    assert rec.by_name()["chunk_solve"]["count"] == 2
    # oracle= and the policy's oracle rung landed (ROADMAP A16): armed,
    # with no failed lane, the sweep equals the quarantine-off sweep
    plain = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                  str(tmp_path / "p"), chunk_size=4)
    for i, kw in enumerate(({"oracle": object(), "quarantine": True},
                            {"quarantine": {"oracle": True}})):
        res = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                    str(tmp_path / f"d{i}"), chunk_size=4,
                                    **kw)
        _equal(plain, res)
        assert not res.provenance.any()
    with pytest.raises(ValueError, match="segmented-path knobs"):
        ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                              str(tmp_path / "e"), chunk_size=4,
                              fetch_deadline=5.0)


FP_CHILD = r"""
import sys
import numpy as np
import torch
import batchreactor_tpu_torch as bt
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import ignition_observer
from batchreactor_tpu_torch.parallel.checkpoint import _sweep_fingerprint
lib = sys.argv[1]
gm = bt.compile_gaschemistry(lib + "/h2o2.dat", device="cpu")
th = bt.create_thermo(list(gm.species), lib + "/therm.dat", device="cpu")
obs, obs0 = ignition_observer(list(gm.species).index("H2"))
if sys.argv[2] == "warm":
    # a process that has run the callables first (lazy caches filled)
    make_gas_jac(gm, th)(0.0, torch.ones((2, 9), dtype=torch.float64),
                         {"T": torch.full((2,), 1200.0,
                                          dtype=torch.float64)})
y0 = torch.ones((4, 9), dtype=torch.float64)
cfg = {"T": torch.linspace(1000.0, 1300.0, 4, dtype=torch.float64)}
print(_sweep_fingerprint(make_gas_rhs(gm, th), y0, cfg, dict(
    jac=make_gas_jac(gm, th), observer=obs, observer_init=obs0,
    segment_steps=64, rtol=1e-6, linsolve="auto")))
"""


def test_fingerprint_is_equal_in_two_fresh_processes(tmp_path, fixtures_dir):
    script = tmp_path / "fp.py"
    script.write_text(FP_CHILD)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    outs = []
    for mode, seed in (("cold", "1"), ("warm", "2")):
        # another string-hash seed too: nothing may hash a set's order
        proc = subprocess.run(
            [sys.executable, str(script), fixtures_dir, mode],
            env={**env, "PYTHONHASHSEED": seed}, capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1] and len(outs[0]) == 64
