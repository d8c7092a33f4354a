"""Port parity: the north-star map and its single-core baseline
(``batchreactor_tpu_torch/tools/northstar_sweep.py`` and
``northstar_baseline.py``) against the JAX package's
``scripts/northstar_sweep.py`` and ``scripts/northstar_baseline.py``, on
the CPU.

The map runs at the JAX test's grid (``tests/test_workloads.py``:
3 T x 2 phi, 1700-2000 K, t1 = 4e-4 s, chunks of 4, segments of 512)
with float32 rate exponentials on both sides, both cost-sorted by the
committed ``NORTHSTAR_BASELINE.json`` (read only).  Statuses are equal,
tau agrees per lane within 1e-3 (the solve-observable tier), and the
resume loads every chunk and reproduces the record.  The lane-cost model
equals the JAX one to 1e-12 on the full 64 x 64 grid, the baseline picks
the JAX sub-lattice, and the CLIs run on the CPU only when asked.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import batchreactor_tpu.native as native_j
from batchreactor_tpu.energy import extract_delay as extract_delay_j
from batchreactor_tpu.obs import live as live_j
from batchreactor_tpu.ops import gas_kinetics as gas_kinetics_j
from batchreactor_tpu.parallel import checkpoint as checkpoint_j
from batchreactor_tpu_torch import energy as energy_t
from batchreactor_tpu_torch.obs import live
from batchreactor_tpu_torch.parallel import checkpoint as ck
from batchreactor_tpu_torch.solver.common import SUCCESS
from batchreactor_tpu_torch.tools import northstar_baseline as nb
from batchreactor_tpu_torch.tools import northstar_sweep as ns

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = ROOT / "NORTHSTAR_BASELINE.json"
GRID = dict(n_T=3, n_phi=2, T_lo=1700.0, T_hi=2000.0, t1=4e-4,
            chunk_size=4, segment_steps=512)
TAU_RTOL = 1e-3


def _quiet(_msg):
    pass


def _load_script(name):
    """Import ``scripts/<name>.py`` under a private module name, with the
    process environment restored afterwards (the sweep script sets
    ``BR_EXP32`` and the compilation cache variables at import)."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


@pytest.fixture(scope="module")
def jax_sweep():
    return _load_script("northstar_sweep")


@pytest.fixture(scope="module")
def jax_baseline():
    return _load_script("northstar_baseline")


def _run_jax(jax_sweep, **kw):
    """The JAX ``run_sweep`` with f32 rate exponentials (its script's
    default): the JAX kinetics freeze the choice once per process, so it
    is pinned on the module for the call and restored after.  Returns the
    record and the per-lane result its checkpointed sweep returned."""
    seen = []
    solve = checkpoint_j.checkpointed_sweep

    def spy(*a, **k):
        seen.append(solve(*a, **k))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BR_EXP32", "1")
        mp.setattr(gas_kinetics_j, "_EXP32", True)
        mp.setattr(checkpoint_j, "checkpointed_sweep", spy)
        try:
            rec = jax_sweep.run_sweep(log=_quiet, **kw)
        finally:
            live_j.disarm_flight()
    return rec, seen[-1]


def _run_port(tmp, **kw):
    try:
        return ns.run_sweep(device="cpu", flight_dir=str(tmp), log=_quiet,
                            **kw)
    finally:
        live.disarm_flight()


@pytest.fixture(scope="module")
def maps(jax_sweep, tmp_path_factory):
    """The small map through both packages, then the port's resume on the
    same checkpoint directory."""
    tmp = tmp_path_factory.mktemp("northstar")
    rec_j, res_j = _run_jax(jax_sweep, ckpt_dir=str(tmp / "jax"),
                            n_spot=3, **GRID)
    ck.reset_counts()
    rec_t, res_t = _run_port(tmp, ckpt_dir=str(tmp / "port"), n_spot=3,
                             return_result=True, **GRID)
    solved = ck.COUNTS["chunks_solved"]
    ck.reset_counts()
    rec_r, res_r = _run_port(tmp, ckpt_dir=str(tmp / "port"), n_spot=3,
                             return_result=True, **GRID)
    return {"jax": rec_j, "res_jax": res_j, "port": rec_t, "res": res_t,
            "solved": solved,
            "resume": rec_r, "res_resume": res_r,
            "resume_solved": ck.COUNTS["chunks_solved"]}


def _spots_by_lane(rec):
    """A record's spot checks, keyed by lane."""
    return {s["lane"]: s for s in rec["spot_checks"]}


def test_map_matches_jax(maps):
    rec_j, rec_t, res = maps["jax"], maps["port"], maps["res"]
    assert rec_t["B"] == rec_j["B"] == 6
    assert rec_t["counts"] == rec_j["counts"] == {"success": 6}
    assert rec_t["n_no_ignition"] == rec_j["n_no_ignition"]
    assert rec_t["lane_cost_sorted"] is rec_j["lane_cost_sorted"] is True
    assert rec_t["exp32"] is rec_j["exp32"] is True
    assert (rec_t["pipeline"], rec_t["poll_every"]) == (
        rec_j["pipeline"], rec_j["poll_every"])
    # per lane, in the caller's order (both sweeps ran cost-sorted)
    res_j = maps["res_jax"]
    assert np.array_equal(res.status.numpy(), np.asarray(res_j.status))
    assert np.all(res.status.numpy() == SUCCESS)
    np.testing.assert_allclose(res.observed["tau"].numpy(),
                               np.asarray(res_j.observed["tau"]),
                               rtol=TAU_RTOL, atol=0)
    # the same spot lanes (chosen from the ignited lanes), each lane's
    # tau within 1e-3 of the JAX package's and of the native BDF's
    spots_j, spots_t = _spots_by_lane(rec_j), _spots_by_lane(rec_t)
    assert sorted(spots_t) == sorted(spots_j) and len(spots_t) == 3
    for lane, s in spots_t.items():
        assert abs(s["tau_device"] / spots_j[lane]["tau_tpu"] - 1) \
            <= TAU_RTOL, lane
        assert s["tau_native"] == pytest.approx(
            spots_j[lane]["tau_native"], rel=1e-9)
    tau_t = res.observed["tau"].numpy()
    assert np.allclose(rec_t["tau_range_s"], rec_j["tau_range_s"],
                       rtol=TAU_RTOL, atol=0)
    assert [tau_t.min(), tau_t.max()] == rec_t["tau_range_s"]
    for rec in (rec_j, rec_t):
        assert rec["tau_parity_failed_spots"] == 0
        assert rec["tau_parity_max_rel_err"] < 1e-3
    # the record carries the JAX script's keys, plus the launches and
    # the chunk counts
    assert set(rec_t) == set(rec_j) | {"lu32p_launches", "chunks"}
    assert rec_t["device"] == "cpu"
    assert rec_t["lu32p_launches"] == {"warp": 0, "cta": 0}
    assert rec_t["chunks"] == {"n": 2, "solved": 2, "loaded": 0}
    assert maps["solved"] == 2


def test_resume_loads_every_chunk_and_equals(maps):
    rec_t, rec_r = maps["port"], maps["resume"]
    assert maps["resume_solved"] == 0
    assert rec_r["chunks"] == {"n": 2, "solved": 0, "loaded": 2}
    timing = {"wall_s", "cond_per_s", "phases_s", "chunks"}
    assert ({k: v for k, v in rec_r.items() if k not in timing}
            == {k: v for k, v in rec_t.items() if k not in timing})
    a, b = maps["res"], maps["res_resume"]
    for f in ("status", "t", "y", "n_accepted", "n_rejected"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.observed["tau"], b.observed["tau"])


def _full_grid():
    T = np.linspace(1500.0, 2000.0, 64)
    phi = np.linspace(0.6, 1.6, 64)
    TT, PP = np.meshgrid(T, phi, indexing="ij")
    return TT.reshape(-1), PP.reshape(-1)


def test_lane_cost_model_matches_jax_on_the_full_grid(jax_sweep):
    T, phi = _full_grid()
    want = jax_sweep._lane_cost_model(T, phi, log=_quiet)
    got = ns.lane_cost_model(torch.from_numpy(T), torch.from_numpy(phi),
                             str(BASELINE), log=_quiet)
    assert want is not None and got.shape == (4096,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the sorted order the chunks are cut from is the same
    assert np.array_equal(np.argsort(got, kind="stable"),
                          np.argsort(want, kind="stable"))


def _baseline_rows(kind):
    rows = json.loads(BASELINE.read_text())["per_lane"]
    rows = [dict(r) for r in rows]
    if kind == "nan_row":
        rows[5]["native_s"] = float("nan")
        for r in rows:
            r.pop("scipy_s", None)
    elif kind == "mixed_keys":
        for i, r in enumerate(rows):
            r.pop("native_s" if i % 2 else "scipy_s")
    elif kind == "ragged":
        rows = rows[:-1]
    return rows


@pytest.mark.parametrize("kind", ["missing", "nan_row", "mixed_keys",
                                  "ragged"])
def test_lane_cost_model_declines_like_jax(kind, jax_sweep, tmp_path,
                                           monkeypatch):
    path = tmp_path / "NORTHSTAR_BASELINE.json"
    if kind != "missing":
        path.write_text(json.dumps({"per_lane": _baseline_rows(kind)}))
    # the JAX model reads the file at its repository root
    monkeypatch.setattr(jax_sweep, "REPO", str(tmp_path))
    T, phi = _full_grid()
    assert jax_sweep._lane_cost_model(T, phi, log=_quiet) is None
    assert ns.lane_cost_model(T, phi, str(path), log=_quiet) is None
    assert ns.lane_cost_model(T, phi, None, log=_quiet) is None


def _jax_baseline(jax_baseline, monkeypatch, capsys, tmp_path, n):
    monkeypatch.setenv("NB_N", str(n))
    monkeypatch.setenv("NB_SOLVERS", "native")
    monkeypatch.setenv("NB_OUT", str(tmp_path / f"jax_baseline_{n}.json"))
    capsys.readouterr()
    jax_baseline.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_baseline_sub_lattice_matches_jax(n, jax_baseline, monkeypatch,
                                          capsys, tmp_path):
    # the lanes only: the JAX solve is stubbed out
    monkeypatch.setattr(native_j, "solve_gas_bdf",
                        lambda *a, **k: types.SimpleNamespace(
                            status="Success"))
    rec_j = _jax_baseline(jax_baseline, monkeypatch, capsys, tmp_path, n)
    Ts, phis = nb.sub_lattice(n)
    assert [(r["T"], r["phi"]) for r in rec_j["per_lane"]] == [
        (float(T), float(phi)) for T in Ts for phi in phis]


def test_baseline_native_2x2_against_jax(jax_baseline, monkeypatch, capsys,
                                         tmp_path):
    rec_j = _jax_baseline(jax_baseline, monkeypatch, capsys, tmp_path, 2)
    map_rec = tmp_path / "map.json"
    map_rec.write_text(json.dumps({"wall_s": 12.5, "device": "test"}))
    rec = nb.run_baseline(n=2, solvers=("native",), map_record=str(map_rec),
                          log=_quiet)
    assert rec["solvers"]["native"]["n_failed"] == 0
    assert rec_j["solvers"]["native"]["n_failed"] == 0
    assert [(r["T"], r["phi"]) for r in rec["per_lane"]] == [
        (r["T"], r["phi"]) for r in rec_j["per_lane"]]
    assert all(r["native_s"] > 0 for r in rec["per_lane"])
    # the JAX script divides by its TPU record's wall (tpu_wall_s); the
    # port by the map record it is given (map_wall_s, map_device)
    assert (set(rec) - {"map_wall_s", "map_device"}
            == set(rec_j) - {"tpu_wall_s"})
    assert set(rec["solvers"]["native"]) == set(rec_j["solvers"]["native"])
    mean = rec["solvers"]["native"]["s_per_lane_mean"]
    assert rec["map_wall_s"] == 12.5 and rec["map_device"] == "test"
    assert rec["map_speedup_vs_native"] == round(mean * 4096 / 12.5, 1)
    assert rec["extrapolated_full_map_wall_s_native"] == round(
        mean * 4096, 1)


def test_adiabatic_map_matches_jax(jax_sweep, tmp_path):
    kw = dict(n_T=2, n_phi=1, T_lo=1700.0, T_hi=2000.0, t1=2e-4,
              chunk_size=2, segment_steps=512, n_spot=3,
              energy="adiabatic_v")
    rec_j, res_j = _run_jax(jax_sweep, ckpt_dir=str(tmp_path / "jax"),
                            **kw)
    rec_t, res_t = _run_port(tmp_path, ckpt_dir=str(tmp_path / "port"),
                             return_result=True, **kw)
    assert rec_t["counts"] == rec_j["counts"] == {"success": 2}
    assert np.array_equal(res_t.status.numpy(), np.asarray(res_j.status))
    np.testing.assert_allclose(
        energy_t.extract_delay(res_t.observed),
        np.asarray(extract_delay_j(res_j.observed)), rtol=TAU_RTOL, atol=0)
    assert rec_t["n_no_ignition"] == rec_j["n_no_ignition"] == 0
    np.testing.assert_allclose(rec_t["tau_range_s"], rec_j["tau_range_s"],
                               rtol=TAU_RTOL, atol=0)
    # no native spot check for the adiabatic family (n_spot forced to 0)
    for rec in (rec_j, rec_t):
        assert rec["spot_checks"] == []
        assert rec["tau_parity_max_rel_err"] is None
        assert rec["energy"] == "adiabatic_v"
    assert rec_t["workload"] == rec_j["workload"]


def test_admission_matches_admission_off(maps, tmp_path):
    rec_a, res_a = _run_port(tmp_path, ckpt_dir=str(tmp_path / "adm"),
                             n_spot=0, admission=True, return_result=True,
                             **GRID)
    res = maps["res"]
    assert torch.equal(res_a.status, res.status)
    tau, tau_a = res.observed["tau"].numpy(), res_a.observed["tau"].numpy()
    np.testing.assert_allclose(tau_a, tau, rtol=TAU_RTOL, atol=0)
    assert rec_a["admission"] == "chunk"
    assert rec_a["occupancy"] is not None and 0 < rec_a["occupancy"] <= 1
    assert rec_a["counts"] == {"success": 6}


def _cli(module, *args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run(
        [sys.executable, "-m", f"batchreactor_tpu_torch.tools.{module}",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    out = tmp_path / "rec.json"
    r = _cli("northstar_sweep", "--device", "cpu", "--nt", "2", "--nphi",
             "1", "--chunk", "2", "--ckpt", str(tmp_path / "ck"), "--out",
             str(out), cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec == json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["B"] == 2 and rec["counts"] == {"success": 2}
    assert rec["device"] == "cpu" and rec["exp32"] is True
    assert rec["lane_cost_sorted"] is True
    assert rec["tau_parity_failed_spots"] == 0
    assert rec["tau_parity_max_rel_err"] < 1e-3


def test_clis_refuse_without_a_gpu_unless_cpu_is_asked(tmp_path):
    out = tmp_path / "rec.json"
    r = _cli("northstar_sweep", "--nt", "2", "--nphi", "1", "--out",
             str(out), cwd=tmp_path)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not out.exists()
    r = _cli("northstar_baseline", "--n", "1", "--device", "cuda",
             "--out", str(out), cwd=tmp_path)
    assert r.returncode != 0 and "CPU" in r.stderr
    assert not out.exists()
