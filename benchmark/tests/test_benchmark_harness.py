"""The harness end to end on the CPU at a tiny size (the h2o2 fixture, four
lanes), through the same code as on the card: the sweep driver, the
comparison against the plain reference, the control, and the faults a run
must see as not correct.

    python -m pytest benchmark/tests -q
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import control as control_mod  # noqa: E402
from benchmark.core import judge, runner, spec  # noqa: E402
from benchmark.core.traffic import draw  # noqa: E402
from benchmark.reference import chem, solve  # noqa: E402

FIXTURES = os.path.join(spec.ROOT, "tests", "fixtures")

H2O2 = {
    "name": "h2o2",
    "files": {
        "mech": {"path": "tests/fixtures/h2o2.dat",
                 "sha256": "7036e1d54eb01b5c804ebcedce28e791f80c59fde3e89"
                           "71fd2aa3c11aa2868ab"},
        "therm": {"path": "tests/fixtures/therm.dat",
                  "sha256": "8d918b771aa965fe05e8c8f1f7e926a5326ebc90e7fc"
                            "923ce129dc118b634dcc"}},
    "solver": {"method": "bdf", "rtol": 1e-6, "atol": 1e-10,
               "jac_window": 8, "setup_economy": True, "segment_steps": 64,
               "linsolve": "auto", "exp32": False},
    "observe": {"ignition_marker": "H2"},
    # limits of this tiny configuration: h2o2's steep H2 consumption moves
    # its delay more than GRI-3.0's CH4 does at the same tolerances
    "correct": {"reference_tolerances": {"rtol": 1e-10, "atol": 1e-16},
                "lanes": 4,
                "limits": {"status": 0.0, "elem_gap": 1e-10,
                           "tau_gap": 2e-2, "x_gap": 1e-4}},
}

TINY = {"kind": "sweep", "p": 1e5, "t1": 2e-4, "warmup_t1": 1e-6,
        "conditions": {
            "axes": [{"name": "T", "lo": 1100.0, "hi": 1400.0, "bins": 2},
                     {"name": "phi", "lo": 0.5, "hi": 2.0, "bins": 2}],
            "composition": {"premixed": {
                "fuel": "H2", "oxidizer": "O2", "stoich_o2": 0.5,
                "diluent": "N2", "diluent_per_o2": 3.76}}}}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout-like root holding the tiny cell's files, and its
    manifest (the real end-to-end and per-layer metrics, for this cell)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("root")
    (root / "tests").mkdir()
    os.symlink(FIXTURES, root / "tests" / "fixtures")
    for sub, name, obj in (("configs", "h2o2", H2O2),
                           ("traffic", "tiny", TINY)):
        d = root / "benchmark" / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.json").write_text(json.dumps(obj))
    real = spec.load_manifest()
    manifest = {
        "run_seconds": 1,
        "configs": [{"name": "h2o2", "file": "benchmark/configs/h2o2.json"}],
        "workloads": [{"name": "tiny", "config": "h2o2", "traffic": "tiny",
                       "chips": 1}],
        "end_to_end": [dict(e, workloads=["tiny"])
                       for e in real["end_to_end"]],
        # the metrics a CPU run can read: the program's counters
        "per_layer": [dict(p, workloads=["tiny"]) for p in real["per_layer"]
                      if p["source"] != "device_trace"]}
    return str(root), manifest


def run_cell(tiny, seed, trace=0, cell="tiny", seconds=0.5):
    root, manifest = tiny
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runner.main(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         manifest=manifest, root=root, device="cpu")
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_sweep_run_is_correct_and_reports_end_to_end(tiny):
    res, err = run_cell(tiny, 2 ** 31 + 11)
    assert res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"cond_per_s", "setup_s"}
    assert res["attempted"] == 4 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    # the compared numbers are the last lines on standard error
    tail = err.strip().splitlines()[-len(res["compared"]):]
    assert all(line.startswith("compared ") for line in tail)


def test_traced_run_reports_per_layer_metrics(tiny):
    res, err = run_cell(tiny, 5, trace=1)
    assert res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"host_syncs_per_sweep",
                                   "newton_iters_per_sweep"}
    assert "breakdown" in res and "window_s" in res["device"]


@contextlib.contextmanager
def broken(transform):
    """The program's sweep entry with ``transform(out, inlet, T)`` applied to
    its answers, for the block."""
    import batchreactor_tpu_torch as bt

    real = bt.batch_reactor_sweep

    def fake(inlet, T, *a, **kw):
        return transform(real(inlet, T, *a, **kw), inlet, T)

    bt.batch_reactor_sweep = fake
    try:
        yield
    finally:
        bt.batch_reactor_sweep = real


def state_unchanged(out, inlet, T):
    """A step that returns its state unchanged: every lane answers its
    initial composition."""
    B = len(out["status"])
    x0 = {s: np.zeros(B) for s in out["x"]}
    for s, v in inlet.items():
        x0[s.upper()] = np.broadcast_to(np.asarray(v, dtype=float), (B,))
    tot = sum(x0.values())
    return dict(out, x={s: v / tot for s, v in x0.items()})


def half_batch(out, inlet, T):
    """Half of the batch left out, the other half given their mean."""
    B = len(out["status"])
    h = B // 2
    x = {s: np.concatenate([v[:h], np.full(B - h, v[:h].mean())])
         for s, v in out["x"].items()}
    tau = np.concatenate([out["tau"][:h],
                          np.full(B - h, np.nanmean(out["tau"][:h]))])
    return dict(out, x=x, tau=tau)


def answer_altered(out, inlet, T):
    """One lane's answer altered where it is produced."""
    tau = np.array(out["tau"], dtype=float)
    tau[1] *= 1.05
    return dict(out, tau=tau)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
def test_fault_is_not_correct(tiny, fault):
    with broken(fault):
        res, err = run_cell(tiny, 3)
    assert res["correct"] is False, err[-2000:]


def test_control_fails_the_comparison(tiny):
    """The reference in float32, in the program's place at the cell's
    tolerances, judged by the run's own comparison: the element gap
    rejects it."""
    root, manifest = tiny
    out = control_mod.control("tiny", [1], manifest=manifest, root=root)
    passed, nums = out[1]
    assert not passed
    assert nums["elem_gap"]["value"] > nums["elem_gap"]["limit"]


def test_program_control_runs_through_the_comparison(tiny):
    """The program with its own float32 rate exponentials, and as
    configured, one sweep each, judged by the run's comparison: every
    compared number is read for both (at rtol 1e-6 the float32
    exponentials stay inside the limits, PERF.md section 2)."""
    root, manifest = tiny
    got = control_mod.program_runs("tiny", [(3, {"exp32": True}), (3, {})],
                                   manifest=manifest, root=root,
                                   device="cpu", log=lambda m: None)
    (_, low), (ok, sound) = got
    assert ok and set(low) == set(sound) == set(H2O2["correct"]["limits"])
    assert all(np.isfinite(v["value"]) for v in low.values())


def cell_shapes():
    """(cell, its traffic's bins, the lanes its runs compare) of every
    cell of ``BENCHMARK.json``."""
    for w in spec.load_manifest()["workloads"]:
        run = spec.resolve(w["name"])
        yield (w["name"], [int(a["bins"]) for a in
                           run["traffic"]["conditions"]["axes"]],
               int(run["config"]["correct"]["lanes"]))


CELLS = list(cell_shapes())


@pytest.mark.parametrize("name,bins,k", CELLS, ids=[c[0] for c in CELLS])
def test_lane_draw_meets_every_half_of_a_cell_batch(name, bins, k):
    """At a cell's own batch and lane count, every draw compares a lane of
    each half of a batch, of its even and its odd lanes, and (k >= 4) of
    each quarter: a fault there is never missed."""
    B = int(np.prod(bins))
    for seed in range(500):
        picks = judge.draw_lanes([B] * 6, k, runner.rng(seed, 7))
        assert len(set(picks)) == k
        lanes = np.array([i for _, i in picks])
        assert (lanes < B // 2).any() and (lanes >= B // 2).any()
        assert (lanes % 2 == 0).any() and (lanes % 2 == 1).any()
        for q in range(4 if k >= 4 else 0):
            assert ((lanes >= q * B // 4) & (lanes < (q + 1) * B // 4)).any()


@pytest.mark.parametrize("name,bins,k", CELLS, ids=[c[0] for c in CELLS])
def test_half_batch_fault_at_a_cell_size_is_not_correct(tiny, name, bins,
                                                        k):
    """``half_batch`` planted in a run of h2o2 at a cell's own batch (its
    traffic's bins) and lane count: the run is not correct."""
    root, manifest = tiny
    conf = dict(H2O2, correct=dict(H2O2["correct"], lanes=k))
    traffic = copy.deepcopy(TINY)
    for axis, n in zip(traffic["conditions"]["axes"], bins):
        axis["bins"] = n
    for sub, obj in (("configs", conf), ("traffic", traffic)):
        with open(os.path.join(root, "benchmark", sub, f"at-{name}.json"),
                  "w") as fh:
            json.dump(obj, fh)
    cell = {"name": f"at-{name}", "config": f"at-{name}",
            "traffic": f"at-{name}", "chips": 1}
    at = dict(manifest, workloads=[cell],
              configs=[{"name": f"at-{name}",
                        "file": f"benchmark/configs/at-{name}.json"}],
              end_to_end=[dict(e, workloads=[cell["name"]])
                          for e in manifest["end_to_end"]],
              per_layer=[])
    with broken(half_batch):
        res, err = run_cell((root, at), 2 ** 31 + 5, cell=cell["name"],
                            seconds=0.0)
    assert res["attempted"] == int(np.prod(bins))
    assert res["correct"] is False, err[-2000:]


def test_reference_agrees_with_itself_across_tolerances():
    """The reference at its tight tolerance and at the cells' agree on an
    h2o2 lane (its H2 marker falls steeply, so its delay moves more with the
    tolerance than GRI-3.0's CH4), and keeps the elements."""
    gas = chem.Gas(os.path.join(FIXTURES, "h2o2.dat"),
                   os.path.join(FIXTURES, "therm.dat"))
    rx = chem.Reactor(gas)
    x = np.zeros(len(gas.species))
    for s, v in (("H2", 0.3), ("O2", 0.15), ("N2", 0.55)):
        x[gas.species.index(s)] = v
    y0 = chem.initial_state(gas.thermo, x, 1200.0, 1e5)
    a = solve.solve_lane(rx, 1200.0, 1.0, y0, 2e-4, 1e-10, 1e-16,
                         marker=gas.species.index("H2"))
    b = solve.solve_lane(rx, 1200.0, 1.0, y0, 2e-4, 1e-6, 1e-10,
                         marker=gas.species.index("H2"))
    assert a["ok"] and b["ok"]
    assert abs(a["tau"] - b["tau"]) / a["tau"] < 1e-2
    elem = gas.thermo.element_matrix(["H", "O", "N"])
    e0 = solve.element_fractions(x, elem)
    e1 = solve.element_fractions(solve.mole_fractions(a["y"], gas.molwt),
                                 elem)
    assert np.max(np.abs(e1 - e0)) < 1e-12


def test_complex_step_jacobian_matches_differences():
    gas = chem.Gas(os.path.join(FIXTURES, "h2o2.dat"),
                   os.path.join(FIXTURES, "therm.dat"))
    rx = chem.Reactor(gas)
    x = np.full(len(gas.species), 1.0 / len(gas.species))
    y0 = chem.initial_state(gas.thermo, x, 1500.0, 1e5)
    J = rx.jac(1500.0, 1.0, y0)
    for j in range(len(y0)):
        d = 1e-6 * y0[j]
        e = np.zeros_like(y0)
        e[j] = d
        fd = (rx.rhs(1500.0, 1.0, y0 + e) - rx.rhs(1500.0, 1.0, y0 - e)) / (
            2 * d)
        assert np.allclose(J[:, j], fd, rtol=1e-5, atol=1e-6 * np.abs(
            J).max())


def test_lane_draw_is_seeded_and_stratified():
    a = judge.draw_lanes([5, 7], 4, np.random.default_rng(3))
    b = judge.draw_lanes([5, 7], 4, np.random.default_rng(3))
    assert a == b and len(set(a)) == 4
    assert all(0 <= k < (5, 7)[bt] for bt, k in a)
    # fewer lanes than picks: every lane, once
    assert judge.draw_lanes([3], 4, np.random.default_rng(1)) == [
        (0, 0), (0, 1), (0, 2)]


def test_fixed_set_traffic_orders_the_same_lanes_by_seed():
    conditions = dict(TINY["conditions"], fixed_set=1)
    species = ["H2", "O2", "N2"]
    a = draw(conditions, species, runner.rng(5, 1, 0))
    b = draw(conditions, species, runner.rng(6, 1, 3))
    assert not np.array_equal(a["T"], b["T"])
    ka, kb = np.lexsort((a["X"][:, 0], a["T"])), np.lexsort((b["X"][:, 0],
                                                            b["T"]))
    assert np.array_equal(a["T"][ka], b["T"][kb])
    assert np.array_equal(a["X"][ka], b["X"][kb])


@pytest.mark.cuda
def test_map_cell_short_run_on_the_card(cuda_device):
    """One short run of the first cell on the card: a result line, correct
    (run on the card with ``python -m pytest benchmark/tests -m cuda``)."""
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "gri30-map-b4096", "--seed", "9", "--seconds", "5",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
