"""Tier D of the port (``batchreactor_tpu_torch/analysis/costmodel.py``,
``budgets.py``, ``tools/brcost.py``) against the JAX package's
(``batchreactor_tpu/analysis/costmodel.py``), on the CPU.

* the closed-form estimator equals the JAX one in every shared key;
* the op-log walker's FLOPs per lane lie within 0.5-2x, and its
  transcendentals within 0.8-1.25x, of the jaxpr walker's for every
  program both packages record (no key is excluded);
* the factor is costed by its work, whatever implements it;
* the budgets, the gate and the ladders behave as the JAX ones do.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from batchreactor_tpu.analysis import costmodel as jcm
from batchreactor_tpu_torch.analysis import contracts as C
from batchreactor_tpu_torch.analysis import costmodel as tcm
from batchreactor_tpu_torch.analysis.budgets import Budget, check_budget
from batchreactor_tpu_torch.solver import linalg_cuda as lc
from batchreactor_tpu_torch.tools import brcost

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"

#: the contracts both packages record, as the JAX table's selection
SHARED_CONTRACTS = {"bdf-step", "bdf-step-lu32p", "sdirk-step", "rhs-modes",
                    "energy-eqns", "sweep-segment"}
#: every key the two tables share over those contracts (a new shared key
#: must be added here, and so compared)
SHARED_KEYS = (
    "bdf-step", "bdf-step/bdf-step-stats", "bdf-step-lu32p", "sdirk-step",
    "sdirk-step/sdirk-step-stats", "rhs-modes/gas-rhs", "rhs-modes/gas-jac",
    "rhs-modes/surf-rhs", "rhs-modes/surf-jac", "rhs-modes/coupled-rhs",
    "rhs-modes/coupled-jac", "rhs-modes/udf-rhs",
    "energy-eqns/energy-rhs-adiabatic_v",
    "energy-eqns/energy-jac-adiabatic_v",
    "energy-eqns/energy-rhs-adiabatic_p",
    "energy-eqns/energy-jac-adiabatic_p", "energy-eqns/energy-bdf-step",
    "sweep-segment/segment-pipelined-step",
    "sweep-segment/segment-pipelined-step-stats")
#: lanes per JAX trace: one, but the 2-lane fixture segment
JAX_LANES = {"sweep-segment/segment-pipelined-step": 2,
             "sweep-segment/segment-pipelined-step-stats": 2}


@pytest.fixture(scope="module")
def jax_table():
    """The JAX walk of the shared programs, once (~10 s)."""
    return jcm.contract_cost_table(fixtures_dir=str(FIXTURES),
                                   select=SHARED_CONTRACTS)


@pytest.fixture(scope="module")
def table():
    """The port's full table on the CPU, once (~20 s)."""
    return tcm.contract_cost_table(fixtures_dir=str(FIXTURES))


@pytest.fixture(scope="module")
def harness():
    return C.Harness(str(FIXTURES))


# --- the closed form ------------------------------------------------------

@pytest.mark.parametrize("linsolve", ["lu", "lu32p", "inv32"])
@pytest.mark.parametrize("S,R", [(9, 27), (53, 325), (96, 512)])
def test_estimate_rung_equals_the_jax_estimator(S, R, linsolve):
    for B in (1, 256, 4096):
        for method in ("bdf", "sdirk"):
            for energy in (False, True):
                for jw in (1, 8):
                    kw = dict(method=method, energy=energy,
                              linsolve=linsolve, jac_window=jw)
                    j = jcm.estimate_rung(B, S, R, **kw)
                    t = tcm.estimate_rung(B, S, R, **kw)
                    shared = set(j) - {"vmem_bytes"}
                    assert set(t) - shared == {"smem_bytes"}
                    assert {k: t[k] for k in shared} == \
                        {k: j[k] for k in shared}, (B, S, R, kw)
                    want = (tcm.lu32p_smem_bytes(t["n"])
                            if linsolve != "lu" else 0)
                    assert t["smem_bytes"] == want


def test_fits_hbm_agrees_at_equal_memory():
    for B, S, R in ((512, 53, 325), (2_000_000, 200, 1000),
                    (40_000_000, 53, 325)):
        j, t = jcm.estimate_rung(B, S, R), tcm.estimate_rung(B, S, R)
        for hbm in (jcm.V5E_HBM_BYTES, tcm.HBM_BYTES, 2 ** 30):
            for headroom in (0.8, 1.0):
                assert jcm.fits_hbm(j, hbm, headroom) == \
                    tcm.fits_hbm(t, hbm, headroom)
    assert tcm.HBM_BYTES == 80 * 2 ** 30
    edge = dict(tcm.estimate_rung(512, 53, 325),
                hbm_bytes=int(0.8 * tcm.HBM_BYTES) + 1)
    assert not tcm.fits_hbm(edge) and tcm.fits_hbm(edge, headroom=1.0)


def test_smem_fit_is_launch_configs():
    """lu32p_smem_bytes is launch_config's smem for every npad 8-240 (and
    every n that pads to it); past npad 240 no kernel takes the matrix."""
    assert tcm.SMEM_BUDGET_BYTES == lc._SMEM_LIMIT
    assert tcm.LU32P_NPAD_MAX == lc.CTA_NPAD_MAX
    for npad in range(8, 241, 8):
        want = lc.launch_config(1, npad)["smem"]
        for n in (npad - 7, npad):
            assert tcm.padded8(n) == lc.padded_n(n) == npad
            assert tcm.lu32p_smem_bytes(n) == want, n
        est = tcm.estimate_rung(64, npad, linsolve="lu32p")
        assert est["smem_bytes"] == want and tcm.fits_smem(est)
    assert tcm.lu32p_smem_bytes(241) is None
    with pytest.raises(ValueError, match="npad=248"):
        lc.launch_config(1, 248)
    est = tcm.estimate_rung(64, 248, linsolve="lu32p")
    assert est["smem_bytes"] is None and not tcm.fits_smem(est)
    assert tcm.fits_smem(tcm.estimate_rung(64, 248, linsolve="lu"))


def test_s_ladder_shows_the_cubic_wall():
    f = {S: tcm.estimate_rung(256, S)["flops_per_lane_step"]
         for S in (256, 512, 1024)}
    assert 6.0 < f[512] / f[256] < 8.5
    assert 6.5 < f[1024] / f[512] < 8.5


# --- the walker against the JAX walker ------------------------------------

def test_shared_keys_are_the_listed_ones(jax_table, table):
    shared = {k for k in jax_table if k in table
              and k.split("/")[0] in SHARED_CONTRACTS}
    assert shared == set(SHARED_KEYS)


@pytest.mark.parametrize("key", SHARED_KEYS)
def test_walk_per_lane_within_the_bands_of_the_jax_walk(jax_table, table,
                                                        key):
    """Per lane, FLOPs within 0.5-2x and transcendentals within 0.8-1.25x
    of the JAX walk (one attempt with one Newton iteration on both)."""
    lanes = JAX_LANES.get(key, 1)
    j, t = jax_table[key], table[key]
    flops = (t.flops / C.Harness.B) / (j.flops / lanes)
    assert 0.5 <= flops <= 2.0, (key, flops)
    jt, tt = j.transcendentals / lanes, t.transcendentals / C.Harness.B
    if jt == 0:
        assert tt == 0, key
    else:
        assert 0.8 <= tt / jt <= 1.25, (key, tt / jt)


def test_physics_orderings(table):
    f = {k: v.flops for k, v in table.items()}
    assert f["rhs-modes/gas-jac"] > f["rhs-modes/gas-rhs"]
    assert f["bdf-step"] > f["rhs-modes/gas-jac"]
    assert f["sdirk-step"] > f["bdf-step"]
    rhs = max(v for k, v in f.items() if k.startswith("rhs-modes/"))
    for step in ("bdf-step", "bdf-step-lu32p", "sdirk-step",
                 "sweep-segment/segment-pipelined-step",
                 "energy-eqns/energy-bdf-step"):
        assert f[step] > rhs, step
        assert table[step].n_while > 0, step      # a Newton loop folded
    assert table["rhs-modes/gas-rhs"].n_while == 0
    # SDIRK's five stages each fold a Newton loop; the economy window its
    # four attempts' and the attempt loop
    assert table["sdirk-step"].n_while == 5
    assert table["bdf-step-economy"].n_while == 5


@pytest.mark.parametrize("plain,stats", [
    ("bdf-step", "bdf-step/bdf-step-stats"),
    ("sdirk-step", "sdirk-step/sdirk-step-stats"),
    ("sweep-segment/segment-pipelined-step",
     "sweep-segment/segment-pipelined-step-stats")])
def test_stats_fork_adds_only_its_counters(table, plain, stats):
    delta = table[stats].flops - table[plain].flops
    assert 0 <= delta <= 0.02 * table[plain].flops, delta
    assert table[stats].transcendentals == table[plain].transcendentals


# --- the factor, the passes, the residency --------------------------------

def _row(op, ins, outs):
    return (op, tuple(d for d, _ in ins), tuple(s for _, s in ins),
            ("cpu",) * len(ins), tuple(d for d, _ in outs),
            tuple(s for _, s in outs), ("cpu",) * len(outs), False)


def _one_op(op, ins, outs):
    return C.Recording("factor", "cpu", ("step",), ops=[_row(op, ins, outs)])


def test_the_factor_is_costed_by_its_work():
    """brtorch::lu32p_factor and aten::linalg_lu_factor_ex cost 2/3 n^3 per
    lane at the same (B, n); M is read once and LU and the pivots written
    once, so the kernel's (1024, 53) factor moves the bytes of PERF.md's
    bound, 0.01077 ms at 3.35 TB/s."""
    B, n, npad = 1024, 53, 56
    M = [("torch.float64", (B, n, n))]
    kernel_out = [("torch.float32", (B, npad, npad)),
                  ("torch.int32", (B, npad))]
    k = tcm.cost_program(_one_op("brtorch.lu32p_factor.default", M,
                                 kernel_out))
    same = tcm.cost_program(_one_op("aten.linalg_lu_factor_ex.default", M,
                                    kernel_out))
    lib = tcm.cost_program(_one_op(
        "aten.linalg_lu_factor_ex.default", M,
        [("torch.float64", (B, n, n)), ("torch.int32", (B, n)),
         ("torch.int32", (B,))]))
    assert k.flops == same.flops == lib.flops == B * 2.0 / 3.0 * n ** 3
    assert k.bytes_moved == same.bytes_moved == 36_085_760
    assert lib.bytes_moved == B * n * n * 8 * 2 + B * n * 4 + B * 4
    assert round(k.bytes_moved / 3.35e12 * 1e3, 5) == 0.01077
    assert (k.n_pallas, same.n_pallas) == (1, 0)
    assert k.smem_bytes == lc.launch_config(B, npad)["smem"]
    assert same.smem_bytes == lib.smem_bytes == 0


def test_the_recorded_lu32p_program_charges_its_factor(table):
    c = table["bdf-step-lu32p"]
    assert c.n_pallas == 1
    assert c.smem_bytes == tcm.lu32p_smem_bytes(9)
    assert c.by_prim["lu32p_factor"] == (1, C.Harness.B * 2 / 3 * 9 ** 3)
    assert table["bdf-step"].smem_bytes == 0


def _track(rows, capturing, marks):
    return {"ins": [()] * len(rows), "outs": [()] * len(rows),
            "capturing": capturing, "scalars": [()] * len(rows),
            "marks": marks}


def test_identical_passes_fold_and_the_card_costs_one_pass():
    """A step whose fixed-trip loop ran three identical passes costs one;
    on the card only the captured pass counts (the warm-up before it is
    recorded too)."""
    pre = _row("aten.exp.default", [("torch.float64", (8, 9))],
               [("torch.float64", (8, 9))])
    body = [_row("aten.mul.Tensor", [("torch.float64", (8, 9))] * 2,
                 [("torch.float64", (8, 9))]),
            _row("aten.div.Tensor", [("torch.float64", (8, 9))] * 2,
                 [("torch.float64", (8, 9))])]
    rows = [pre] + body * 3 + [pre]
    marks = [(0, "step", "window", False, ())] + [
        (1 + 2 * k, "pass", "newton", False, ()) for k in range(3)] + [
        (len(rows), "outputs", "window", False, ())]
    rec = C.Recording("fold", "cpu", ("window",), ops=rows,
                      track=_track(rows, [False] * len(rows), marks))
    c = tcm.cost_program(rec)
    assert c.n_while == 1
    assert c.flops == 2 * 72 * 8 + 72 * (1 + 4)
    assert c.transcendentals == 2 * 72
    # on the card: the same rows twice, the warm-up then the capture
    cap = [False] * len(rows) + [True] * len(rows)
    marks2 = [(0, "step", "window", False, ())] + [
        (1 + 2 * k, "pass", "newton", False, ()) for k in range(3)] + [
        (len(rows) + 1 + 2 * k, "pass", "newton", True, ())
        for k in range(3)] + [(2 * len(rows), "outputs", "window", False,
                               ())]
    card = C.Recording("fold", "cuda", ("window",), ops=rows * 2,
                       captured=True, track=_track(rows * 2, cap, marks2))
    c2 = tcm.cost_program(card)
    assert (c2.flops, c2.transcendentals, c2.n_while) == (
        c.flops, c.transcendentals, 1)


def test_residency_frees_intermediates_at_last_use(harness):
    """Inputs live throughout, an intermediate until its last use, the
    output to the end: x (8000 B), x*2 and x*2+1 live at once."""
    x = torch.ones(1000, dtype=torch.float64)
    rec = harness.record_fn("resid", lambda v: ((v * 2) + 1).sum(), x)
    c = tcm.cost_program(rec)
    assert c.peak_bytes == 3 * 8000
    assert c.flops == 1000 + 1000 + 1000


# --- budgets through the engine -------------------------------------------

def test_budgeted_contracts_pass():
    census = []
    findings = C.run_contracts(
        fixtures_dir=str(FIXTURES), budgets=True, census=census,
        select={"rhs-modes", "bdf-step", "bdf-step-economy", "sdirk-step",
                "bdf-step-lu32p", "sweep-segment"})
    assert findings == [], "\n".join(f.render() for f in findings)
    budgets = {e["name"]: e["budget"] for e in census}
    assert len(budgets) == 6 and all(b["held"] for b in budgets.values())
    assert budgets["bdf-step-lu32p"]["smem_bytes"] == \
        tcm.lu32p_smem_bytes(9)


def test_over_budget_contract_fails_loudly():
    from batchreactor_tpu_torch.analysis.contracts import (Pure,
                                                           program_contract)

    @program_contract("tmp-over-budget",
                      budget=Budget(flops_per_step=(1.0, 2.0),
                                    peak_bytes=1, smem_bytes=1))
    def _tmp(h):
        yield Pure("tmp", h.segment("tmp-lu32p", linsolve="lu32p"))

    @program_contract("tmp-unbound", budget=Budget(flops_per_step=(1, 2)))
    def _tmp2(h):
        yield C.Identical("x", "x", "a", "a", "no recording")

    try:
        findings = C.run_contracts(
            fixtures_dir=str(FIXTURES),
            select={"tmp-over-budget", "tmp-unbound"}, budgets=True)
        rules = sorted(f.rule for f in findings)
        assert rules == ["budget-flops", "budget-peak-bytes", "budget-smem",
                         "budget-unbound"]
        assert all("tmp-" in f.message for f in findings)
        # budgets are off by default: the same run reports none
        findings = C.run_contracts(
            fixtures_dir=str(FIXTURES),
            select={"tmp-over-budget", "tmp-unbound"})
        assert [f for f in findings if f.rule.startswith("budget")] == []
    finally:
        C._REGISTRY.pop("tmp-over-budget", None)
        C._REGISTRY.pop("tmp-unbound", None)


def test_a_cost_probe_picks_the_budgeted_program():
    """Without a CostProbe the first recorded obligation is budgeted; a
    CostProbe, wherever it stands, takes its place."""
    from batchreactor_tpu_torch.analysis.budgets import CostProbe
    from batchreactor_tpu_torch.analysis.contracts import (Pure,
                                                           program_contract)

    band = Budget(flops_per_step=(1.0, 1e5))    # the RHS, not a step

    @program_contract("tmp-first", budget=band)
    def _first(h):
        yield Pure("rhs", h.gas_rhs_baseline())
        yield Pure("step", h.segment_baseline())

    @program_contract("tmp-probe", budget=band)
    def _probe(h):
        yield Pure("rhs", h.gas_rhs_baseline())
        yield CostProbe("step", h.segment_baseline())

    try:
        census = []
        findings = C.run_contracts(fixtures_dir=str(FIXTURES), budgets=True,
                                   select={"tmp-first", "tmp-probe"},
                                   census=census)
        assert [(f.rule, f.path) for f in findings] == [
            ("budget-flops", "<budget:step>")]
        assert [e["budget"]["tag"] for e in census] == ["rhs", "step"]
    finally:
        C._REGISTRY.pop("tmp-first", None)
        C._REGISTRY.pop("tmp-probe", None)


def test_check_budget_names_each_rule():
    cost = tcm.Cost(flops=10.0, peak_bytes=100, smem_bytes=50)
    assert check_budget("x", "m", Budget(flops_per_step=(1, 20),
                                         peak_bytes=100, smem_bytes=50),
                        cost) == []
    bad = check_budget("x", "m", Budget(flops_per_step=(11, 20),
                                        peak_bytes=99, smem_bytes=49,
                                        doc="why"), cost)
    assert [f.rule for f in bad] == ["budget-flops", "budget-peak-bytes",
                                     "budget-smem"]
    assert all("[why]" in f.message for f in bad)


# --- the gate and the ladders ---------------------------------------------

class TestCostGate:
    def test_banked_baseline_passes(self, table):
        with open(FIXTURES / "torch_cost_gate_baseline.json") as f:
            baseline = json.load(f)
        assert baseline["schema"] == brcost.GATE_SCHEMA
        failures, lines = brcost.run_gate(baseline, table)
        assert failures == [], "\n".join(failures)
        assert set(baseline["programs"]) == set(table)
        assert len(lines) >= 3 * len(table)

    @pytest.mark.parametrize("metric", ["flops", "transcendentals",
                                        "peak_bytes"])
    def test_a_doubled_metric_fails(self, table, metric):
        baseline = brcost.make_baseline(table, "test")
        assert brcost.run_gate(baseline, table)[0] == []
        doubled = {k: v.as_dict() for k, v in table.items()}
        doubled["bdf-step"][metric] *= 2
        failures, _ = brcost.run_gate(baseline, doubled)
        assert len(failures) == 1 and f"bdf-step {metric}" in failures[0]

    def test_a_missing_program_fails(self, table):
        baseline = brcost.make_baseline(table, "test")
        t2 = dict(table)
        del t2["sdirk-step"]
        failures, _ = brcost.run_gate(baseline, t2)
        assert len(failures) == 1 and "disappeared" in failures[0]
        with pytest.raises(ValueError, match="schema"):
            brcost.run_gate({"schema": "bogus-v9", "programs": {}}, table)
        with pytest.raises(ValueError, match="unknown cost metric"):
            brcost.run_gate({"schema": brcost.GATE_SCHEMA, "programs": {
                "bdf-step": {"vmem_bytes": {"max": 1}}}}, table)

    def test_ladders_run_without_torch(self):
        """Run by path with torch unimportable: --ladder and --s-ladder are
        the stdlib estimator alone."""
        script = ROOT / "batchreactor_tpu_torch" / "tools" / "brcost.py"
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys, runpy\n"
             "sys.modules['torch'] = None\n"
             "sys.argv = ['brcost', '--ladder', '--s-ladder', '--json']\n"
             f"runpy.run_path({str(script)!r}, run_name='__main__')\n"
             "assert not [m for m in sys.modules if m.startswith("
             "'batchreactor_tpu_torch.solver')]\n"],
            capture_output=True, text=True, cwd=str(ROOT))
        assert r.returncode == 0, r.stderr
        out = json.loads(r.stdout)
        assert all(row["fits"] for row in out["ladder"])
        assert 2.5 < out["s_ladder"]["loglog_slope"] < 3.1
        assert brcost.main([]) == 2


def test_cost_dataclass_folds_work_and_takes_peaks():
    a = tcm.Cost(flops=10, transcendentals=1, bytes_moved=100,
                 peak_bytes=50, smem_bytes=5)
    b = tcm.Cost(flops=3, transcendentals=2, bytes_moved=30, peak_bytes=80,
                 smem_bytes=4, n_while=1)
    a.add_scaled(b, 4)
    assert (a.flops, a.transcendentals, a.bytes_moved) == (22, 9, 220)
    assert (a.peak_bytes, a.smem_bytes, a.n_while) == (80, 5, 1)
    assert set(a.as_dict()) == {"flops", "transcendentals", "bytes_moved",
                                "peak_bytes", "smem_bytes", "n_while",
                                "n_scan", "n_pallas", "by_prim"}


# --- the serving warmup's pre-flight ----------------------------------------

def test_warmup_logs_the_estimate_before_it_captures():
    from batchreactor_tpu_torch.serving.session import SolverSession

    spec = {"mechanism": {"mech": str(FIXTURES / "h2o2.dat"),
                          "therm": str(FIXTURES / "therm.dat")},
            "solver": {"segment_steps": 8},
            "serve": {"resident": 4, "buckets": [2, 4]}}
    session = SolverSession.from_spec(spec, device="cpu")
    lines = []
    try:
        session.warmup(log=lines.append)
    finally:
        session.release()
    rows, total = session.memory_estimate()
    est = [ln for ln in lines if "predicted resident ~" in ln]
    assert len(est) == len(rows) == 2
    assert lines[:2] == est and "across 2 warmed rung(s)" in lines[2]
    assert any("epoch=" in ln for ln in lines[3:])
    want = sum(tcm.estimate_rung(r, len(session.species),
                                 session.gm.n_reactions,
                                 linsolve="lu")["hbm_bytes"]
               for r in (2, 4))
    assert total == want
