"""The port's static analysis (``batchreactor_tpu_torch/analysis/``, ROADMAP
A17) against the JAX package's (``batchreactor_tpu/analysis/``), on the CPU.

* the tier-A engine: the same seeded source gives byte-equal rendered
  lines, fingerprints and baseline files, and the same suppressions, for
  every rule whose name and meaning both packages share;
* the concurrency lint finds the JAX lint's (rule, line) set on
  ``tests/fixtures/racy_host.py`` for the rules that carry over unchanged;
* the CLI keeps the JAX CLI's exit-code and ``--json`` contract;
* the registries agree, or differ where the ROADMAP says on purpose;
* a seeded fault is found by each tier, and the port scans clean;
* tier A and the concurrency lint run with torch unimportable.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

import batchreactor_tpu.analysis as jan
import batchreactor_tpu.analysis.cli as jcli
import batchreactor_tpu.analysis.core as jcore
import batchreactor_tpu.envknobs as jknobs
import batchreactor_tpu_torch.analysis as tan
import batchreactor_tpu_torch.analysis.cli as tcli
import batchreactor_tpu_torch.analysis.core as tcore
import batchreactor_tpu_torch.envknobs as tknobs
from batchreactor_tpu_torch.analysis import contracts as C
from batchreactor_tpu_torch.analysis.concurrency import lint_concurrency_paths

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "batchreactor_tpu_torch"
JAX_REGISTRY = "(batchreactor_tpu/envknobs.py)"
PORT_REGISTRY = "(batchreactor_tpu_torch/envknobs.py)"

#: one seeded violation per shared rule, plus a suppressed twin.  ``rhs``
#: is device code to both engines: each sees it handed to its own trace
#: consumer.  (A closure nested in a factory would not do: the JAX
#: engine's ``_own_nodes`` also walks a directly nested def's body as the
#: factory's, so it reports such a line twice; the port's walks it once.)
SEEDED = textwrap.dedent('''
    import os

    import jax
    import torch

    NAME = "BR_" + "COMPUTED"
    UNREGISTERED = os.getenv("BR_NOT_A_KNOB")
    COMPUTED = os.environ.get(NAME)


    def rhs(t, y, cfg):
        port = os.environ.get("BR_METRICS_PORT")
        k = y.item()
        j = y.item()  # brlint: disable=host-sync-call
        return y * k + j


    STEP = jax.jit(rhs)
    STEP_T = torch.func.vmap(rhs)


    def reads_import_knob():
        return os.environ.get("BR_TEST_IMPORT_ONCE")
    ''')
SHARED_RULES = ("env-var-unregistered", "env-read-in-trace",
                "host-sync-call")


@pytest.fixture
def seeded(tmp_path, monkeypatch):
    """The seeded file, with one import-once knob registered in both
    packages' registries."""
    path = tmp_path / "seeded.py"
    path.write_text(SEEDED)
    monkeypatch.setitem(jknobs.ENV_KNOBS, "BR_TEST_IMPORT_ONCE",
                        jknobs.EnvKnob("BR_TEST_IMPORT_ONCE", "import",
                                       "tests"))
    monkeypatch.setitem(tknobs.ENV_KNOBS, "BR_TEST_IMPORT_ONCE",
                        tknobs.EnvKnob("BR_TEST_IMPORT_ONCE", "import",
                                       "tests"))
    return str(path)


def _as_port(text):
    """A JAX engine's output with its registry's path replaced by the
    port's: the one place a shared rule's message names its package."""
    return text.replace(JAX_REGISTRY, PORT_REGISTRY)


@pytest.mark.parametrize("rule", SHARED_RULES)
def test_engine_renders_and_fingerprints_like_the_jax_engine(seeded, rule,
                                                             tmp_path):
    jf, jns, jsrc = jan.lint_paths([seeded], select={rule})
    tf, tns, tsrc = tan.lint_paths([seeded], select={rule})
    assert jf, rule
    assert [_as_port(f.render()) for f in jf] == [f.render() for f in tf]
    assert jcore.fingerprints(jf, jsrc) == tcore.fingerprints(tf, tsrc)
    assert [f.base_fingerprint(jsrc[seeded]) for f in jf] == [
        f.base_fingerprint(tsrc[seeded]) for f in tf]
    assert jns == tns == (1 if rule == "host-sync-call" else 0)
    jb, tb = tmp_path / "jax.json", tmp_path / "port.json"
    jcore.Baseline.from_findings(jf, jsrc).save(jb)
    tcore.Baseline.from_findings(tf, tsrc).save(tb)
    assert _as_port(jb.read_text()) == tb.read_text()
    # each baseline absorbs the other engine's findings
    assert tcore.Baseline.load(jb).apply(tf, tsrc)[0] == []


def test_engine_findings_per_shared_rule(seeded):
    """What the seeded file holds: the unregistered, computed and
    import-once reads, the env read and one unsuppressed .item() in the
    device function."""
    tf, _, _ = tan.lint_paths([seeded], select=set(SHARED_RULES))
    got = sorted((f.rule, f.line) for f in tf)
    assert got == [("env-read-in-trace", 13), ("env-var-unregistered", 8),
                   ("env-var-unregistered", 9),
                   ("env-var-unregistered", 24), ("host-sync-call", 14)]


CARRIED = ("unguarded-shared-mutation", "locked-helper-outside-lock",
           "blocking-call-under-lock", "lock-order-inversion")


def test_concurrency_lint_matches_the_jax_lint_on_racy_host():
    path = str(ROOT / "tests" / "fixtures" / "racy_host.py")
    jf, _, _ = jan.lint_concurrency_file(path)
    tf, _, _ = tan.lint_concurrency_file(path)
    pick = lambda fs: {(f.rule, f.line) for f in fs if f.rule in CARRIED}
    assert pick(jf) == pick(tf)
    assert {r for r, _ in pick(tf)} == set(CARRIED)
    # torch has no donate_argnums: the fixture's jax.jit donation is not
    # the port's static-buffer rule
    assert {f.rule for f in tf} == set(CARRIED)


def test_static_buffer_aliasing(tmp_path):
    path = tmp_path / "alias.py"
    path.write_text(textwrap.dedent('''
        def leaks(prog):
            seg = prog.state["seg"]
            return seg["y"], prog.state["flag"]

        def keeps(self, prog):
            self.y = prog.state["seg"]["y"]

        def copies(prog):
            y = prog.state["seg"]["y"].clone()
            return y, prog.state["seg"]["y"].clone()
        '''))
    tf, _, _ = tan.lint_concurrency_file(str(path))
    assert sorted((f.rule, f.line) for f in tf) == [
        ("static-buffer-aliasing", 4), ("static-buffer-aliasing", 7)]


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("json_flag", [[], ["--json"]])
def test_cli_exit_codes_match_the_jax_cli(seeded, tmp_path, capsys,
                                          json_flag):
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x + 1\n")
    baseline = str(tmp_path / "debt.json")
    cases = [
        [seeded] + json_flag,
        [str(clean)] + json_flag,
        json_flag,
        [seeded, "--select", "no-such-rule"] + json_flag,
        [seeded, "--select", "env-read-in-trace"] + json_flag,
        [seeded, "--write-baseline", baseline],
        [seeded, "--baseline", baseline] + json_flag,
    ]
    for argv in cases:
        # (the port's baseline file overwrites the JAX engine's: each
        # engine then reads the port's)
        jrc, jout = _cli(jcli.main, argv, capsys)
        trc, tout = _cli(tcli.main, argv, capsys)
        assert jrc == trc, argv
        if "--json" in argv and jout.strip():
            jdoc, tdoc = json.loads(_as_port(jout)), json.loads(tout)
            assert [f["rule"] for f in jdoc["findings"]] == [
                f["rule"] for f in tdoc["findings"]], argv
            for key in ("baselined", "suppressed", "stale_baseline"):
                assert jdoc[key] == tdoc[key], (argv, key)
    assert tcli.main(["--list-rules"]) == 0
    assert "recapture-hazard" in capsys.readouterr().out


def test_cli_rejects_the_jaxpr_tiers(capsys):
    """Tiers B and D walk jaxprs: the port's CLI refuses them as a usage
    error rather than scanning nothing."""
    for argv in (["--tier", "B"], ["--tier", "D"], ["--jaxpr"],
                 ["--budgets"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert e.value.code == 2, argv
    capsys.readouterr()


def test_env_registry_classes_agree_with_the_jax_registry():
    shared = set(tknobs.ENV_KNOBS) & set(jknobs.ENV_KNOBS)
    assert shared >= {"BENCH_PIPELINE", "BENCH_POLL_EVERY",
                      "BR_CHUNK_BUDGET_S", "BR_FAULT_INJECT",
                      "BR_FETCH_DEADLINE_S", "BR_METRICS_PORT"}
    for name in shared:
        assert tknobs.ENV_KNOBS[name].read == jknobs.ENV_KNOBS[name].read
    # the port's own knob, and none of the TPU probe scripts' rows
    assert set(tknobs.ENV_KNOBS) - shared == {"CUDA_HOME"}
    with pytest.raises(ValueError, match="duplicate"):
        tknobs._build([("A", "call", "x"), ("A", "call", "y")])
    with pytest.raises(ValueError, match="read-time class"):
        tknobs._build([("A", "sometimes", "x")])


#: differences from the JAX package's registries that ROADMAP.md lists as
#: deliberate (A17's "Differences from the JAX package, on purpose")
DELIBERATE = {"families": {"graph"}, "exempt_port": {"mesh"},
              "exempt_jax": {"live"}}


def test_counter_and_schema_registries_against_the_jax_package():
    from batchreactor_tpu.obs import counters as jc
    from batchreactor_tpu.parallel import checkpoint as jck
    from batchreactor_tpu_torch.obs import counters as tc
    from batchreactor_tpu_torch.parallel import checkpoint as tck

    assert set(tc.FAMILIES) - set(jc.FAMILIES) == DELIBERATE["families"]
    assert set(jc.FAMILIES) <= set(tc.FAMILIES)
    for fam in jc.FAMILIES:
        assert tc.FAMILIES[fam] == jc.FAMILIES[fam], fam
    # ROADMAP C12: the port declared only ("energy",)
    assert tck.SCHEMA_KNOBS == jck.SCHEMA_KNOBS
    assert (set(tck._FP_EXEMPT_KEYS) - set(jck._FP_EXEMPT_KEYS)
            == DELIBERATE["exempt_port"])
    assert (set(jck._FP_EXEMPT_KEYS) - set(tck._FP_EXEMPT_KEYS)
            == DELIBERATE["exempt_jax"])
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for token in ("`graph` counter family", "`mesh`", "`live`"):
        assert token in roadmap, token
    assert C.fingerprint_registry_findings() == []
    assert C.counter_registry_findings() == []


# --------------------------------------------------------------------------
# seeded faults, one tier each
# --------------------------------------------------------------------------
def test_tier_a_flags_a_seeded_program_step(tmp_path):
    path = tmp_path / "step.py"
    path.write_text(textwrap.dedent('''
        import torch

        from batchreactor_tpu_torch.solver import graphs


        def build(dev):
            def step(s):
                y = s["y"]
                k = y.sum().item()
                if (y > 0).all():
                    y = y + 1.0
                return {"y": y * k + torch.zeros(3)}

            return graphs.program(("k", dev), lambda: graphs.Program(
                dev, {"step": step}))
        '''))
    tf, _, _ = tan.lint_paths([str(path)])
    assert sorted((f.rule, f.line) for f in tf) == [
        ("host-sync-call", 10), ("host-sync-call", 11),
        ("implicit-dtype", 13)]


def test_tier_a_flags_a_recapture_hazard(tmp_path):
    path = tmp_path / "recapture.py"
    path.write_text(textwrap.dedent('''
        import torch

        from batchreactor_tpu_torch.solver import graphs


        def per_call(dev, rhs):
            def step(s):
                return {"y": rhs(s["y"])}

            prog = graphs.Program(dev, {"step": step})
            g = torch.cuda.CUDAGraph()
            return prog, g


        def per_call_key(dev):
            def f(y):
                return y

            return graphs.program(("k", id(f)), lambda: None)
        '''))
    tf, _, _ = tan.lint_paths([str(path)], select={"recapture-hazard"})
    assert [f.line for f in tf] == [11, 12, 20]


@pytest.fixture(scope="module")
def harness():
    C.load_census()
    return C.Harness(device="cpu")


@pytest.mark.parametrize("kind", ["item", "branch"])
def test_cpu_pure_obligation_flags_a_seeded_host_read(harness, kind):
    def step(t, y, cfg):
        if kind == "item":
            return y * y.sum().item()
        if (y > 0).all():
            return y + 1.0
        return y

    rec = harness.record_fn(f"seeded-{kind}", step, harness.t, harness.y0,
                            harness.cfg)
    found = C._check_obligation(C.Pure(f"seeded-{kind}", rec))
    assert [f.rule for f in found] == ["step-host-sync"]


def test_cpu_pure_obligation_flags_a_float32_leak(harness):
    rec = harness.record_fn("seeded-f32", lambda t, y, cfg: y + torch.zeros(
        y.shape[-1]), harness.t, harness.y0, harness.cfg)
    found = C._check_obligation(C.Pure("seeded-f32", rec, check_dtype=True))
    assert [f.rule for f in found] == ["step-dtype-leak"]
    assert C._check_obligation(C.Pure("seeded-f32", rec)) == []


def test_a_broken_noop_fork_fails_identical(monkeypatch):
    """setup_economy=True at jac_window=1 must record the knob-off
    program; a stepper that adds one op there breaks the fork."""
    from batchreactor_tpu_torch.solver import bdf
    from batchreactor_tpu_torch.solver.common import Stepper

    make = bdf.make_stepper

    def leaky(*a, **kw):
        st = make(*a, **kw)
        if not (kw.get("setup_economy") and kw.get("jac_window") == 1):
            return st

        def window(c, fixed=False):
            c = st.window(c, fixed)
            return {**c, "t": c["t"] + 0.0}

        return Stepper(st.init, window, st.result)

    monkeypatch.setattr(bdf, "make_stepper", leaky)
    found = C.run_contracts(select={"bdf-step-economy"})
    assert [f.rule for f in found] == ["economy-noop-fork"]


def test_an_unregistered_program_site_fails_completeness(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "parallel" / "sweep.py").write_text(
        (PORT / "parallel" / "sweep.py").read_text())
    (pkg / "extra.py").write_text(textwrap.dedent('''
        from .solver import graphs


        def build(dev, step):
            return graphs.program("k", lambda: graphs.Program(
                dev, {"step": step}))
        '''))
    C.load_census()
    found = C.completeness_findings(root=str(pkg))
    missing = [f for f in found if f.rule == "contract-missing"]
    assert [f.path for f in missing] == ["<contracts:extra.py::build>"]
    assert "extra.py:6" in missing[0].message
    assert C.completeness_findings() == []
    assert list(C.program_sites()) == [
        "parallel/sweep.py::_build_segment_program"]
    assert set(C.armed_region_labels()) == {"sweep-segment", "sweep-compact"}


@pytest.mark.parametrize("how", ["exempt", "skipped"])
@pytest.mark.parametrize("knob", ["stats", "timeline"])
def test_dropping_a_schema_knob_from_the_fingerprint_fails_the_audit(
        monkeypatch, knob, how):
    from batchreactor_tpu_torch.parallel import checkpoint as ck

    if how == "exempt":
        monkeypatch.setattr(ck, "_FP_EXEMPT_KEYS",
                            ck._FP_EXEMPT_KEYS + (knob,))
    else:
        fp = ck._sweep_fingerprint
        monkeypatch.setattr(ck, "_sweep_fingerprint", lambda r, y, c, kw: fp(
            r, y, c, {k: v for k, v in kw.items() if k != knob}))
    found = C.fingerprint_registry_findings()
    assert [f.rule for f in found] == ["fingerprint-registry"]
    assert f"'{knob}'" in found[0].message


# --------------------------------------------------------------------------
# the port scans clean, and tier A needs no torch
# --------------------------------------------------------------------------
def test_tier_a_and_concurrency_are_clean_on_the_port(capsys):
    assert tcli.main([str(PORT), str(ROOT / "chip_smoke.py"),
                      "--concurrency"]) == 0
    assert tcli.main(["--concurrency"]) == 0
    capsys.readouterr()
    findings, _, _ = lint_concurrency_paths()
    assert findings == []


def test_contract_tier_is_clean_on_the_cpu(capsys):
    rc = tcli.main(["--tier", "C", "--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc["findings"]
    names = {c["name"] for c in doc["contracts"]}
    assert names == {
        "rhs-modes", "energy-eqns", "energy-noop-fork", "bdf-step",
        "bdf-step-economy", "bdf-step-lu32p", "sdirk-step", "sweep-segment",
        "sweep-segment-bucket", "sweep-segment-resilience", "sweep-compact",
        "sweep-admission", "sweep-upshift", "sweep-mesh-resident",
        "sweep-timeline", "sens-forward-step", "mech-padding"}
    assert all(c["obligations"] > 0 and c["findings"] == 0
               for c in doc["contracts"])
    lu = [c for c in doc["contracts"] if c["name"] == "bdf-step-lu32p"][0]
    assert lu["programs"][0]["ops"] > 0


def test_the_contract_tier_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        C.Harness(device="cuda")


def test_tier_a_runs_with_torch_unimportable(tmp_path):
    (tmp_path / "torch.py").write_text("raise ImportError('torch blocked')\n")
    (tmp_path / "jax.py").write_text("raise ImportError('jax blocked')\n")
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent('''
        import torch

        def make_r(n):
            def rhs(t, y, cfg):
                return y + torch.zeros(3)
            return rhs
        '''))
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    shim = str(PORT / "tools" / "brlint.py")
    res = subprocess.run([sys.executable, shim, str(bad)], env=env,
                         capture_output=True, text=True, cwd=str(ROOT))
    assert res.returncode == 1, res.stderr
    assert "implicit-dtype" in res.stdout
    res = subprocess.run([sys.executable, shim, "--concurrency"], env=env,
                         capture_output=True, text=True, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr


# --------------------------------------------------------------------------
# the counters the mesh's threads share (ROADMAP C13, C14)
# --------------------------------------------------------------------------
def test_c13_graph_and_launch_counts_lose_no_update_across_threads():
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    graphs.reset_counts()
    before = lc.LAUNCHES
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                graphs.add_count("replays")
                lc.add_launches({"warp": 1})

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(switch)
    assert graphs.COUNTS["replays"] == 16000
    assert lc.LAUNCHES - before == 16000
    graphs.reset_counts()


def test_c14_capture_tally_is_per_thread():
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    mine = lc.captured_by_path()
    mine.update(warp=0, cta=0)
    seen = {}

    def other():
        t = lc.captured_by_path()
        t["warp"] += 5
        seen["tally"] = dict(t)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert seen["tally"] == {"warp": 5, "cta": 0}
    assert lc.captured_by_path() is mine and mine == {"warp": 0, "cta": 0}


def test_lu32p_factor_is_one_named_operator():
    """The wrapper dispatches ``brtorch::lu32p_factor``: on the CPU its
    kernel is the plain version, bit for bit, and an op log names it."""
    from batchreactor_tpu_torch.solver import linalg_cuda as lc

    g = torch.Generator().manual_seed(3)
    A = torch.randn((4, 9, 9), generator=g, dtype=torch.float64) + 4 * \
        torch.eye(9, dtype=torch.float64)
    LU, piv = lc.lu32p_factor(A)
    LUp, pivp = lc.lu32p_factor_plain(A)
    assert torch.equal(LU, LUp) and torch.equal(piv, pivp)
    log = C._op_log()
    with log:
        lc.lu32p_factor(A)
    assert [r[0] for r in log.rows] == ["brtorch.lu32p_factor.default"]
    with pytest.raises(ValueError, match="needs"):
        lc.lu32p_factor(A[0])
