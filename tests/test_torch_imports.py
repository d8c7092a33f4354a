"""Port ground rules: the port and ``chip_smoke.py`` import neither jax nor
the JAX package, and the entry points run on the GPU unless the caller
asks for the CPU (no silent CPU fallback).
"""

import ast
import os
import pathlib

import pytest
import torch

import batchreactor_tpu_torch as bt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "batchreactor_tpu_torch").rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "batchreactor_tpu"}, roots


def test_port_files_found():
    names = {p.relative_to(ROOT / "batchreactor_tpu_torch").as_posix()
             for p in PORT_FILES}
    assert {"api.py", "models/gas.py", "models/surface.py",
            "ops/gas_kinetics.py", "ops/surface_kinetics.py",
            "solver/bdf.py", "solver/sdirk.py", "solver/linalg_cuda.py",
            "energy/eqns.py", "energy/ignition.py", "parallel/grid.py",
            "parallel/sweep.py", "aot/buckets.py", "models/padding.py",
            "sensitivity/params.py", "sensitivity/forward.py",
            "sensitivity/adjoint.py", "sensitivity/rank.py",
            "tools/sens_rank.py", "parallel/checkpoint.py",
            "parallel/multihost.py", "resilience/watchdog.py",
            "resilience/policy.py", "resilience/inject.py",
            "resilience/quarantine.py", "resilience/heartbeat.py",
            "resilience/guard.py", "obs/counters.py", "obs/recorder.py",
            "obs/timeline.py", "obs/report.py", "obs/export.py",
            "obs/live.py", "obs/retrace.py", "utils/profiling.py",
            "tools/obs_report.py", "obs/trace.py", "obs/slo.py",
            "obs/stitch.py", "serving/schema.py", "serving/scheduler.py",
            "serving/session.py", "serving/server.py",
            "serving/client.py", "fleet/ring.py", "fleet/membership.py",
            "fleet/replication.py", "fleet/router.py", "tools/serve.py",
            "tools/serve_bench.py", "tools/serve_fleet.py",
            "native/__init__.py", "native/bindings.py", "tools/obs_gate.py",
            "tools/obs_trace.py", "tools/obs_slo.py", "tools/obs_fleet.py",
            "tools/fault_smoke.py", "envknobs.py", "analysis/__init__.py",
            "analysis/core.py", "analysis/reachability.py",
            "analysis/rules_ast.py", "analysis/concurrency.py",
            "analysis/contracts.py", "analysis/census.py",
            "analysis/cli.py", "tools/brlint.py",
            "tools/northstar_sweep.py", "tools/northstar_baseline.py"} <= names
    assert (ROOT / "batchreactor_tpu_torch" / "csrc" / "lu32p.cu").is_file()
    assert (ROOT / "batchreactor_tpu_torch" / "native"
            / "br_native.cpp").is_file()


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch,
                                                     fixtures_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mech = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.compile_gaschemistry(mech)
    gm = bt.compile_gaschemistry(mech, device="cpu")
    th = bt.create_thermo(list(gm.species), therm, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.create_thermo(list(gm.species), therm)
    for kw in ({}, {"energy": "adiabatic_v"}, {"method": "sdirk"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.15, "N2": 0.55},
                                   1200.0, 1e5, 1e-5,
                                   chem=bt.Chemistry(gaschem=True),
                                   thermo_obj=th, md=gm, **kw)
    # the serving session and its daemon follow the same rule
    from batchreactor_tpu_torch.serving.session import SolverSession

    spec = {"mechanism": {"mech": mech, "therm": therm}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverSession.from_spec(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverSession(gm, th, SolverSession.from_spec(
            spec, device="cpu").spec)


def test_deferred_options_raise_not_implemented(fixtures_dir):
    gm = bt.compile_gaschemistry(os.path.join(fixtures_dir, "h2o2.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species),
                          os.path.join(fixtures_dir, "therm.dat"),
                          device="cpu")
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th, md=gm,
              device="cpu")
    # what the eleventh slice ported runs: the quarantine's oracle rung
    # (no lane fails here, so it is armed and never asked)
    out = bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.2, "N2": 0.5}, 1200.0,
                                 1e5, 1e-7, **kw,
                                 quarantine={"oracle": True})
    assert out["report"]["counts"] == {"success": 1}
    assert out["report"]["quarantine"] == {}
    # what the ninth slice ported runs: telemetry, the timeline and the
    # live endpoint (an ephemeral port)
    for opt in ({"telemetry": True}, {"telemetry": True, "timeline": 8},
                {"live_metrics": 0}):
        out = bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.2, "N2": 0.5},
                                     1200.0, 1e5, 1e-7, **kw, **opt)
        assert out["report"]["counts"] == {"success": 1}, opt
        assert ("telemetry" in out) == bool(opt.get("telemetry")), opt
    # what the eighth slice ported runs: the quarantine, a mesh and the
    # watchdog deadline
    for opt in ({"quarantine": True}, {"mesh": bt.Mesh(["cpu"])},
                {"fetch_deadline": 60.0, "segment_steps": 16}):
        out = bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.2, "N2": 0.5},
                                     1200.0, 1e5, 1e-7, **kw, **opt)
        assert out["report"]["counts"] == {"success": 1}, opt
    # what the seventh slice ported runs: the gears, buckets, admission
    # and the jacfwd fallback
    for opt in ({"pipeline": False, "segment_steps": 16},
                {"admission": 1, "segment_steps": 16},
                {"buckets": "pow2"}, {"analytic_jac": False}):
        out = bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.2, "N2": 0.5},
                                     1200.0, 1e5, 1e-7, **kw, **opt)
        assert out["report"]["counts"] == {"success": 1}, opt
    # what the fifth slice ported runs: the energy path, SDIRK and the
    # float32-inverse Newton modes
    for opt in ({"energy": "adiabatic_v"}, {"method": "sdirk"},
                {"linsolve": "inv32f"}):
        out = bt.batch_reactor_sweep({"H2": 0.3, "O2": 0.2, "N2": 0.5},
                                     1200.0, 1e5, 1e-7, **kw, **opt)
        assert out["report"]["counts"] == {"success": 1}, opt
    # surface chemistry is ported: a coupled sweep given md= alone raises
    # the JAX package's TypeError (it needs gmd= and smd=)
    with pytest.raises(TypeError, match="needs gmd=.*and smd="):
        bt.batch_reactor_sweep({"H2": 1.0}, 1200.0, 1e5, 1e-6,
                               chem=bt.Chemistry(gaschem=True,
                                                 surfchem=True),
                               thermo_obj=th, md=gm, device="cpu")


def test_no_deferral_table_names_a14():
    """Every option of ROADMAP A14 landed: no deferral table of the port
    names it (the tables are the ``(name, default, item)`` tuples handed to
    ``check_deferred``)."""
    for path in PORT_FILES:
        text = path.read_text()
        assert '"A14")' not in text, path


def test_no_deferral_table_names_a15():
    """Every option of ROADMAP A15 landed: no deferral table of the port
    names it, and the streaming driver's table is empty."""
    from batchreactor_tpu_torch.parallel import sweep

    for path in PORT_FILES:
        text = path.read_text()
        assert '"A15")' not in text, path
    assert sweep._DEFERRED == ()


def test_no_deferral_table_names_a16():
    """Every option of ROADMAP A16 landed: no deferral table of the port
    names it, and the one table left (the streaming driver's) is empty:
    ``check_deferred`` is called nowhere else."""
    from batchreactor_tpu_torch.parallel import sweep

    callers = set()
    for path in PORT_FILES:
        text = path.read_text()
        assert '"A16")' not in text, path
        if "check_deferred(" in text:
            callers.add(path.relative_to(ROOT / "batchreactor_tpu_torch")
                        .as_posix())
    assert callers == {"solver/common.py", "parallel/sweep.py"}
    assert sweep._DEFERRED == ()


def test_no_deferral_table_names_a17():
    """ROADMAP A17 landed: no deferral table of the port names it, every
    module of the JAX package's ``analysis/`` that has a PyTorch meaning
    has its counterpart, and the tier-A engine and the concurrency lint
    import neither torch nor jax."""
    for path in PORT_FILES:
        assert '"A17")' not in path.read_text(), path
    jax_mods = {p.name for p in (ROOT / "batchreactor_tpu" / "analysis")
                .glob("*.py")}
    port_mods = {p.name for p in (ROOT / "batchreactor_tpu_torch"
                                  / "analysis").glob("*.py")}
    assert jax_mods - port_mods == {"jaxpr_audit.py", "costmodel.py",
                                    "budgets.py"}
    heavy = {"torch", "jax", "jaxlib", "batchreactor_tpu", "numpy"}
    for rel in ("envknobs.py", "analysis/__init__.py", "analysis/core.py",
                "analysis/reachability.py", "analysis/rules_ast.py",
                "analysis/concurrency.py", "analysis/cli.py",
                "tools/brlint.py"):
        roots = _imported_roots(ROOT / "batchreactor_tpu_torch" / rel)
        assert not roots & heavy, (rel, roots)
    # the contract engine imports torch lazily, inside its harness
    tree = ast.parse((ROOT / "batchreactor_tpu_torch" / "analysis"
                      / "contracts.py").read_text())
    top = {a.name.split(".")[0] for n in tree.body
           if isinstance(n, ast.Import) for a in n.names}
    assert not top & heavy, top
    # the census lives in the analysis package: the modules whose programs
    # it records import nothing of it
    for path in PORT_FILES:
        rel = path.relative_to(ROOT / "batchreactor_tpu_torch").as_posix()
        if rel.startswith("analysis/") or rel == "tools/brlint.py":
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert "analysis" not in (node.module or "").split("."), rel


def _exported(path):
    """The public names a package ``__init__`` binds: its relative
    imports, its module-level assignments, ``__version__`` and the entries
    of ``__all__`` (a starred tuple of the module expanded)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, seqs = set(), {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        seqs[target.id] = node.value.elts
    for elt in seqs.get("__all__", ()):
        if isinstance(elt, ast.Starred):
            names |= {e.value for e in seqs[elt.value.id]}
        else:
            names.add(elt.value)
    return {n for n in names if not n.startswith("_")
            or n == "__version__"}


#: what the port leaves out of the JAX package's namespaces on purpose
#: (ROADMAP "Not ported, with reason"): the AOT registry, and the static
#: analysis package's jaxpr tiers (the cost model, the budgets)
C10_EXCEPTIONS = {
    "aot": {"WarmupResult", "bundle_shape_signature", "cache_stats",
            "configure_cache", "enforce_capacity", "load_manifest",
            "manifest_path", "mechanism_fingerprint", "merge_manifests",
            "pin_keys", "program_key", "reset_persistent_cache",
            "spec_keys", "touch_keys", "warmup"},
    "analysis": {"Budget", "BUDGET_RULES", "CostProbe", "check_budget",
                 "Cost", "contract_cost_table", "cost_jaxpr",
                 "estimate_rung", "fits_hbm", "lu32p_vmem_bytes"},
}
C10_MISSING_PACKAGES = set()


def test_c10_every_init_exports_the_jax_names():
    """ROADMAP C10: each package ``__init__`` of the port binds every
    public name of the JAX package's (compared by AST), except the
    deliberate omissions above; and the names import."""
    jax_root = ROOT / "batchreactor_tpu"
    missing_pkgs = set()
    for init in sorted(jax_root.rglob("__init__.py")):
        rel = init.parent.relative_to(jax_root).as_posix()
        port = ROOT / "batchreactor_tpu_torch" / rel / "__init__.py"
        if not port.exists():
            missing_pkgs.add(rel)
            continue
        lacking = _exported(init) - _exported(port)
        assert lacking == C10_EXCEPTIONS.get(rel, set()), (rel, lacking)
    assert missing_pkgs == C10_MISSING_PACKAGES
    import importlib

    for rel, names in (("aot", ("POW2", "bucket_ladder",
                                "normalize_buckets", "resolve_bucket")),
                       ("io", ("InputData", "input_data",
                               "parse_composition_text", "write_profiles")),
                       ("parallel", ("pad_to_bucket", "resolve_admission")),
                       ("obs", ("trace", "slo", "stitch", "RequestTrace",
                                "STAGES", "TRACE_VERSION",
                                "DEFAULT_OBJECTIVES", "Objective",
                                "SloMonitor", "evaluate_traces",
                                "load_fleet", "merge_reports",
                                "render_fleet", "stitch_traces"))):
        mod = importlib.import_module(f"batchreactor_tpu_torch.{rel}")
        for name in names:
            assert getattr(mod, name) is not None, (rel, name)
    assert bt.obs.stitch_traces is bt.obs.stitch.stitch
    assert bt.__version__ == "0.1.0" and "obs" in bt.__all__


#: the modules that must stay importable without a device stack: the
#: request grammar, the scheduler, the client, the router plane and the
#: trace/SLO/stitch planes (the reference's numpy-and-stdlib contract)
DEVICE_FREE = ["serving/schema.py", "serving/scheduler.py",
               "serving/client.py", "obs/trace.py", "obs/slo.py",
               "obs/stitch.py"] + sorted(
    p.relative_to(ROOT / "batchreactor_tpu_torch").as_posix()
    for p in (ROOT / "batchreactor_tpu_torch" / "fleet").glob("*.py"))


@pytest.mark.parametrize("rel", DEVICE_FREE)
def test_serving_and_fleet_planes_import_neither_torch_nor_jax(rel):
    path = ROOT / "batchreactor_tpu_torch" / rel
    roots = _imported_roots(path)
    assert not roots & {"torch", "jax", "jaxlib", "batchreactor_tpu",
                        "triton"}, roots
    assert roots <= {"numpy", "bisect", "collections", "dataclasses",
                     "hashlib", "http", "json", "os", "random",
                     "threading", "time", "urllib", "uuid",
                     "concurrent"}, roots


def test_c5_reference_options_raise_not_implemented_naming_their_item():
    """Every option of the JAX package's signatures that the port lacks
    raises NotImplementedError naming its ROADMAP item, never TypeError."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.solver import bdf

    y0 = torch.ones((1, 1), dtype=torch.float64)

    def rhs(t, y, cfg):
        return -y

    # the ninth slice's options run (ROADMAP A14), or raise the JAX
    # package's ValueError when given without what they ride on
    res = bdf.solve(rhs, y0, 0.0, 1.0, {}, linsolve="lu", step_audit=True)
    assert res.accept_ring.shape == (1, 64)
    with pytest.raises(ValueError, match="timeline_state"):
        bdf.solve(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                  timeline_state={"t": 0})
    from batchreactor_tpu_torch.obs import Recorder

    res = ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                   stats=True, recorder=Recorder())
    assert int(res.stats["n_accepted"][0]) == int(res.n_accepted[0])
    # the tenth slice's _feed runs on the streaming driver and raises the
    # JAX package's ValueError without admission=
    with pytest.raises(ValueError, match="admission"):
        ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                 _feed=lambda n, idle: None)
    res = ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                   admission=1, segment_steps=16,
                                   _feed=lambda n, idle: None)
    assert int(res.status[0]) == 1
    # the eighth slice's options run, or raise the JAX package's
    # ValueError outside the streaming driver
    res = ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                   axis="lanes", fetch_deadline=60.0,
                                   mesh=bt.Mesh(["cpu"], ("lanes",)))
    assert int(res.status[0]) == 1
    for opt in ({"mesh_resident": 1}, {"_on_harvest": print}):
        with pytest.raises(ValueError, match="admission"):
            ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                     **opt)
    # err0 is accepted and ignored by the BDF, as the JAX package does
    a = bdf.solve(rhs, y0, 0.0, 1.0, {}, err0=None, linsolve="lu")
    b = bdf.solve(rhs, y0, 0.0, 1.0, {}, err0=torch.ones(1), linsolve="lu")
    assert int(a.status[0]) == 1 and torch.equal(a.y, b.y)
    # sens_iters and sens_errcon are real options now
    bdf.solve(rhs, y0, 0.0, 1.0, {}, sens_iters=3, sens_errcon=True,
              linsolve="lu")
    assert bt.InputData is not None and callable(bt.input_data)
    for name in ("InputData", "input_data", "SensitivityProblem",
                 "SensitivitySolution", "sensitivity", "mech_shape_class",
                 "pad_gas_mechanism", "pad_states", "pad_thermo", "Mesh",
                 "checkpointed_sweep", "resilience"):
        assert name in bt.__all__, name
