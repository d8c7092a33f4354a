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
            "resilience/guard.py"} <= names
    assert (ROOT / "batchreactor_tpu_torch" / "csrc" / "lu32p.cu").is_file()


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


def test_deferred_options_raise_not_implemented(fixtures_dir):
    gm = bt.compile_gaschemistry(os.path.join(fixtures_dir, "h2o2.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species),
                          os.path.join(fixtures_dir, "therm.dat"),
                          device="cpu")
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=th, md=gm,
              device="cpu")
    for opt, item in (({"telemetry": True}, "A14"),
                      ({"timeline": 8}, "A14"),
                      ({"quarantine": {"oracle": True}}, "A16"),
                      ({"live_metrics": 0}, "A14")):
        with pytest.raises(NotImplementedError, match=item):
            bt.batch_reactor_sweep({"H2": 1.0}, 1200.0, 1e5, 1e-6, **kw,
                                   **opt)
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


def test_c5_reference_options_raise_not_implemented_naming_their_item():
    """Every option of the JAX package's signatures that the port lacks
    raises NotImplementedError naming its ROADMAP item, never TypeError."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.solver import bdf

    y0 = torch.ones((1, 1), dtype=torch.float64)

    def rhs(t, y, cfg):
        return -y

    for opt, item in (({"timeline_state": {"t": 0}}, "A14"),
                      ({"step_audit": True}, "A14")):
        with pytest.raises(NotImplementedError, match=item):
            bdf.solve(rhs, y0, 0.0, 1.0, {}, linsolve="lu", **opt)
    for opt, item in (({"stats": True}, "A14"),
                      ({"recorder": object()}, "A14"),
                      ({"_feed": object()}, "A15")):
        with pytest.raises(NotImplementedError, match=item):
            ensemble_solve_segmented(rhs, y0, 0.0, 1.0, {}, linsolve="lu",
                                     **opt)
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
