"""The port's CUDA kernel on the card (skips without a GPU).

Run on a machine with an NVIDIA GPU and nvcc:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.  The same checks,
at the main path's shapes, are phase 2 of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from batchreactor_tpu_torch.solver import linalg_cuda as lc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 9, 13, 53, 64, 65, 66, 120, 176, 240])
def test_lu32p_kernel_matches_plain_on_separated_pivots(cuda, n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((64, n, n)) * 0.1 + np.eye(n) * rng.uniform(
        10.0, 20.0, (64, 1, n))
    A = np.take_along_axis(A, rng.permuted(
        np.broadcast_to(np.arange(n), (64, n)), axis=1)[..., None], axis=1)
    At = torch.tensor(A, device=cuda)
    before = lc.LAUNCHES
    path = lc.launch_config(64, lc.padded_n(n))["path"]
    assert path == ("warp" if n <= 64 else "cta")
    before_path = lc.LAUNCHES_BY_PATH[path]
    LU_k, piv_k = lc.lu32p_factor(At)
    assert lc.LAUNCHES == before + 1
    assert lc.LAUNCHES_BY_PATH[path] == before_path + 1
    LU_p, piv_p = lc.lu32p_factor_plain(At)
    torch.cuda.synchronize()
    assert torch.equal(piv_k, piv_p)
    scale = LU_p.abs().amax(dim=(1, 2), keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    assert float(((LU_k - LU_p).abs() / scale).max()) <= 64 * max(n, 1) * eps


def _tie_matrix():
    A = 0.5 * np.eye(9)
    A[:, 0] = 0.0
    A[:, 1] = 0.0
    A[5, 0], A[0, 1], A[3, 1] = 10.0, 1.0, -1.0
    A[0, 0] = A[1, 1] = A[5, 5] = 0.0
    return A, [5, 3, 2, 5, 4, 5, 6, 7, 8]


def _nan_matrix():
    A = 2.0 * np.eye(9)
    A[4, 0], A[7, 0] = np.nan, 5.0
    return A, [4, 1, 2, 3, 7, 5, 6, 7, 8]


@pytest.mark.parametrize("case", [_tie_matrix, _nan_matrix],
                         ids=["exact_tie", "nan_pivot"])
def test_lu32p_kernel_pivot_order(cuda, case):
    """An exact tie goes to the first row in the current order (position,
    not original row); a NaN wins its column and the guard divides by 1.0.
    The same cases against the JAX kernel are in test_torch_linalg.py."""
    A, want = case()
    At = torch.tensor(A[None], device=cuda)
    LU_k, piv_k = lc.lu32p_factor(At)
    LU_p, piv_p = lc.lu32p_factor_plain(At)
    torch.cuda.synchronize()
    assert piv_k[0, :9].tolist() == want
    assert torch.equal(piv_k, piv_p)
    assert torch.equal(torch.isnan(LU_k), torch.isnan(LU_p))
    fin = torch.isfinite(LU_p)
    assert float((LU_k[fin] - LU_p[fin]).abs().max()) <= 1e-6


def test_lu32p_kernel_singular_guard(cuda):
    S = torch.tensor([[[1.0, 2.0, 0.0], [3.0, 4.0, 0.0], [5.0, 6.0, 0.0]]],
                     dtype=torch.float64, device=cuda)
    LU, piv = lc.lu32p_factor(S)
    x = lc.lu32p_solve((LU, piv), torch.ones((1, 3), dtype=torch.float64,
                                             device=cuda))
    assert bool(torch.all(torch.isfinite(LU)))
    assert not bool(torch.all(torch.isfinite(x)))


def test_lu32p_kernel_rejects_what_it_cannot_take(cuda):
    before = lc.LAUNCHES
    by_path = dict(lc.LAUNCHES_BY_PATH)
    n = lc.CTA_NPAD_MAX + 1
    with pytest.raises(ValueError, match=f"npad <= {lc.CTA_NPAD_MAX}"):
        lc.lu32p_factor(torch.zeros((1, n, n), dtype=torch.float64,
                                    device=cuda))
    with pytest.raises(TypeError, match="float64"):
        lc.lu32p_factor(torch.eye(3, device=cuda)[None])
    assert lc.LAUNCHES == before and lc.LAUNCHES_BY_PATH == by_path


def test_lu32p_cta_path_on_coupled_newton_matrices(cuda):
    """The CTA path (npad 72) on the coupled GRI-3.0 + CH4/Ni path's own
    Newton matrices M = I - c J (n = 66: 53 gas species, 13 coverages) at
    the coupled initial states, T over 1073-1273 K x Asv 1..1000, for
    c = 1e-7, 1e-5 and 1e-3 s: on every lane the componentwise backward
    bound |PA - LU| <= 64 n eps32 |L||U| with |L| <= 1, which holds the gas
    rows to their own scale beside coverage rows ten decades larger; at
    c = 1e-7 also the plain version's pivots, and factors within 64 n eps32
    of each row's largest (|L||U|)."""
    import os

    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.ops.rhs import make_surface_jac

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    gm = bt.compile_gaschemistry(os.path.join(fixtures, "grimech.dat"),
                                 device=cuda)
    th = bt.create_thermo(list(gm.species),
                          os.path.join(fixtures, "therm.dat"), device=cuda)
    sm = bt.compile_mech(os.path.join(fixtures, "ch4ni.xml"), th,
                         list(gm.species), device=cuda)
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in {"CH4": 0.25, "O2": 0.5, "N2": 0.25}.items():
        x0[sp.index(k)] = v
    B = 256
    T = torch.tensor(np.repeat(np.linspace(1073.0, 1273.0, B // 4), 4),
                     device=cuda)
    Asv = torch.tensor(np.tile([1.0, 10.0, 100.0, 1000.0], B // 4),
                       device=cuda)
    y0 = bt.get_solution_vector(np.broadcast_to(x0, (B, len(sp))), th.molwt,
                                T, 1e5, ini_covg=sm.ini_covg)
    J = make_surface_jac(sm, th, gm=gm)(0.0, y0, {"T": T, "Asv": Asv})
    n = J.shape[-1]
    assert n == 66 and lc.launch_config(B, lc.padded_n(n))["path"] == "cta"
    tol = 64 * n * float(np.finfo(np.float32).eps)
    for c in (1e-7, 1e-5, 1e-3):
        M = torch.eye(n, dtype=torch.float64, device=cuda) - c * J
        before = lc.LAUNCHES_BY_PATH["cta"]
        LU_k, piv_k = lc.lu32p_factor(M)
        assert lc.LAUNCHES_BY_PATH["cta"] == before + 1
        bwd, l_max = lc.lu32p_backward_error(M, LU_k, piv_k)
        assert float(bwd.max()) <= tol and float(l_max.max()) <= 1.0, c
        if c == 1e-7:
            LU_p, piv_p = lc.lu32p_factor_plain(M)
            assert torch.equal(piv_k, piv_p)
            L = torch.tril(LU_p.double(), -1) + torch.eye(
                LU_p.shape[-1], dtype=torch.float64, device=cuda)
            llu = (L.abs() @ torch.triu(LU_p.double()).abs()).amax(
                dim=2, keepdim=True)
            diff = (LU_k - LU_p).abs().double()
            assert float((diff / llu).max()) <= tol


def test_tangent_solves_go_through_the_kernel(cuda):
    """A forward-sensitivity sweep at the lu32p gate: every tangent solve
    runs through the kernel's factor, and the tangents agree with the f64
    lu run's."""
    import os

    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import (ensemble_solve_forward,
                                                 sweep_solution_vectors)
    from batchreactor_tpu_torch.sensitivity import params

    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    gm = bt.compile_gaschemistry(os.path.join(fix, "grimech.dat"))
    th = bt.create_thermo(list(gm.species), os.path.join(fix, "therm.dat"))
    sp = list(gm.species)
    B = 1024
    x0 = np.zeros(len(sp))
    x0[sp.index("CH4")], x0[sp.index("O2")], x0[sp.index("N2")] = .25, .5, .25
    T = torch.linspace(1500.0, 2000.0, B, dtype=torch.float64, device=cuda)
    y0 = sweep_solution_vectors(np.broadcast_to(x0, (B, len(sp))), th.molwt,
                                T, 1e5)
    spec = params.select(gm, reactions="*CH4*")
    theta = params.extract(gm, spec)
    rt = params.make_rhs_theta(gm, spec, lambda m: make_gas_rhs(m, th))
    jac = make_gas_jac(params.apply(gm, theta, spec), th)
    before = lc.LAUNCHES
    res = ensemble_solve_forward(rt, y0, 0.0, 1e-4, theta, {"T": T},
                                 jac=jac)
    assert lc.LAUNCHES > before
    assert bool((res.status == 1).all())
    ref = ensemble_solve_forward(rt, y0[:8], 0.0, 1e-4, theta, {"T": T[:8]},
                                 jac=jac, linsolve="lu")
    S, S_ref = res.tangents[:8], ref.tangents
    scale = S_ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((S - S_ref).abs() / scale).max()) <= 1e-3


def _gas_sweep_fns(cuda, B):
    """GRI-3.0 at B lanes on the card: (y0, cfg, rhs, jac, observer,
    observer_init)."""
    import os

    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
    from batchreactor_tpu_torch.parallel import (ignition_observer,
                                                 sweep_solution_vectors)

    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    gm = bt.compile_gaschemistry(os.path.join(fix, "grimech.dat"))
    th = bt.create_thermo(list(gm.species), os.path.join(fix, "therm.dat"))
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    x0[sp.index("CH4")], x0[sp.index("O2")], x0[sp.index("N2")] = .25, .5, .25
    T = torch.linspace(1500.0, 2000.0, B, dtype=torch.float64, device=cuda)
    y0 = sweep_solution_vectors(np.broadcast_to(x0, (B, len(sp))), th.molwt,
                                T, 1e5)
    obs, obs0 = ignition_observer(sp.index("CH4"), mode="half")
    return y0, {"T": T}, make_gas_rhs(gm, th), make_gas_jac(gm, th), obs, obs0


def test_pipelined_gear_one_graph_per_step_and_replays_equal(cuda):
    """The pipelined gear captures each step once per shape, captures
    nothing on a second sweep of that shape, counts the kernel's launches
    per replay, and equals the blocking gear bit for bit."""
    from batchreactor_tpu_torch.parallel import ensemble_solve_segmented
    from batchreactor_tpu_torch.solver import graphs

    y0, cfg, rhs, jac, obs, obs0 = _gas_sweep_fns(cuda, 1024)
    kw = dict(segment_steps=64, jac=jac, observer=obs, observer_init=obs0,
              jac_window=8, setup_economy=True)
    ref = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, pipeline=False,
                                   **kw)
    graphs.reset_counts()
    before = lc.LAUNCHES_BY_PATH["warp"]
    got = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, **kw)
    assert graphs.CAPTURES == {"begin": 1, "window": 1, "end": 1}
    assert lc.LAUNCHES_BY_PATH["warp"] > before
    graphs.reset_counts()
    again = ensemble_solve_segmented(rhs, y0, 0.0, 2e-4, cfg, **kw)
    assert graphs.captures() == 0 and graphs.COUNTS["replays"] > 0
    for res in (got, again):
        for f in ("t", "y", "status", "n_accepted", "n_rejected", "h"):
            assert torch.equal(getattr(res, f).cpu(),
                               getattr(ref, f).cpu()), f
        # equal to the bit, NaN (a lane that has not crossed) where the
        # blocking gear has NaN: torch.equal reads NaN != NaN
        torch.testing.assert_close(res.observed["tau"].cpu(),
                                   ref.observed["tau"].cpu(), rtol=0, atol=0,
                                   equal_nan=True)


def test_graph_capture_failure_raises(cuda):
    """A step that reads a device value on the host cannot be captured,
    and the program raises instead of running it eagerly."""
    from batchreactor_tpu_torch.solver import graphs

    def bad(s):
        return {"x": s["x"] * float(s["x"].sum())}

    prog = graphs.Program(cuda, {"bad": bad})
    prog.set(x=torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError):
        prog.run("bad")


def test_contract_tier_on_the_card(cuda, capsys):
    """``brlint --tier C --device cuda`` (ROADMAP A17): every registered
    contract's programs captured on the h2o2 fixture, every obligation
    held on the captured graphs, and ``bdf-step-lu32p``'s graphs holding
    the kernel (``chip_smoke.py`` phase 26 is the same run)."""
    import json

    from batchreactor_tpu_torch.analysis import cli

    rc = cli.main(["--tier", "C", "--device", "cuda", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0, doc["findings"]
    lu = [c for c in doc["contracts"] if c["name"] == "bdf-step-lu32p"][0]
    assert lu["programs"] and all(
        p["captured"] and p["lu32p_launches"].get("warp", 0) > 0
        for p in lu["programs"])


def test_recording_on_the_card_spans_captures_and_times_replays(cuda):
    """Inside ``obs.recording`` a sweep on the card records one ``capture``
    span per graph captured (``graphs.CAPTURES``), the same host syncs and
    lanes as without a recorder, and its device window with the replays'
    device time inside it; under ``torch.profiler`` its spans are ``br:``
    ranges among the host events, and the card's idle time between the
    profiled sweep's device operations lies mostly in ``br:sweep/segment``
    (the profiler's ``cudaGraphLaunch`` between replays)."""
    import os

    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch import obs
    from batchreactor_tpu_torch.solver import graphs
    from torch.profiler import ProfilerActivity, profile

    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    rec = obs.Recorder()
    graphs.reset_counts()
    with obs.recording(rec):
        gm = bt.compile_gaschemistry(os.path.join(fix, "h2o2.dat"))
        th = bt.create_thermo(list(gm.species), os.path.join(fix, "therm.dat"))

        def sweep():
            return bt.batch_reactor_sweep(
                {"H2": 0.3, "O2": 0.15, "N2": 0.55},
                np.linspace(1100.0, 1500.0, 64), 1e5, 5e-4,
                chem=bt.Chemistry(gaschem=True), thermo_obj=th, md=gm,
                segment_steps=64, jac_window=8, setup_economy=True,
                linsolve="lu32p", device=cuda)

        first = sweep()
    caps = [s for s in rec.spans if s["name"] == "capture"]
    assert caps and len(caps) == graphs.captures()
    assert sorted(s["attrs"]["step"] for s in caps) == sorted(
        k for k, v in graphs.CAPTURES.items() for _ in range(v))
    assert {s["attrs"]["B"] for s in caps} == {64}
    assert all(s["path"].startswith("sweep/") for s in caps)
    c = rec.counters
    assert 0.0 < c["replay_device_s"] <= c["sweep_device_window_s"]
    top = [s for s in rec.spans if s["depth"] == 0]
    assert [s["attrs"].get("what") for s in top[:2]] == ["gas", "thermo"]

    graphs.reset_counts()
    plain = sweep()
    syncs = graphs.COUNTS["host_syncs"]
    graphs.reset_counts()
    again = obs.Recorder()
    with obs.recording(again):
        got = sweep()
    assert graphs.COUNTS["host_syncs"] == syncs and graphs.captures() == 0
    for out in (first, got):
        for k in ("t", "status"):
            np.testing.assert_array_equal(out[k], plain[k])
        for s in plain["x"]:
            np.testing.assert_array_equal(out["x"][s], plain["x"][s])
    (sp,) = [s for s in again.spans if s["name"] == "sweep"]
    assert 0.0 < sp["attrs"]["replay_device_s"] <= sp["attrs"][
        "sweep_device_window_s"]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        with obs.recording(obs.Recorder()):
            sweep()
    events = prof.events()
    names = {e.name for e in events}
    assert {"br:sweep", "br:sweep/prep", "br:sweep/segment",
            "br:sweep/finish"} <= names
    # device work: the card's events bar the host ranges' own annotations
    cuda_t = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda_t]
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name.startswith("br:")]
    [(s0, s1, _)] = [r for r in ranges if r[2] == "br:sweep"]
    hnames = {e.name for e in host}
    work = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == cuda_t and e.name not in hnames
                  and s0 <= e.time_range.start <= s1)
    idle, end = {}, work[0][1]
    for s, e in work[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            inner = min((r for r in ranges if r[0] <= mid <= r[1]),
                        key=lambda r: r[1] - r[0])[2]
            idle[inner] = idle.get(inner, 0.0) + s - end
        end = max(end, e)
    print("idle us between the profiled sweep's device ops, by span:", idle)
    assert max(idle, key=idle.get) == "br:sweep/segment"
