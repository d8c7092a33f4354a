"""Count the device operations and bytes of one fixed-trip BDF window by
layer: the gas production rates, the surface RHS, the analytic Jacobian and
the rest (Newton updates, masks, the factor and solve, history).

    python -m batchreactor_tpu_torch.tools.window_ops --cell map \\
        [--lanes 4096] [--device cuda]

``--cell map`` is the benchmark's ``gri30-map-b4096`` configuration (GRI-3.0,
isothermal, T 1500..2000 K, phi 0.6..1.6), ``--cell coupled`` its
``gri30ni-coupled-b1024`` one (GRI-3.0 + CH4/Ni, T 1073..1273 K, Asv 1..1000
1/m, ``asv_quirk``); both BDF with ``jac_window=8`` and ``setup_economy``.
One window of ``make_stepper(...).window(carry, fixed=True)`` after the
carry's set-up and one warm-up window runs under a ``TorchDispatchMode``
that counts every aten or custom operator that is not a view, and the bytes
of its tensor operands and results.  An operator counts for the innermost
layer it runs in: the gas rates (``ops/gas_kinetics.py::production_rates``,
whichever route it takes), the RHS closure's other work (the surface
kinetics and the state's scaling), the Jacobian closure, or the rest.
Prints one JSON line.  The op counts do not depend on ``--lanes``; the
bytes grow with it.
"""

import argparse
import contextlib
import json

import numpy as np


def _inputs(cell, B, device):
    """(rhs, jac, y0, cfg, linsolve) of one cell's configuration."""
    import os

    import torch

    import batchreactor_tpu_torch as bt
    from batchreactor_tpu_torch.ops.rhs import (make_gas_jac, make_gas_rhs,
                                                make_surface_jac,
                                                make_surface_rhs)
    from batchreactor_tpu_torch.api import get_solution_vector

    fix = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "fixtures")
    gm = bt.compile_gaschemistry(os.path.join(fix, "grimech.dat"),
                                 device=device)
    th = bt.create_thermo(list(gm.species), os.path.join(fix, "therm.dat"),
                          device=device)
    sp = list(gm.species)
    rng = np.random.default_rng(0)
    X = np.zeros((B, len(sp)))
    if cell == "map":
        T = rng.uniform(1500.0, 2000.0, B)
        phi = rng.uniform(0.6, 1.6, B)
        X[:, sp.index("CH4")] = phi / 2.0
        X[:, sp.index("O2")] = 1.0
        X[:, sp.index("N2")] = 0.5
        X /= X.sum(axis=1, keepdims=True)
        T_t = torch.tensor(T, device=device)
        y0 = get_solution_vector(X, th.molwt, T_t, 1e5)
        return (make_gas_rhs(gm, th), make_gas_jac(gm, th), y0, {"T": T_t},
                "lu32p" if torch.device(device).type == "cuda" else "lu")
    sm = bt.compile_mech(os.path.join(fix, "ch4ni.xml"), th, sp,
                         device=device)
    T = rng.uniform(1073.0, 1273.0, B)
    Asv = 10.0 ** rng.uniform(0.0, 3.0, B)
    X[:, sp.index("CH4")], X[:, sp.index("O2")], X[:, sp.index("N2")] = (
        .25, .5, .25)
    T_t = torch.tensor(T, device=device)
    y0 = get_solution_vector(X, th.molwt, T_t, 1e5, ini_covg=sm.ini_covg)
    cfg = {"T": T_t, "Asv": torch.tensor(Asv, device=device)}
    return (make_surface_rhs(sm, th, gm=gm, asv_quirk=True),
            make_surface_jac(sm, th, gm=gm, asv_quirk=True), y0, cfg, "lu")


def count_window(cell, B, device):
    """{layer: {"ops": n, "bytes": b}} of one fixed-trip window."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from batchreactor_tpu_torch.analysis.costmodel import _VIEWS, _op_name
    from batchreactor_tpu_torch.ops import gas_kinetics
    from batchreactor_tpu_torch.solver import bdf

    rhs, jac, y0, cfg, linsolve = _inputs(cell, B, device)
    layer = ["rest"]
    tally = {}

    @contextlib.contextmanager
    def inside(name):
        layer.append(name)
        try:
            yield
        finally:
            layer.pop()

    def rhs_l(t, y, c):
        with inside("rhs_other"):
            return rhs(t, y, c)

    def jac_l(t, y, c):
        with inside("jacobian"):
            return jac(t, y, c)

    rates = gas_kinetics.production_rates

    def rates_l(*a, **kw):
        with inside("gas_rates"):
            return rates(*a, **kw)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if _op_name(str(func))[0] not in _VIEWS:
                nbytes = sum(t.numel() * t.element_size()
                             for t in tree_leaves((args, kwargs, out))
                             if isinstance(t, torch.Tensor))
                row = tally.setdefault(layer[-1], {"ops": 0, "bytes": 0})
                row["ops"] += 1
                row["bytes"] += nbytes
            return out

    n = y0.shape[1]
    st = bdf.make_stepper(rhs_l, cfg, B, n, y0.dtype, y0.device, rtol=1e-6,
                          atol=1e-10, linsolve=linsolve, jac=jac_l,
                          jac_window=8, setup_economy=True)
    gas_kinetics.production_rates = rates_l
    try:
        c = st.init(y0, 0.0, 1e-3)
        c = st.window(c, fixed=True)          # warm-up: lazy caches
        with torch.no_grad(), Count():
            st.window(c, fixed=True)
    finally:
        gas_kinetics.production_rates = rates
    return tally


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=("map", "coupled"), required=True)
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes (default: the cell's, 4096 or 1024)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    B = args.lanes or (4096 if args.cell == "map" else 1024)
    tally = count_window(args.cell, B, args.device)
    total = {k: sum(r[k] for r in tally.values()) for k in ("ops", "bytes")}
    print(json.dumps({"cell": args.cell, "lanes": B, "device": args.device,
                      "layers": tally, "total": total}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
