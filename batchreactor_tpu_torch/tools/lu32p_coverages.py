"""The float32 ``lu32p`` factor on the coupled GRI-3.0 + CH4/Ni path, on
the CPU (the kernel's plain version): the measurement behind
``linsolve="auto"`` taking the float64 ``lu`` for states with coverages.

    python -m batchreactor_tpu_torch.tools.lu32p_coverages [--temperatures 4]

Prints one JSON object with two parts:

- ``factor``: the Newton matrices M = I - c J at the coupled initial states
  (``--temperatures`` over 1073-1273 K x Asv 1..1000 m^-1) for c = 1e-7,
  1e-5 and 1e-3 s: cond(M), and two float32 LU factorizations with
  partial pivoting, the plain version (8-wide panels, trailing matmul) and
  :func:`blocked_lu32`, the CTA kernel's order of operations (8-wide
  panels, fused multiply-adds).  For each, the componentwise backward error
  (``lu32p_backward_error``) and the row with the largest backward error
  scaled by its own largest |PA| (its species, largest |PA| and largest
  (|L||U|)); between them, the lanes pivoted alike and the largest
  difference scaled by the row's largest |LU| and by its largest
  (|L||U|).  All in units of the tolerance 64 n eps32.
- ``sweep``: the coupled sweep at 1173 K x Asv 1..1000 over the
  reference's 10 s (rtol 1e-6, atol 1e-10, ``jac_window=8`` as on the
  GPU) with ``lu`` and with ``lu32p``, the latter held to twice the
  accepted steps of ``lu``'s slowest lane: lane status, accepted steps,
  the coverage sums' distance from 1 and the wall.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

import batchreactor_tpu_torch as bt
from batchreactor_tpu_torch.ops.rhs import make_surface_jac
from batchreactor_tpu_torch.solver.linalg_cuda import (
    _BLOCK, _pad_identity, lu32p_backward_error, lu32p_factor_plain,
    padded_n, permute_rows)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")
COMP = {"CH4": 0.25, "O2": 0.5, "N2": 0.25}
ASV = (1.0, 10.0, 100.0, 1000.0)
T1 = 10.0
EPS32 = float(np.finfo(np.float32).eps)


def _fma(a, b, c):
    """fmaf(a, b, c) on float32 tensors, exactly: the product is exact in
    float64, the sum is rounded to odd there (its TwoSum error decides the
    last bit), and rounding that to float32 is the fused operation's one
    rounding (Boldo and Melquiond: rounding to odd with two or more extra
    bits, then to nearest, is correct rounding)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def blocked_lu32(A):
    """The CTA kernel's float32 LU with partial pivoting (npad 72..240,
    ``csrc/lu32p.cu``) in its order of operations, on the padded matrix:
    per 8-column panel the column steps (first largest |a| in the current
    row order, the exchange, l = a / pivot, then fmaf(-l, u, a) on the
    panel's columns right of the step), the panel's exchanges on the other
    columns, the U12 strip by t_i = fmaf(-l_ij, t_j, t_i) for j then i,
    and the trailing update by acc = fmaf(-l_j, u_j, acc) for j = 0..7.
    It runs on any device, and reproduces the kernels' factors bit for
    bit."""
    npad = padded_n(A.shape[-1])
    dev = A.device
    LU = _pad_identity(A, npad)
    B = LU.shape[0]
    lanes = torch.arange(B, device=dev)
    ridx = torch.arange(npad, device=dev)
    piv = torch.zeros((B, npad), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    for ps in range(0, npad, _BLOCK):
        pe = ps + _BLOCK
        P = LU[:, :, ps:pe].clone()
        for j in range(_BLOCK):
            k = ps + j
            p = torch.argmax(torch.where(ridx >= k, P[:, :, j].abs(),
                                         neg_inf), dim=1)
            rk = P[:, k, :].clone()
            P[:, k, :] = P[lanes, p, :]
            P[lanes, p, :] = rk
            u = P[:, k, :]
            safe = torch.where(u[:, j].abs() > 0, u[:, j], 1.0)
            below = P[:, k + 1:, :]
            l = below[:, :, j] / safe[:, None]
            below[:, :, j + 1:] = _fma(-l[:, :, None], u[:, None, j + 1:],
                                       below[:, :, j + 1:])
            below[:, :, j] = l
            piv[:, k] = p.to(torch.int32)
        LU[:, :, ps:pe] = P
        off = torch.ones(npad, dtype=torch.bool, device=dev)
        off[ps:pe] = False
        for j in range(_BLOCK):
            k = ps + j
            p = piv[:, k].long()
            rk = LU[:, k, :].clone()
            rp = LU[lanes, p, :].clone()
            LU[:, k, :] = torch.where(off, rp, rk)
            LU[lanes, p, :] = torch.where(off, rk, rp)
        if pe < npad:
            T = LU[:, ps:pe, pe:]
            for j in range(_BLOCK):
                for i in range(j + 1, _BLOCK):
                    T[:, i] = _fma(-LU[:, ps + i, ps + j, None], T[:, j],
                                   T[:, i])
            acc = LU[:, pe:, pe:]
            for j in range(_BLOCK):
                acc[:] = _fma(-LU[:, pe:, ps + j, None], T[:, None, j],
                              acc)
    return LU, piv


def row_backward_error(A, LU, piv, species):
    """The row with the largest max_j |PA - LU|_ij / max_j |PA|_ij: that
    ratio, the row's species (or coverage index), its largest |PA| and its
    largest (|L||U|)."""
    B, npad = LU.shape[0], LU.shape[-1]
    PA = permute_rows(_pad_identity(A, npad).double(), piv)
    L = torch.tril(LU.double(), -1) + torch.eye(npad, dtype=torch.float64)
    U = torch.triu(LU.double())
    E = (PA - L @ U).abs().amax(dim=2)
    ratio = E / PA.abs().amax(dim=2)
    b, i = divmod(int(ratio.argmax()), npad)
    rows = permute_rows(torch.arange(npad, dtype=torch.float64).expand(
        B, npad)[..., None], piv)[b, i, 0]
    row = int(rows)
    name = (species[row] if row < len(species)
            else f"coverage {row - len(species)}")
    return {"ratio": float(ratio.max()), "row": name,
            "row_max_PA": float(PA[b, i].abs().max()),
            "row_max_LLU": float((L[b].abs() @ U[b].abs())[i].max())}


def factor_part(gm, th, sm, n_T):
    sp = list(gm.species)
    x0 = np.zeros(len(sp))
    for k, v in COMP.items():
        x0[sp.index(k)] = v
    T = torch.tensor(np.repeat(np.linspace(1073.0, 1273.0, n_T), len(ASV)))
    Asv = torch.tensor(np.tile(ASV, n_T))
    y0 = bt.get_solution_vector(np.broadcast_to(x0, (T.shape[0], len(sp))),
                                th.molwt, T, 1e5, ini_covg=sm.ini_covg)
    J = make_surface_jac(sm, th, gm=gm)(0.0, y0, {"T": T, "Asv": Asv})
    n = J.shape[-1]
    tol = 64 * n * EPS32
    out = {"lanes": int(J.shape[0]), "n": n, "tol": tol}
    for c in (1e-7, 1e-5, 1e-3):
        M = torch.eye(n, dtype=torch.float64) - c * J
        cond = torch.linalg.cond(M)
        fac = {"plain": lu32p_factor_plain(M), "kernel_order": blocked_lu32(M)}
        row = {"cond_median": float(cond.median()),
               "cond_max": float(cond.max())}
        for name, (LU, piv) in fac.items():
            bwd, l_max = lu32p_backward_error(M, LU, piv)
            worst = row_backward_error(M, LU, piv, list(gm.species))
            worst["ratio"] /= tol
            row[name] = {"componentwise": float(bwd.max()) / tol,
                         "worst_row_of_PA": worst,
                         "max_abs_L": float(l_max.max())}
        (LU_p, piv_p), (LU_u, piv_u) = fac["plain"], fac["kernel_order"]
        same = (piv_p == piv_u).all(dim=1)
        d = (LU_u - LU_p).abs().double()[same]
        npad = LU_p.shape[-1]
        L = torch.tril(LU_p.double(), -1) + torch.eye(npad,
                                                      dtype=torch.float64)
        LLU = (L.abs() @ torch.triu(LU_p.double()).abs())[same]
        row["pivots_alike"] = int(same.sum())
        row["diff_over_row_LU"] = float((d / LU_p.abs().double()[same].amax(
            dim=2, keepdim=True)).max()) / tol
        row["diff_over_row_LLU"] = float((d / LLU.amax(
            dim=2, keepdim=True)).max()) / tol
        out[f"c={c:g}"] = row
    return out


def sweep_part(gm, th, sm):
    T = np.full(len(ASV), 1173.0)
    kw = dict(chem=bt.Chemistry(gaschem=True, surfchem=True), thermo_obj=th,
              gmd=gm, smd=sm, Asv=np.array(ASV), rtol=1e-6, atol=1e-10,
              asv_quirk=True, jac_window=8, device="cpu")
    out = {"T": 1173.0, "Asv": list(ASV), "t1": T1}
    t0 = time.perf_counter()
    ref = bt.batch_reactor_sweep(COMP, T, 1e5, T1, linsolve="lu", **kw)
    wall = time.perf_counter() - t0
    budget = 2 * ref["report"]["n_accepted"]["max"]
    t0 = time.perf_counter()
    got = bt.batch_reactor_sweep(COMP, T, 1e5, T1, linsolve="lu32p",
                                 max_steps=budget, **kw)
    for name, res, w in (("lu", ref, wall),
                         ("lu32p", got, time.perf_counter() - t0)):
        out[name] = {"status": res["status"].tolist(),
                     "t_end": res["t"].tolist(),
                     "accepted": res["report"]["n_accepted"],
                     "covg_sum_max_dev": float(np.abs(
                         res["covg"].sum(axis=1) - 1.0).max()),
                     "wall_s": w}
    out["lu32p"]["max_steps"] = budget
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--temperatures", type=int, default=4,
                    help="temperatures of the factor part (x 4 Asv); 256 "
                         "gives chip_smoke.py's 1024 coupled matrices")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    gm = bt.compile_gaschemistry(os.path.join(FIXTURES, "grimech.dat"),
                                 device="cpu")
    th = bt.create_thermo(list(gm.species),
                          os.path.join(FIXTURES, "therm.dat"), device="cpu")
    sm = bt.compile_mech(os.path.join(FIXTURES, "ch4ni.xml"), th,
                         list(gm.species), device="cpu")
    print(json.dumps({"factor": factor_part(gm, th, sm, args.temperatures),
                      "sweep": sweep_part(gm, th, sm)}, indent=1))


if __name__ == "__main__":
    main()
