"""Time the ``lu32p`` kernel of one checkout at given shapes, for an A/B of
two versions of the kernel on one card.

    python batchreactor_tpu_torch/tools/lu32p_ab.py --root DIR \\
        [--label NAME] [--cases coupled_n66 cta_n120 cta_n176 cta_n240]

Run it by path, not with ``-m``: it imports ``batchreactor_tpu_torch`` and
``chip_smoke`` from ``DIR`` (a checkout or an archive of one), so two calls
with two roots time two versions of the kernel with each version's own
``chip_smoke.time_kernel``: the check against the plain version, then the
cold and hot CUDA-event times.  Compare two versions only inside one
machine's run, in turns (A, B, B, A).

Cases: ``coupled_n66`` is the coupled GRI-3.0 + CH4/Ni path's Newton
matrices M = I - 1e-7 J (B = 1024, n = 66), ``cta_nN`` B = 1024 row-permuted
diagonally dominant matrices of size N (the seed of ``chip_smoke.py``'s
phase 2 is not reused: the matrices are made from ``--seed``).  Prints one
JSON line per case and the card's name and power limit.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose kernel and chip_smoke.py to use")
    ap.add_argument("--label", default=None)
    ap.add_argument("--cases", nargs="+",
                    default=["coupled_n66", "cta_n120", "cta_n176",
                             "cta_n240"])
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("lu32p_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import batchreactor_tpu_torch as bt

    if not os.path.dirname(os.path.abspath(bt.__file__)).startswith(root):
        raise RuntimeError(f"imported {bt.__file__}, not from {root}")
    device = torch.device("cuda")
    smi = cs.gpu_name_and_limit()
    gen = torch.Generator().manual_seed(args.seed)
    J = None
    for case in args.cases:
        if case == "coupled_n66":
            if J is None:
                fx = cs.FIXTURES
                gm = bt.compile_gaschemistry(os.path.join(fx, "grimech.dat"))
                th = bt.create_thermo(list(gm.species),
                                      os.path.join(fx, "therm.dat"))
                sm = bt.compile_mech(os.path.join(fx, "ch4ni.xml"), th,
                                     list(gm.species))
                J = cs.coupled_jacobians(gm, th, sm, device)
            M = torch.eye(J.shape[-1], dtype=torch.float64,
                          device=device) - 1e-7 * J
        elif case.startswith("cta_n"):
            M = cs.separated(cs.B_MAIN, int(case[5:]), gen, device)
        else:
            raise ValueError(f"unknown case {case!r}")
        t = cs.time_kernel(M, same_pivots=True)
        print(json.dumps({"label": args.label or root, "case": case,
                          "gpu": smi, **{k: t[k] for k in (
                              "shape", "ms", "hot_ms", "bound_ms",
                              "share_of_bound", "lanes_same_pivots",
                              "backward_err")}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
