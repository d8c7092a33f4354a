"""Top-k reaction sensitivity ranking for a batch-reactor input file.

The port's counterpart of ``scripts/sens_rank.py``: solve the run a
reference-format ``batch.xml`` describes, differentiate a scalar QoI with
respect to the selected mechanism parameters, and print the normalized
coefficients d ln(QoI)/d ln(A_i) ranked by magnitude, in the same format.

  python -m batchreactor_tpu_torch.tools.sens_rank INPUT.xml LIB_DIR --qoi H2O
  python -m batchreactor_tpu_torch.tools.sens_rank INPUT.xml LIB_DIR \\
      --qoi ignition:OH --mode adjoint -k 15
  python -m batchreactor_tpu_torch.tools.sens_rank INPUT.xml LIB_DIR \\
      --qoi H2O --reactions '*H2O2*' --device cpu

``--mode adjoint`` (default) costs one backward pass however many
reactions are ranked; ``--mode forward`` carries one tangent row per
parameter.  ``--device`` defaults to the GPU (``cuda``).
"""

import argparse
import sys

import batchreactor_tpu_torch as bt
from batchreactor_tpu_torch.sensitivity import rank


def _build_parser():
    p = argparse.ArgumentParser(
        prog="sens_rank",
        description="rank reactions by normalized QoI sensitivity "
                    "(d ln QoI / d ln A)")
    p.add_argument("input_xml", help="reference-format batch.xml")
    p.add_argument("lib_dir", help="mechanism library directory")
    p.add_argument("--qoi", required=True,
                   help="species name (final mass-density QoI) or "
                        "'ignition:MARKER[:FRAC]' (adjoint only)")
    p.add_argument("--mode", choices=("adjoint", "forward"),
                   default="adjoint")
    p.add_argument("--gas", action="store_true", default=True,
                   help="gas-phase chemistry (default)")
    p.add_argument("--no-gas", dest="gas", action="store_false")
    p.add_argument("--surf", action="store_true",
                   help="surface chemistry (combine with --gas for "
                        "coupled)")
    p.add_argument("--fields", default="log_A",
                   help="comma-separated theta fields (default log_A; "
                        "ranking normalizes log_A only)")
    p.add_argument("--reactions", default=None,
                   help="reaction selection glob (default: all)")
    p.add_argument("-k", type=int, default=10, help="rows to print")
    p.add_argument("--rtol", type=float, default=1e-6)
    p.add_argument("--atol", type=float, default=1e-10)
    p.add_argument("--sens-grid", type=int, default=512,
                   help="adjoint fixed re-solve grid size")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    qoi = args.qoi
    if qoi.lower().startswith("ignition:"):
        parts = qoi.split(":")
        qoi = ("ignition", parts[1]) if len(parts) == 2 else (
            "ignition", parts[1], float(parts[2]))
    fields = tuple(f.strip() for f in args.fields.split(",") if f.strip())
    sens_params = {"fields": fields}
    if args.reactions is not None:
        sens_params["reactions"] = args.reactions

    sol = bt.batch_reactor(
        args.input_xml, args.lib_dir, gaschem=args.gas,
        surfchem=args.surf, sens=args.mode, sens_qoi=qoi,
        sens_params=sens_params, sens_grid=args.sens_grid,
        rtol=args.rtol, atol=args.atol, verbose=False, device=args.device)
    if sol.status != "Success":
        print(f"sens_rank: solve ended with {sol.status}", file=sys.stderr)
        return 1
    if getattr(sol, "truncated", False):
        print("sens_rank: adjoint grid overflowed — the ranking below is "
              "for a shortened horizon; re-run with a larger --sens-grid",
              file=sys.stderr)
        return 1
    if sol.qoi_grad is None or "log_A" not in sol.qoi_grad:
        print("sens_rank: no log_A gradient to rank (include log_A in "
              "--fields)", file=sys.stderr)
        return 2
    coeffs = rank.normalized_sensitivities(sol.qoi, sol.qoi_grad["log_A"])
    qoi_name = args.qoi if isinstance(args.qoi, str) else "tau_ign"
    print(f"QoI = {float(sol.qoi):.6e}  "
          f"({sol.spec.n_reactions} reactions ranked, mode={args.mode})")
    print(rank.format_ranking(rank.top_k(coeffs, sol.spec.equations,
                                         k=args.k), qoi_name=qoi_name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
