"""brlint: static analysis of the port's captured steps and threaded host
stack (the counterpart of ``batchreactor_tpu/analysis/``).

Every step of the pipelined gear is a :class:`~..solver.graphs.Program`
step: eager on the CPU, a captured CUDA graph on the card.  So a host
sync, a default float32 dtype or a missing kernel in a step passes every
CPU test.  Two tiers catch those classes on the CPU, at review time:

* **Tier A** (:mod:`.rules_ast`) — AST rules over the source tree.  The
  engine (:mod:`.core`) classifies every function by whether it runs
  inside a captured step (:mod:`.reachability`) and runs the registered
  rules with per-line ``# brlint: disable=RULE`` suppressions and a
  JSON baseline.  Fingerprints and rendered lines are byte-equal to the
  JAX engine's for a shared rule.
* **Tier C** — (a) the step-program contract registry (:mod:`.contracts`):
  every captured program declares its purity / no-op-fork /
  kernel-presence obligations (``@program_contract`` in
  :mod:`.census`); one engine records the programs on the h2o2
  fixture (an op log on the CPU, the captured graph's kernel nodes on the
  card) and evaluates them, and a completeness check fails when a
  ``graphs.Program(`` site or an armed compile-watch label has no
  contract; plus the fingerprint and counter registry audits.  (b) The
  host-concurrency lint (:mod:`.concurrency`).

Tier A and the concurrency lint import neither torch nor jax; the
contract engine imports torch lazily.  The JAX package's jaxpr tiers
(``jaxpr_audit.py``, ``costmodel.py``, ``budgets.py``) have no
counterpart: the port traces no jaxprs (ROADMAP "Not ported, with
reason").

CLI: ``python -m batchreactor_tpu_torch.tools.brlint``.
"""

from .core import (Finding, Baseline, all_rules, lint_file, lint_paths,
                   load_suppressions)
from . import rules_ast  # noqa: F401,E402  (registers the tier-A rules:
#                          without this import the registry is empty and
#                          lint_paths would vacuously scan clean)
from .concurrency import (  # noqa: E402
    CONCURRENCY_RULES, lint_concurrency_file, lint_concurrency_paths)
from .contracts import (  # noqa: E402  (stdlib-only at module scope;
    #                      torch loads lazily inside the engine)
    ProgramContract, all_contracts, program_contract, run_contracts)

__all__ = ["Finding", "Baseline", "all_rules", "lint_file", "lint_paths",
           "load_suppressions", "CONCURRENCY_RULES",
           "lint_concurrency_file", "lint_concurrency_paths",
           "ProgramContract", "all_contracts", "program_contract",
           "run_contracts"]
