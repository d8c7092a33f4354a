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
* **Tier D** (:mod:`.costmodel` + :mod:`.budgets`) — the static cost and
  memory model: per program FLOPs, transcendentals, bytes moved and peak
  live-buffer residency, walked over the recorded op logs, and optional
  ``budget=`` cost obligations on a ``@program_contract`` evaluated by the
  same engine (``--budgets`` / ``--tier D``).  Its stdlib
  :func:`~.costmodel.estimate_rung` predicts a (B, S, R) rung's resident
  device memory and step cost (``tools/brcost.py``'s ladders, the serving
  warmup's log).

Tier A and the concurrency lint import neither torch nor jax; the
contract engine imports torch lazily.  The JAX package's tier B
(``jaxpr_audit.py``) has no counterpart: it audits jaxprs, and the port
traces none (ROADMAP "Not ported, with reason").  Tier D's names are the
JAX package's but two: ``cost_jaxpr`` is :func:`~.costmodel.cost_program`
(it walks a recording, not a jaxpr) and ``lu32p_vmem_bytes`` is
:func:`~.costmodel.lu32p_smem_bytes` (the kernel's shared memory per CTA
on the H100, not VMEM).

CLI: ``python -m batchreactor_tpu_torch.tools.brlint``;
``python -m batchreactor_tpu_torch.tools.brcost`` for cost tables and
ladders.
"""

from .core import (Finding, Baseline, all_rules, lint_file, lint_paths,
                   load_suppressions)
from . import rules_ast  # noqa: F401,E402  (registers the tier-A rules:
#                          without this import the registry is empty and
#                          lint_paths would vacuously scan clean)
from .budgets import (  # noqa: E402  (stdlib-only)
    BUDGET_RULES, Budget, CostProbe, check_budget)
from .concurrency import (  # noqa: E402
    CONCURRENCY_RULES, lint_concurrency_file, lint_concurrency_paths)
from .contracts import (  # noqa: E402  (stdlib-only at module scope;
    #                      torch loads lazily inside the engine)
    ProgramContract, all_contracts, program_contract, run_contracts)
from .costmodel import (  # noqa: E402  (stdlib-only at module scope;
    #                      torch loads lazily inside the table)
    Cost, contract_cost_table, cost_program, estimate_rung, fits_hbm,
    lu32p_smem_bytes)

__all__ = ["Finding", "Baseline", "all_rules", "lint_file", "lint_paths",
           "load_suppressions", "CONCURRENCY_RULES",
           "lint_concurrency_file", "lint_concurrency_paths",
           "ProgramContract", "all_contracts", "program_contract",
           "run_contracts", "BUDGET_RULES", "Budget", "CostProbe",
           "check_budget", "Cost", "contract_cost_table", "cost_program",
           "estimate_rung", "fits_hbm", "lu32p_smem_bytes"]
