"""Tier D budget contracts of the port: cost obligations on the recorded
step programs (the counterpart of ``batchreactor_tpu/analysis/budgets.py``).

Every :func:`~.contracts.program_contract` may arm a :class:`Budget`, a
set of static cost bounds that the same ``run_contracts`` engine evaluates
with ``budgets=True`` (``brlint --budgets`` / ``--tier D``).  The engine
costs the contract's recorded program with :mod:`.costmodel`, and a bound
that does not hold is a finding, so a step program whose FLOPs per attempt
or peak residency silently regresses fails like an impure step does.

The bands are authored on the h2o2 fixture at the harness's B = 8 lanes
(``census.py`` says, per contract, whether it is the JAX band for eight
lanes or a 2x band around the port's own walk) and are loose on purpose:
they catch structural regressions (a doubled Jacobian build, a Newton loop
no longer folded, the kernel's footprint past one block's shared memory),
not single-flop drift.  ``smem_bytes`` replaces the JAX ``vmem_bytes``:
the ``lu32p`` kernel's per-CTA shared memory against the H100's opt-in
limit.
"""

import dataclasses

from .core import Finding

#: the tier-D rule catalogue (``brlint --list-rules``)
BUDGET_RULES = {
    "budget-flops": "recorded program's FLOPs per attempt outside its "
                    "contract's budget band",
    "budget-peak-bytes": "recorded program's peak live-buffer residency "
                         "above its contract's budget",
    "budget-smem": "lu32p kernel's per-CTA shared memory above its "
                   "contract's budget (the H100's 227 KiB per block)",
    "budget-unbound": "contract arms a budget= but yields no recorded "
                      "program to cost",
}


@dataclasses.dataclass(frozen=True)
class Budget:
    """Static cost bounds for one contracted program, all optional:
    ``flops_per_step`` is a ``(lo, hi)`` band on the one-attempt walk
    (catching both a cost explosion and a program that stopped doing its
    work), ``peak_bytes`` / ``smem_bytes`` are ceilings.  ``doc`` says how
    the band was chosen; the finding echoes it."""

    flops_per_step: tuple = None     # (lo, hi) inclusive band
    peak_bytes: int = None           # ceiling on live-buffer high-water
    smem_bytes: int = None           # ceiling on the kernel's footprint
    doc: str = ""


@dataclasses.dataclass
class CostProbe:
    """An explicit "cost THIS recording" obligation.  Without one the
    engine budgets the contract's first recorded obligation; a contract
    yields a CostProbe to pick another.  Checked as a no-op."""

    tag: str
    recording: object


def _fmt_bytes(b):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.4g} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024.0


def check_budget(name, module, budget, cost, tag=None):
    """Evaluate one contract's :class:`Budget` against its program's
    walked :class:`~.costmodel.Cost`; returns findings (empty = the
    program fits its budget)."""
    where = f"<budget:{tag or name}>"
    note = f" [{budget.doc}]" if budget.doc else ""
    findings = []
    if budget.flops_per_step is not None:
        lo, hi = budget.flops_per_step
        if not (lo <= cost.flops <= hi):
            findings.append(Finding(
                "budget-flops", where, 0, 0,
                f"contract {name!r} ({module}): {cost.flops:.4g} "
                f"FLOPs/step outside budget band [{lo:.4g}, {hi:.4g}]"
                f"{note}"))
    if budget.peak_bytes is not None and cost.peak_bytes > budget.peak_bytes:
        findings.append(Finding(
            "budget-peak-bytes", where, 0, 0,
            f"contract {name!r} ({module}): peak residency "
            f"{_fmt_bytes(cost.peak_bytes)} exceeds budget "
            f"{_fmt_bytes(budget.peak_bytes)}{note}"))
    if budget.smem_bytes is not None and cost.smem_bytes > budget.smem_bytes:
        findings.append(Finding(
            "budget-smem", where, 0, 0,
            f"contract {name!r} ({module}): lu32p shared memory "
            f"{_fmt_bytes(cost.smem_bytes)} per CTA exceeds budget "
            f"{_fmt_bytes(budget.smem_bytes)}{note}"))
    return findings
