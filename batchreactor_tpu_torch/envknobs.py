"""The declarative environment-knob registry of the port (tier-A rule
``env-var-unregistered``).

Every ``os.environ`` / ``os.getenv`` read in the port, ``chip_smoke.py``
and ``tools/`` must name a knob registered here, with its **read-time
class**:

* ``"import"`` — read ONCE at module import and frozen.  The lint also
  rejects an import-once knob read inside a function body, so the
  read-once contract cannot quietly become a read-sometimes bug.
* ``"call"`` — resolved per call or construction; safe to toggle between
  runs (but never inside a captured step — ``env-read-in-trace`` covers
  that: a captured graph replays the value it saw at capture).

The rows are the port's own knobs.  A knob that the JAX package reads too
keeps the JAX package's class (``tests/test_torch_analysis.py`` holds the
two registries to that).  The JAX package's rows for its TPU probe scripts
are not copied: the port has no such scripts.  Stdlib-only: the brlint
shim imports this module with no torch.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    name: str
    read: str        # "import" (frozen at module import) | "call"
    owner: str       # module or script that resolves it
    doc: str = ""


def _build(rows):
    knobs = {}
    for row in rows:
        name, read, owner = row[:3]
        doc = row[3] if len(row) > 3 else ""
        if name in knobs:
            raise ValueError(f"duplicate env knob {name!r}")
        if read not in ("import", "call"):
            raise ValueError(f"env knob {name!r}: read-time class "
                             f"{read!r} (want 'import' or 'call')")
        knobs[name] = EnvKnob(name, read, owner, doc)
    return knobs


#: name -> :class:`EnvKnob`; the single source of truth the tier-A rule
#: checks literal env reads against.
ENV_KNOBS = _build([
    ("BENCH_PIPELINE", "call", "parallel.sweep",
     "segmented-sweep gear (0 = the blocking host loop)"),
    ("BENCH_POLL_EVERY", "call", "parallel.sweep",
     "status-poll stride of the pipelined sweep"),
    ("BR_CHUNK_BUDGET_S", "call", "parallel.checkpoint",
     "wall-clock chunk budget for checkpointed sweeps"),
    ("BR_CHUNK_BUDGET_MULT", "call", "parallel.checkpoint",
     "chunk-budget safety multiplier"),
    ("BR_CHUNK_BUDGET_MIN_S", "call", "parallel.checkpoint",
     "chunk-budget floor, seconds"),
    ("BR_FAULT_INJECT", "call", "resilience.inject",
     "armed fault-injection plan string"),
    ("BR_FETCH_DEADLINE_S", "call", "resilience.watchdog",
     "device-fetch watchdog deadline (the contract harness arms it too)"),
    ("BR_METRICS_PORT", "call", "obs.live",
     "default port for the live /metrics endpoint"),
    ("CUDA_HOME", "call", "solver.linalg_cuda",
     "CUDA toolkit root whose bin/nvcc builds csrc/"),
])
