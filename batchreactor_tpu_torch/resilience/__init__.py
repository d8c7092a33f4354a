"""Fault-tolerant sweep execution: the port of
``batchreactor_tpu/resilience``.

* **wedge watchdog** (:mod:`.watchdog`) — every blocking host read of the
  segmented driver can carry a deadline (``fetch_deadline=``, through the
  one choke point in ``solver/graphs.py``); checkpointed chunks can carry
  a whole-chunk budget (``chunk_budget_s=``).  A breach marks the device
  suspect and raises :class:`~.watchdog.WedgeError`, which the retry
  layer absorbs.
* **chunk retry** (:mod:`.policy` +
  ``parallel.checkpoint.checkpointed_sweep(retry=...)``) — failed or
  timed-out chunks re-solve with exponential backoff after a backend
  reset, with a per-chunk attempt ledger in the checkpoint manifest; in
  the elastic tier (``parallel.multihost.elastic_checkpointed_sweep``) a
  dead process's chunks are taken over by survivors through heartbeat
  liveness.  CUDA runtime errors are never retried in-process (ROADMAP
  C6, :func:`~.policy.retryable`).
* **lane quarantine** (:mod:`.quarantine`) — non-success lanes re-solve
  in a same-settings pass, then a tighter-tolerance pass; results carry a
  per-lane ``provenance``.
* **fault injection** (:mod:`.inject`) — deterministic simulation of a
  hung wait, a killed process, a corrupt chunk file and a NaN lane.
* **guarded subprocesses** (:mod:`.guard`) and **heartbeat liveness**
  (:mod:`.heartbeat`).

The layer is host-side: with no deadline, no injection and no fault, the
sweeps launch exactly what they launch without it.
"""

from . import inject, quarantine  # noqa: F401  (submodule re-exports)
from .guard import GuardedResult, run_guarded
from .heartbeat import Heartbeat, file_age, is_alive
from .policy import (QuarantinePolicy, RETRYABLE, RetryPolicy, cuda_error,
                     fallback_kwargs, normalize_quarantine, normalize_retry,
                     retryable)
from .quarantine import PROVENANCE_NAMES, native_oracle
from .watchdog import (WedgeError, block_with_deadline, clear_suspects,
                       fetch_with_deadline, mark_suspect, reset_backend,
                       resolve_fetch_deadline, suspect_devices,
                       terminate_self)

__all__ = [
    "GuardedResult",
    "run_guarded",
    "RetryPolicy",
    "QuarantinePolicy",
    "RETRYABLE",
    "cuda_error",
    "retryable",
    "normalize_retry",
    "normalize_quarantine",
    "fallback_kwargs",
    "PROVENANCE_NAMES",
    "native_oracle",
    "WedgeError",
    "fetch_with_deadline",
    "block_with_deadline",
    "resolve_fetch_deadline",
    "reset_backend",
    "terminate_self",
    "mark_suspect",
    "suspect_devices",
    "clear_suspects",
    "Heartbeat",
    "file_age",
    "is_alive",
    "inject",
    "quarantine",
]
