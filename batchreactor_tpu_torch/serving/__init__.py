"""Sweep-as-a-service: the resident solver daemon (docs/serving.md).

Port of ``batchreactor_tpu/serving``.  The serving plane assembles four
existing subsystems into a long-lived process that answers a live stream
of reactor-condition requests from ONE warm, continuously-batched device
program:

* warmed captured programs (``SolverSession.warmup`` captures every
  ladder rung's graphs and pins them — a warmed session serves with no
  capture and no program built);
* the streaming driver with live lane admission (``parallel/sweep.py``
  ``admission=`` + the ``_feed``/``_on_harvest`` hooks — a request
  arriving mid-stream rides lanes freed by finished conditions);
* explicit admission-control backpressure and graceful drain
  (:mod:`.scheduler` — ``overloaded``/``draining`` rejections, never
  silent queueing; SIGTERM answers everything accepted);
* the live telemetry plane (:mod:`~batchreactor_tpu.obs.live` —
  ``GET /metrics`` mid-flight, flight-recorder postmortems).

Layering (request path)::

    schema.validate_request     # loud, versioned JSON grammar
      -> Scheduler.submit       # queue + backpressure; future per request
        -> SolverSession.stream # one resident program per pack key
          -> on_harvest         # future resolves as the LAST lane lands

Entry points: ``tools/serve.py`` (HTTP / stdin-JSONL daemon),
``tools/serve_bench.py`` (seeded Poisson load + latency percentiles),
and ``SolverSession.warmup()`` (capture every rung's graphs before the
first request).  Import is lazy torch-wise: :mod:`.schema`,
:mod:`.scheduler` and :mod:`.client` are numpy/stdlib-only, so clients
and the scheduler tests never pay a device.
"""

from .schema import (SCHEMA_VERSION, TRACE_CTX_VERSION,  # noqa: F401
                     Request, error_response, ok_response,
                     trace_ctx_payload, validate_request,
                     validate_trace_ctx, validate_upload)
from .scheduler import (Draining, Overloaded, RequestResult,  # noqa: F401
                        Scheduler, SchedulerReject)
from .client import (ServeError, SolveClient, poisson_trace,  # noqa: F401
                     stitched_attribution, trace_summary,
                     with_trace_ctx)

__all__ = [
    "SCHEMA_VERSION", "Request", "validate_request", "validate_upload",
    "error_response",
    "ok_response", "Scheduler", "SchedulerReject", "Overloaded",
    "Draining", "RequestResult", "SolverSession", "SessionSpec",
    "SessionStore", "UnknownMechanism",
    "load_spec", "ServingServer", "serve_jsonl", "SolveClient",
    "ServeError", "poisson_trace", "trace_summary",
    "TRACE_CTX_VERSION", "validate_trace_ctx", "trace_ctx_payload",
    "with_trace_ctx", "stitched_attribution",
]

_LAZY = {"SolverSession": "session", "SessionSpec": "session",
         "SessionStore": "session", "UnknownMechanism": "session",
         "load_spec": "session", "ServingServer": "server",
         "serve_jsonl": "server"}


def __getattr__(name):
    # session/server import torch (through api._sweep_fns); loading them
    # lazily keeps `from batchreactor_tpu.serving import SolveClient`
    # device-free for remote clients
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
