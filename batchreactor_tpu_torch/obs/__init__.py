"""Structured runtime telemetry of the port (``batchreactor_tpu/obs``).

One machine-parseable surface for what a long sweep did:

* **where did the wall-clock go** — :class:`~.recorder.Recorder`, nested
  host-side spans (parse / solve / write, the segmented drivers'
  ``segment`` / ``poll`` / ``compact``, the checkpointed sweep's
  ``chunk_*``), point events, counters and fixed-bucket histograms.
  ``with obs.recording(rec): ...`` makes ``rec`` the thread's current
  recorder: the program's own spans (``parse``, ``lib_load``,
  ``program_build``, ``capture``, ``sweep`` with its ``prep``/``finish``
  and the drivers' spans) and the sweep's device-time counters land on it
  without ``stats``; under ``torch.profiler`` each span is a ``br:`` range.
* **what did the solver do** — int32 per-lane counter blocks in the BDF
  and SDIRK steppers' carry (``stats=True``): accepted/rejected steps,
  Newton iterations, Jacobian builds, factorizations, error- vs
  convergence-test rejections, the BDF order histogram, and with
  ``timeline=N`` a ring of each lane's last N attempts
  (:mod:`.counters`, :mod:`.timeline`).  They ride the captured step
  windows as tensor updates and come back with the sweep's final fetch.
* **did we re-capture** — :class:`~.retrace.CompileWatch` counts program
  builds, CUDA graph captures and kernel builds per label, and flags a
  second capture of one step under one program key.
* **is it still moving** — :mod:`.live`: a ``/metrics`` and ``/healthz``
  endpoint fed at the drivers' poll points, per-process fleet snapshots,
  and the fault flight recorder.
* **machine-readable exports** — :mod:`.report` builds the ``br-obs-v1``
  report, :mod:`.export` writes JSON-Lines or Prometheus text, and
  ``tools/obs_report.py`` renders and diffs reports — a report from
  either package, since the schema and every name are the reference's.

Nothing here runs with telemetry off: without ``stats``/``timeline`` the
solver carry gains no key, and without a recorder (passed or entered) the
program records nothing.  No import in this package touches a device.  Request tracing,
the SLO monitor and fleet stitching (:mod:`.trace`, :mod:`.slo`,
:mod:`.stitch`) are fed by the serving scheduler and the fleet router.
"""

from . import counters, live, slo, stitch, timeline, trace  # noqa: F401
from .export import (from_jsonl, read_jsonl, to_jsonl, to_prometheus,
                     write_jsonl)
from .live import (FlightRecorder, LiveRegistry, MetricsServer, arm_flight,
                   armed_flight, disarm_flight, flight_dump,
                   resolve_live_metrics)
from .recorder import Recorder, null_span, recording
from .report import build_report, diff, render, stats_totals
from .retrace import CompileWatch
from .slo import DEFAULT_OBJECTIVES, Objective, SloMonitor, evaluate_traces
from .stitch import load_fleet, merge_reports, render_fleet
from .stitch import stitch as stitch_traces
from .trace import STAGES, TRACE_VERSION, RequestTrace

__all__ = [
    "Recorder",
    "null_span",
    "recording",
    "CompileWatch",
    "build_report",
    "render",
    "diff",
    "stats_totals",
    "to_jsonl",
    "from_jsonl",
    "to_prometheus",
    "write_jsonl",
    "read_jsonl",
    "live",
    "timeline",
    "trace",
    "RequestTrace",
    "STAGES",
    "TRACE_VERSION",
    "slo",
    "stitch",
    "Objective",
    "SloMonitor",
    "DEFAULT_OBJECTIVES",
    "evaluate_traces",
    "load_fleet",
    "merge_reports",
    "render_fleet",
    "stitch_traces",
    "LiveRegistry",
    "MetricsServer",
    "FlightRecorder",
    "arm_flight",
    "armed_flight",
    "disarm_flight",
    "flight_dump",
    "resolve_live_metrics",
]
