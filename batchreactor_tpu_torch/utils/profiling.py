"""Per-phase timers and device tracing (``batchreactor_tpu/utils/
profiling.py``).

``Phases`` is a thin shim over :class:`~..obs.recorder.Recorder`, the
structured telemetry of ``obs/``: the recorder does the timing, this
class re-shapes its view to the flat ``{name: seconds}`` dicts.  New code
should create a ``Recorder`` (or pass ``telemetry=True`` through the API).

``device_trace(log_dir)`` wraps ``torch.profiler`` around a block and
writes a Chrome trace (``trace.json``) into ``log_dir``: CPU activity, and
on a ``cuda`` run the CUDA activity too (kernels launched inside a
replayed CUDA graph included).  There is no fallback: a run with a CUDA
device asks for the CUDA activity and fails if the profiler cannot give
it.  Timings are host wall-clock: callers that time device work pass
``block=`` to ``Phases`` (or ``Recorder.span``).
"""

import contextlib
import os


class Phases:
    """Accumulates named wall-clock spans; repeated names accumulate.

    The underlying recorder is reachable as ``.recorder`` (export its
    spans with ``obs.export``).

    >>> ph = Phases()
    >>> with ph("parse"): mech = compile_gaschemistry(path)
    >>> with ph("solve", block=result.y): ...
    >>> ph.summary()   # {'parse': 0.12, 'solve': 3.4}
    """

    def __init__(self, recorder=None):
        from ..obs.recorder import Recorder

        self.recorder = recorder if recorder is not None else Recorder()

    @contextlib.contextmanager
    def __call__(self, name, block=None):
        with self.recorder.span(name, block=block):
            yield self

    @property
    def spans(self):
        return {k: v["total_s"] for k, v in self.recorder.by_name().items()}

    @property
    def counts(self):
        return {k: v["count"] for k, v in self.recorder.by_name().items()}

    def summary(self):
        return dict(self.spans)

    def pretty(self):
        return self.recorder.pretty()


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """``torch.profiler`` trace spanning the with-block, written as a
    Chrome trace to ``<log_dir>/trace.json`` (yields that path).
    ``device`` (default: CUDA when a GPU is available) adds the CUDA
    activity; the CPU activity is always on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace CUDA here "
                               "(no CUPTI); device_trace has no fallback")
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    path = os.path.join(str(log_dir), "trace.json")
    with profile(activities=acts) as prof:
        yield path
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
