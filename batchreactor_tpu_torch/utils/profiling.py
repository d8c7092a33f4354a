"""Device tracing (``batchreactor_tpu/utils/profiling.py``).

``device_trace(log_dir)`` wraps ``torch.profiler`` around a block and
writes a Chrome trace (``trace.json``) into ``log_dir``: CPU activity, and
on a ``cuda`` run the CUDA activity too (kernels launched inside a
replayed CUDA graph included).  There is no fallback: a run with a CUDA
device asks for the CUDA activity and fails if the profiler cannot give
it.  The program's spans (``obs.recording``) appear in the trace as
``br:`` ranges.  Host phase timers are ``obs.Recorder`` spans.
"""

import contextlib
import os


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """``torch.profiler`` trace spanning the with-block, written as a
    Chrome trace to ``<log_dir>/trace.json`` (yields that path).
    ``device`` (``None`` means ``cuda``, which raises without a GPU, as
    every entry point of the port does) adds the CUDA activity;
    ``device="cpu"`` traces the host alone.  The CPU activity is always
    on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    device = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot trace CUDA here "
                               "(no CUPTI); device_trace has no fallback")
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    path = os.path.join(str(log_dir), "trace.json")
    with profile(activities=acts) as prof:
        yield path
        if device.type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
