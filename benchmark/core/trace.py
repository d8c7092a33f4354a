"""Device trace of a block: ``torch.profiler`` (CUPTI) activity, reduced in
the benchmark's own code.

The reduction reads the profiler's raw event list and never asks the
profiler for its own summaries: a captured window of the port replays some
hundred thousand kernels per sweep, and building the profiler's per-event
Python objects for that many takes minutes.  What it computes:

* ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills; device-side annotations are spans, not work) inside the
  window - the idle share is 1 - busy / window, the arithmetic of
  ``chip_smoke.py::profile_main_path`` on intervals instead of a sum;
* ``kernels``: device seconds and launches by kernel name;
* ``gaps``: the device's idle gaps inside the window, each labelled by the
  innermost host operation or range that was running at its middle.
"""

import time


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(ev, what + "_us")() * 1000


def _device_op(ev):
    """Whether a device event is an operation (kernel, copy, fill) and not
    a device-side annotation span.  Older PyTorch builds have no
    ``activity_type`` on their events; there the annotation flag, and the
    benchmark's own range name, tell them apart."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        return ("annotation" not in kind
                and any(k in kind for k in ("kernel", "memcpy", "memset")))
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None and flag():
        return False
    return not ev.name().startswith("bench:")


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` traces the block on the current CUDA
    device; after it, ``tr.result`` holds the reduction (module doc).
    ``cuda=False`` traces the host alone (a CPU rehearsal: no device
    operation, so no busy time)."""

    def __init__(self, cuda=True):
        self.cuda = cuda

    def _sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._torch = torch
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        self._range = record_function("bench:window")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch = self._torch
        self._sync()
        self._range.__exit__(None, None, None)
        wall = time.perf_counter() - self._t0
        # the raw result, without the profiler's own post-processing
        res = torch._C._autograd._disable_profiler()
        self._prof = None
        if exc[0] is None:
            t0 = time.perf_counter()
            self.result = reduce_events(res.events(), wall)
            self.result["reduce_s"] = time.perf_counter() - t0
        return False


def reduce_events(events, wall_s, n_gaps=10):
    import torch

    cuda = torch._C._autograd.DeviceType.CUDA
    dev, host = [], []
    w0 = w1 = None
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            if _device_op(ev):
                s = _ns(ev, "start")
                dev.append((s, s + ev.duration_ns(), name))
        else:
            s = _ns(ev, "start")
            e = s + ev.duration_ns()
            if name == "bench:window":
                w0, w1 = s, e
            else:
                host.append((s, e, name))
    if w0 is None:
        w0 = min((d[0] for d in dev), default=0)
        w1 = w0 + int(wall_s * 1e9)
    kernels = {}
    for s, e, name in dev:
        t, c = kernels.get(name, (0.0, 0))
        kernels[name] = (t + (e - s) * 1e-9, c + 1)
    dev.sort()
    merged = []
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda h: h[1] - h[0])
    labelled = []
    for s, e in gaps[:n_gaps]:
        mid = (s + e) // 2
        label = next((name for hs, he, name in host if hs <= mid <= he),
                     "host outside any traced operation")
        labelled.append((label, (e - s) * 1e-9))
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": kernels, "gaps": labelled,
            "device_ops": len(dev)}


def breakdown(result, n=10):
    """The ``breakdown`` of a traced run's result line."""
    top = sorted(result["kernels"].items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[name, t] for name, (t, _) in top],
            "idle_gaps": [[label, s] for label, s in result["gaps"][:n]]}
