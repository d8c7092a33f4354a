"""One run of one cell: the flow behind ``benchmark/run.py``.

1. Resolve the cell from ``BENCHMARK.json`` and refuse to run without the
   CUDA devices it asks for, or with a mechanism file that changed.
2. The traffic's driver (``benchmark/drivers/<kind>.py``) sets up the
   program, warms up the cell's shapes, then measures for ``--seconds``
   (``--trace 0``: the cell's end-to-end metrics) or traces one sweep
   (``--trace 1``: its per-layer metrics); it hands back what the timed
   path answered.
3. Once the window has closed and the device's peak memory is read, lanes
   drawn from the seed are judged against the plain reference
   (``core/judge.py``).
4. The result: each compared number beside its limit as the last lines on
   standard error, then one JSON line last on standard output.
"""

import argparse
import json
import os
import sys
import time

from benchmark.core import judge, spec
from benchmark.core.traffic import rng

#: modules that may not be loaded in a run (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "batchreactor_tpu")


def cache_dirs(root):
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the ``lu32p`` library already builds under
    ``build/kernels``)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cuda_devices(need):
    """The CUDA device count, or an error message when under ``need``."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: this benchmark measures the port on the GPU"
    n = torch.cuda.device_count()
    if n < need:
        return f"{n} CUDA device(s), the cell needs {need}"
    return None


def main(argv, t_start=None, manifest=None, root=spec.ROOT, device=None):
    """Run one cell; returns the exit code.  ``manifest``, ``root`` and
    ``device`` let a test drive a run on the CPU (``device="cpu"`` skips the
    look for a GPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cache_dirs(root)
    run = spec.resolve(args.workload, manifest, root)
    cell = run["cell"]
    if device is None:
        err = cuda_devices(int(cell["chips"]))
        if err:
            log(f"benchmark: {err}")
            return 3
        device = "cuda:0"
    spec.verify_files(run["config"], root)
    drv = spec.driver(run["traffic"]["kind"])
    ctx = {"seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "device": device, "t_start": t_start,
           "log": log, **run}
    out = drv.run(ctx)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: forbidden modules loaded in this process: {bad}")
        return 4

    # ---- the comparison, after the window and the memory reading --------
    correct_spec = run["config"]["correct"]
    gen = rng(args.seed, 7)
    picks = judge.draw_lanes(out["batch_sizes"], int(correct_spec["lanes"]),
                             gen)
    lanes = [out["lane"](b, i) for b, i in picks]
    t0 = time.perf_counter()
    ok, compared = judge.compare(run["config"], root, lanes, out["p"],
                                 out["t1"], log=log)
    log(f"benchmark: reference over {len(lanes)} lanes took "
        f"{time.perf_counter() - t0:.1f} s")
    complete = out["answered"] == out["attempted"]
    if not complete:
        log(f"benchmark: {out['attempted'] - out['answered']} of "
            f"{out['attempted']} never answered")
    correct = bool(ok and complete)

    metrics = {}
    wanted = run["per_layer"] if ctx["trace"] else run["end_to_end"]
    for m in wanted:
        name = m["name"]
        if ctx["trace"]:
            value = spec.metric_reader(name).read(out["obs"], log)
        else:
            value = out["metrics"].get(name)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": out["device"]}
    if ctx["trace"]:
        tr = out["obs"]["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = out["breakdown"]
    result["compared"] = {k: [v["value"], v["limit"]]
                          for k, v in compared.items()}
    for k, v in compared.items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
