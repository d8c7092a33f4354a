"""The program's own spans over one run of a cell: where ``setup_s`` goes,
and each sweep's device time outside its graph replays.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> \\
        [--trace <0|1>]

One fresh process runs the cell through ``core/runner.py`` as
``benchmark/run.py`` does (the same set-up, settle wait, window and
comparison), with an ``obs.Recorder`` entered as the thread's current
recorder (``obs.recording``) before the program is set up.  The program
then records its own spans: ``parse`` (``what``: gas, thermo, surface),
``lib_load``, ``program_build``, ``capture`` (``step``, ``B``) and, per
``batch_reactor_sweep`` call, a ``sweep`` span with the driver's ``prep``,
``segment``/``poll`` and ``finish`` under it, and on the card the sweep's
device window (``sweep_device_window_s``, from its entry to its final
fetch) and its replays' device time (``replay_device_s``), both from CUDA
events.  A replay is timed from just before its launch, so the window's
share outside replays is a lower bound on the card's idle share.

Standard error gets the set-up tree: the imports and the CUDA
initialisation timed here, each of the program's top-level spans up to the
end of the warm-up sweep with the spans under it summed by path, and the
part of ``setup_s`` that none of them covers (the settle probe, the
harness); then each timed sweep's wall, device window and share of the
window outside replays.  The last line on standard output is run.py's result with a ``spans`` entry.  A run under the
recorder is not a run of the benchmark: none of this is a metric of
``BENCHMARK.json``.
"""

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _top(spans):
    return sorted((s for s in spans if s["depth"] == 0
                   and s["dur"] is not None), key=lambda s: s["seq"])


def setup_tree(spans, setup_s=None, before=()):
    """Set-up as stages: ``before`` (``(name, seconds)`` timed outside the
    recorder), then every top-level span up to the first ``sweep`` (the
    warm-up) with the spans under it summed by path, and ``uncovered_s``,
    the part of ``setup_s`` no stage covers (None without ``setup_s``).
    None when no sweep was recorded."""
    top = _top(spans)
    first = next((s for s in top if s["name"] == "sweep"), None)
    if first is None:
        return None
    bounds = [s["seq"] for s in top] + [float("inf")]
    stages = [{"name": name, "s": sec} for name, sec in before]
    for i, s in enumerate(top):
        if s["seq"] > first["seq"]:
            break
        nested = {}
        for c in spans:
            if c["depth"] and c["dur"] is not None \
                    and bounds[i] < c["seq"] < bounds[i + 1]:
                t, n = nested.get(c["path"], (0.0, 0))
                nested[c["path"]] = (t + c["dur"], n + 1)
        stages.append({"name": s["name"], "attrs": s["attrs"], "s": s["dur"],
                       "nested": {k: list(v) for k, v in nested.items()}})
    covered = sum(st["s"] for st in stages)
    return {"stages": stages, "covered_s": covered,
            "uncovered_s": None if setup_s is None else setup_s - covered}


def nested_total(tree, leaf):
    """Seconds and count of the set-up spans named ``leaf`` at any depth
    (``capture``, ``parse``, ``lib_load``, ``program_build``)."""
    t = n = 0
    for st in tree["stages"]:
        if st["name"] == leaf:
            t, n = t + st["s"], n + 1
        for path, (dt, dn) in st.get("nested", {}).items():
            if path.rsplit("/", 1)[-1] == leaf:
                t, n = t + dt, n + dn
    return t, n


def timed_sweeps(spans):
    """Each ``sweep`` span after the warm-up: its wall and, on the card,
    its device window, the replays' device time and the share of the
    window outside replays (%)."""
    out = []
    for s in [s for s in _top(spans) if s["name"] == "sweep"][1:]:
        w = s["attrs"].get("sweep_device_window_s")
        r = s["attrs"].get("replay_device_s")
        out.append({"wall_s": s["dur"], "window_s": w, "replay_s": r,
                    "outside_pct": None if not w else 100.0 * (1 - r / w)})
    return out


def gap_share(sweeps):
    """100 x (1 - replays / window) over every timed sweep read on the
    card, or None."""
    read = [s for s in sweeps if s["window_s"]]
    if not read:
        return None
    return 100.0 * (1.0 - sum(s["replay_s"] for s in read)
                    / sum(s["window_s"] for s in read))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def report(tree, sweeps, setup_s):
    """The set-up tree and the sweeps' readings as lines."""
    lines = []
    if tree is not None:
        head = "" if setup_s is None else f" of setup_s {setup_s:.3f} s"
        lines.append(f"spans: set-up stages{head}")
        for st in tree["stages"]:
            what = st.get("attrs", {}).get("what")
            lines.append(f"  {st['name'] + (' ' + what if what else ''):<16}"
                         f" {st['s']:9.3f} s")
            for path, (t, n) in sorted(st.get("nested", {}).items()):
                lines.append(f"      {path:<40} {t:9.3f} s  x{n}")
        if tree["uncovered_s"] is not None:
            lines.append(f"  {'uncovered':<16} {tree['uncovered_s']:9.3f} s"
                         f"  (the settle probe, the harness)")
    for i, s in enumerate(sweeps):
        dev = ("" if s["window_s"] is None else
               f", device window {s['window_s']:.4f} s, replays "
               f"{s['replay_s']:.4f} s, outside replays "
               f"{s['outside_pct']:.3f}%")
        lines.append(f"spans: sweep {i}: wall {s['wall_s']:.4f} s{dev}")
    share = gap_share(sweeps)
    if share is not None:
        lines.append(f"spans: outside replays {share:.3f}% of the device "
                     f"windows of {len(sweeps)} sweeps")
    return lines


def main(argv, t_start=None, manifest=None, root=None, device=None):
    """One run of a cell under the program's recorder (module doc); the
    arguments are run.py's, and ``manifest``, ``root`` and ``device`` let
    a test drive it on the CPU as ``core/runner.py``'s do."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from batchreactor_tpu_torch import obs
    from benchmark.core import runner, spec

    before = [("imports", time.perf_counter() - t_start)]
    if device is None and torch.cuda.is_available():
        t0 = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device="cuda:0")
        torch.cuda.synchronize()
        before.append(("cuda_init", time.perf_counter() - t0))

    rec = obs.Recorder()
    out = io.StringIO()
    with obs.recording(rec), contextlib.redirect_stdout(out):
        rc = runner.main(argv, t_start=t_start, manifest=manifest,
                         root=root or spec.ROOT, device=device)
    if rc != 0:
        return rc
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    setup = result["metrics"].get("setup_s")
    setup_s = None if setup is None else setup["value"]
    tree = setup_tree(rec.spans, setup_s, before)
    sweeps = timed_sweeps(rec.spans)
    for line in report(tree, sweeps, setup_s):
        _log(line)
    result["spans"] = {"setup": tree, "sweeps": sweeps,
                       "outside_replays_pct": gap_share(sweeps),
                       "capture_s": None if tree is None else
                       nested_total(tree, "capture")[0],
                       "parse_s": None if tree is None else
                       nested_total(tree, "parse")[0],
                       "counters": dict(rec.counters)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:], t_start=T_START))
