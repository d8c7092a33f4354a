"""Traffic kind ``sweep``: back-to-back ``batch_reactor_sweep`` calls, each
over a new batch of lanes drawn from the seed.

Set-up parses the configuration's mechanism on the device and warms up
with one sweep of the cell's own lane count over ``warmup_t1`` (the
captured programs are keyed by shape, not horizon, so the window captures
nothing).  On a GPU the run then waits for the card's steady speed
(``core/settle.py``): the wait is neither set-up nor window, and traced
runs report it as ``slow_state_s``.  The window runs whole sweeps: a sweep
starts only while the last one's wall says it ends inside
``--seconds``, and ``cond_per_s`` is
the lanes that ended in success over the time from the first sweep's start
to the last one's end.  With ``--trace 1`` one sweep runs under the device
trace instead, with the program's counters read around it.
"""

import time

import numpy as np

from benchmark.core import settle
from benchmark.core import trace as dtrace
from benchmark.core.traffic import draw, rng


def _program(ctx):
    import torch

    import batchreactor_tpu_torch as bt

    cfg, root = ctx["config"], ctx["root"]
    dev = torch.device(ctx["device"])
    f = {k: f"{root}/{v['path']}" for k, v in cfg["files"].items()}
    gm = bt.compile_gaschemistry(f["mech"], device=dev)
    th = bt.create_thermo(list(gm.species), f["therm"], device=dev)
    sm = (bt.compile_mech(f["surface"], th, list(gm.species), device=dev)
          if "surface" in f else None)
    mech = ({"gmd": gm, "smd": sm} if sm is not None else {"md": gm})
    chem = bt.Chemistry(gaschem=True, surfchem=sm is not None)
    solver = dict(cfg["solver"])
    marker = cfg.get("observe", {}).get("ignition_marker")
    species = list(gm.species)

    def sweep(lanes, t1):
        X = {s: lanes["X"][:, k] for k, s in enumerate(species)
             if lanes["X"][:, k].any()}
        return bt.batch_reactor_sweep(
            X, lanes["T"], ctx["traffic"]["p"], t1, chem=chem,
            thermo_obj=th, Asv=lanes["Asv"], ignition_marker=marker,
            device=dev, **mech, **solver)

    return torch, dev, species, sweep


def run(ctx, program=None):
    """One run of the cell (``program``: a :func:`_program` built before,
    reused across runs in one process)."""
    tr, log, seed = ctx["traffic"], ctx["log"], ctx["seed"]
    probe = None
    if program is None and ctx["device"].startswith("cuda"):
        import torch

        probe = settle.Probe(torch, torch.device(ctx["device"]))
        reference = probe.read()
    torch, dev, species, sweep = program or _program(ctx)
    from batchreactor_tpu_torch.solver import graphs
    from batchreactor_tpu_torch.solver import linalg_cuda as lc
    from batchreactor_tpu_torch.solver.common import SUCCESS

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def batch(i):
        return draw(tr["conditions"], species, rng(seed, 1, i))

    # ---- set-up: the cell's own shapes, once ----------------------------
    warm = sweep(batch(0), tr["warmup_t1"])
    sync()
    setup_s = time.perf_counter() - ctx["t_start"]
    log(f"sweep: set-up {setup_s:.3f} s (warm-up linsolve "
        f"{warm['linsolve']}, jac_window {warm['jac_window']})")
    # the wait is not set-up: it lasts 0-50 s at random, which would swing
    # setup_s's medians by a third (PERF.md section 2)
    waited = None
    if probe is not None:
        waited = settle.wait(probe, reference, log)
        del probe
    graphs.reset_counts()

    done, walls = [], []
    obs = brk = None
    t_first = time.perf_counter()
    if ctx["trace"]:
        lanes = batch(0)
        launches0 = dict(lc.LAUNCHES_BY_PATH)
        with dtrace.DeviceTrace(cuda) as trc:
            out = sweep(lanes, tr["t1"])
        counts = dict(graphs.COUNTS)
        res = trc.result
        obs = {"trace": res, "counts": counts,
               "launches": {k: v - launches0.get(k, 0)
                            for k, v in lc.LAUNCHES_BY_PATH.items()},
               "lanes": int(len(lanes["T"])),
               "width": len(species) + (0 if "covg" not in out
                                        else out["covg"].shape[1]),
               "linsolve": out["linsolve"], "slow_state_s": waited}
        brk = dtrace.breakdown(res)
        done.append((lanes, out))
        walls.append(res["window_s"])
        log(f"sweep: traced sweep {res['window_s']:.3f} s, busy "
            f"{res['busy_s']:.3f} s, {res['device_ops']} device ops read "
            f"in {res['reduce_s']:.1f} s, counts {counts}, launches "
            f"{obs['launches']}")
    else:
        i = 0
        while True:
            lanes = batch(i)
            t0 = time.perf_counter()
            out = sweep(lanes, tr["t1"])
            sync()
            t1 = time.perf_counter()
            done.append((lanes, out))
            walls.append(t1 - t0)
            i += 1
            if (t1 - t_first) + walls[-1] > ctx["seconds"]:
                break
    t_last = time.perf_counter()
    captured = graphs.captures()
    if captured:
        log(f"sweep: {captured} graphs captured inside the window")
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    sizes = [len(lanes["T"]) for lanes, _ in done]
    statuses = [np.asarray(o["status"]) for _, o in done]
    attempted = int(sum(sizes))
    answered = int(sum(s.size for s in statuses))
    ok_lanes = int(sum((s == SUCCESS).sum() for s in statuses))
    window = t_last - t_first
    log(f"sweep: {len(done)} sweeps of {sizes[0]} lanes in "
        f"{window:.3f} s: " + ", ".join(f"{w:.3f}" for w in walls))
    # the answers the comparison reads, on the host; the program's device
    # state is dropped before the reference runs
    answers = []
    for lanes, o in done:
        x = np.stack([np.asarray(o["x"][s]) for s in species], axis=1)
        answers.append((lanes, o["status"], x, o.get("tau"), o.get("covg")))
    del done, out, warm
    if cuda:
        torch.cuda.empty_cache()

    def lane(b, k):
        lanes, status, x, tau, covg = answers[b]
        if k >= len(status):       # a lane the program never answered
            return {"T": float(lanes["T"][k]), "Asv": float(lanes["Asv"][k]),
                    "X": lanes["X"][k],
                    "got": {"status_ok": False, "x": np.full(x.shape[1],
                                                             np.nan)}}
        got = {"status_ok": bool(status[k] == SUCCESS), "x": x[k]}
        if tau is not None:
            got["tau"] = float(tau[k])
        if covg is not None:
            got["covg"] = np.asarray(covg[k])
        return {"T": float(lanes["T"][k]), "Asv": float(lanes["Asv"][k]),
                "X": lanes["X"][k], "got": got}

    return {
        "metrics": {"cond_per_s": ok_lanes / window, "setup_s": setup_s},
        "obs": obs, "breakdown": brk,
        "attempted": attempted, "answered": answered,
        "failed": attempted - ok_lanes,
        "batch_sizes": sizes, "lane": lane,
        "p": tr["p"], "t1": tr["t1"],
        "device": device_info(torch, dev, ctx["cell"]["chips"], peak),
    }


def device_info(torch, dev, chips, peak):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(chips), "memory_peak_bytes": peak}
