"""The controls of the comparison that decides ``correct``: runs that hold
less than the configuration states, judged by the same comparison as a run
of the cell (``core/judge.py::compare``) on the lanes a run of the seed
draws.  A sound comparison rejects them.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--jobs 8]

is the plain reference, put in the program's place and computed in
float32 (one precision below the configuration's float64) at the cell's
tolerances; it runs on the host's CPU cores, needs no GPU and does not
import the program.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        --program exp32 [--sound-seeds 4 5 6 ...] [--jobs 8]

runs on the card: the program itself with a lower-precision path of its
own switched on (``exp32``: float32 rate exponentials), one sweep of the
cell's own lanes per seed, and with ``--sound-seeds`` the program as the
configuration states on those seeds, in the same process (one set-up).

Prints, per seed, each compared number beside its limit and whether the
run passed, then one JSON line; exits 1 when a control passed.
"""

import argparse
import copy
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark.core import judge, spec  # noqa: E402
from benchmark.core.traffic import draw, rng  # noqa: E402
from benchmark.reference import solve  # noqa: E402


def lanes_of(run, seed):
    """The lanes a run of seed ``seed`` draws for its comparison, from a
    batch of the cell's size drawn as its first sweep is."""
    ref = judge.Reference(run["config"], run["root"])
    lanes = draw(run["traffic"]["conditions"], ref.gas.species,
                 rng(seed, 1, 0))
    picks = judge.draw_lanes([len(lanes["T"])],
                             int(run["config"]["correct"]["lanes"]),
                             rng(seed, 7))
    return [{"T": float(lanes["T"][k]), "Asv": float(lanes["Asv"][k]),
             "X": lanes["X"][k]} for _, k in picks]


def float32_answer(config, root, lane, p, t1):
    """The reference in float32 at the cell's tolerances: the answer that
    takes the program's place."""
    low = judge.Reference(config, root, dtype=np.float32)
    c = solve.solve_lane(low.reactor, lane["T"], lane["Asv"],
                         low.y0(lane, p), t1, config["solver"]["rtol"],
                         config["solver"]["atol"], marker=low.marker)
    got = {"status_ok": c["ok"],
           "x": solve.mole_fractions(np.asarray(c["y"][:low.ng], float),
                                     low.gas.thermo.molwt)}
    if low.marker is not None:
        got["tau"] = c["tau"]
    if low.surface is not None:
        got["covg"] = np.asarray(c["y"][low.ng:], float)
    return got


def _judge(task):
    """One seed's comparison: ``task`` is (config, root, lanes, p, t1,
    float32 control or not)."""
    config, root, lanes, p, t1, low = task
    answers = ([float32_answer(config, root, lane, p, t1) for lane in lanes]
               if low else None)
    return judge.compare(config, root, lanes, p, t1, answers=answers)


def _judge_all(tasks, jobs):
    if jobs <= 1:
        return [_judge(t) for t in tasks]
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(jobs, len(tasks)), mp_context=ctx) as ex:
        return list(ex.map(_judge, tasks))


def control(workload, seeds, jobs=1, manifest=None, root=spec.ROOT):
    """The float32 reference in the program's place: ``{seed: (passed,
    {name: {"value", "limit"}})}``."""
    run = spec.resolve(workload, manifest, root)
    tr = run["traffic"]
    tasks = [(run["config"], root, lanes_of(run, s), tr["p"], tr["t1"], True)
             for s in seeds]
    return dict(zip(seeds, _judge_all(tasks, jobs)))


def program_runs(workload, plan, jobs=1, manifest=None, root=spec.ROOT,
                 device=None, log=print):
    """The program on the card, one sweep of the cell's own lanes per entry
    of ``plan`` (``(seed, solver options set over the configuration's)``),
    each judged on the lanes a run of the seed draws: ``[(passed,
    compared)]`` in the plan's order."""
    run = spec.resolve(workload, manifest, root)
    drv = spec.driver(run["traffic"]["kind"])
    if device is None:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("the program's control runs on a CUDA device")
        device = "cuda:0"
    k = int(run["config"]["correct"]["lanes"])
    tasks, programs = [], {}
    for seed, options in plan:
        config = copy.deepcopy(run["config"])
        config["solver"].update(options)
        ctx = dict(run, config=config, seed=seed, seconds=0.0, trace=False,
                   device=device, t_start=time.perf_counter(),
                   log=lambda m: None)
        key = json.dumps(options, sort_keys=True)
        if key not in programs:
            programs[key] = drv._program(ctx)
        out = drv.run(ctx, programs[key])
        picks = judge.draw_lanes(out["batch_sizes"], k, rng(seed, 7))
        lanes = [out["lane"](b, i) for b, i in picks]
        log(f"program seed {seed} {options}: one sweep, "
            f"{out['failed']} of {out['attempted']} lanes failed")
        tasks.append((config, root, lanes, out["p"], out["t1"], False))
        del out
    return _judge_all(tasks, jobs)


def _line(label, seed, passed, nums):
    return (f"{label} seed {seed}: " + ", ".join(
        f"{k} {v['value']!r} (limit {v['limit']!r})" for k, v in nums.items())
        + f" -> {'passed' if passed else 'not correct'}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", choices=("exp32",),
                   help="the program with this lower-precision path of its "
                        "own switched on, on the card")
    p.add_argument("--sound-seeds", type=int, nargs="*", default=[],
                   help="with --program: the program as configured, too")
    p.add_argument("--jobs", type=int, default=1)
    a = p.parse_args(argv)
    readings = {"control": {}, "sound": {}}
    if a.program:
        plan = ([(s, {a.program: True}) for s in a.seeds]
                + [(s, {}) for s in a.sound_seeds])
        got = program_runs(a.workload, plan, a.jobs)
        rows = [("control" if i < len(a.seeds) else "sound", s, r)
                for i, ((s, _), r) in enumerate(zip(plan, got))]
    else:
        rows = [("control", s, r) for s, r in
                control(a.workload, a.seeds, a.jobs).items()]
    passed = False
    for label, s, (ok, nums) in rows:
        print(_line(label, s, ok, nums), flush=True)
        readings[label][str(s)] = {k: v["value"] for k, v in nums.items()}
        passed |= label == "control" and ok
    print(json.dumps({"workload": a.workload,
                      "control": a.program or "float32 reference",
                      "control_passed": passed, "readings": readings}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
