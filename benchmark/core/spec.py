"""``BENCHMARK.json`` and the files it names, resolved for one cell.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own that the harness finds by name:

* ``configs[*].file`` - the configuration: mechanism files with their
  sha256, solver settings, the limits of the comparison (``correct``);
* ``benchmark/traffic/<traffic>.json`` - the traffic mix: its ``kind``
  (the driver ``benchmark/drivers/<kind>.py`` that runs it) and its
  parameters;
* ``benchmark/metrics/<metric>.py`` - one reader per per-layer metric.

A later cell or metric is added by adding such files and entries.
"""

import hashlib
import importlib
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(path=None):
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric, cell, e2e_names):
    """Whether a metric is reported in ``cell`` (a workloads entry): its
    ``workloads`` list, or, without one, every cell that reports the
    end-to-end metric it moves (end-to-end metrics: every cell)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def verify_files(config, root=ROOT):
    """Refuse to run when a mechanism file differs from the one the
    configuration was measured with."""
    for key, ent in config["files"].items():
        path = os.path.join(root, ent["path"])
        with open(path, "rb") as fh:
            got = hashlib.sha256(fh.read()).hexdigest()
        if got != ent["sha256"]:
            raise RuntimeError(f"{key} file {ent['path']} has sha256 {got}, "
                               f"the configuration was measured with "
                               f"{ent['sha256']}")


def resolve(workload, manifest=None, root=ROOT):
    """Everything one run of ``workload`` needs, by name."""
    m = manifest if manifest is not None else load_manifest()
    cell = _by_name(m["workloads"], workload, "workload")
    conf_entry = _by_name(m["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     cell["traffic"] + ".json"))
    e2e = [e for e in m["end_to_end"] if applies(e, cell, ())]
    e2e_names = {e["name"] for e in e2e}
    per_layer = [p for p in m["per_layer"] if applies(p, cell, e2e_names)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": m["run_seconds"], "root": root}


def driver(kind):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name):
    """The reader module ``benchmark/metrics/<name>.py`` (loaded by path: a
    metric's name may hold ``.`` or ``-``)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
