"""``BENCHMARK.json`` against the contract the harness is held to, and the
files it names.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.core import spec

M = spec.load_manifest()
BENCH = spec.BENCH_DIR
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "batchreactor_tpu"}


def test_top_level_keys_and_command():
    assert set(M) == KEYS
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert spec.NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert spec.UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    v = e[key]
                    assert 1 <= len(v) <= 200 and "\n" not in v \
                        and "\t" not in v
    for w in M["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len(names) == len(set(names))
    assert len(json.dumps(M)) < 64 * 1024


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in M["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_what_it_must():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in M["workloads"]:
        run = spec.resolve(w["name"])
        got = {e["name"] for e in run["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert run["per_layer"], w["name"]
        for p in run["per_layer"]:
            assert p["moves"] in got, (w["name"], p["name"])
    for p in M["per_layer"]:
        assert p["moves"] in e2e
        for cell in p.get("workloads", []):
            assert cell in {w["name"] for w in M["workloads"]}


def test_every_name_resolves_to_its_files():
    cells = M["workloads"]
    for c in M["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert conf["source"] == c["source"] and conf["reduced"] == \
            c["reduced"] == []
        spec.verify_files(conf)
        assert any(w["config"] == c["name"] for w in cells)
    for w in cells:
        run = spec.resolve(w["name"])
        assert os.path.exists(os.path.join(
            BENCH, "drivers", run["traffic"]["kind"] + ".py"))
    for p in M["per_layer"]:
        mod = spec.metric_reader(p["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES) == (
            p["layer"], p["source"], p["moves"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
             if f.endswith(".py")]
    assert files
    for path in files:
        bad = set(imported_tops(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(imported_tops(os.path.join(ref, f)))
            assert not tops & (FORBIDDEN | {"batchreactor_tpu_torch",
                                            "torch"}), f


def test_without_a_cuda_device_the_run_fails_and_prints_nothing():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        M["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
