"""``benchmark/spans.py``: the program's spans over a run of a cell, on the
CPU at the harness tests' tiny size, and its reading of the sweeps.

    python -m pytest benchmark/tests -q
"""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")

from benchmark import spans  # noqa: E402
from benchmark.tests.test_benchmark_harness import tiny  # noqa: E402,F401


def run_spans(tiny, seed, trace=0):  # noqa: F811
    root, manifest = tiny
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = spans.main(["--workload", "tiny", "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        manifest=manifest, root=root, device="cpu")
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_set_up_stages_account_for_setup_s(tiny):  # noqa: F811
    res, err = run_spans(tiny, 2 ** 31 + 5)
    assert res["correct"], err[-2000:]
    sp = res["spans"]
    stages = sp["setup"]["stages"]
    assert [(s["name"], s.get("attrs", {}).get("what")) for s in stages] == [
        ("imports", None), ("parse", "gas"), ("parse", "thermo"),
        ("sweep", None)]
    warm = stages[-1]["nested"]
    assert {"sweep/prep", "sweep/prep/program_build", "sweep/segment",
            "sweep/finish"} <= set(warm)
    setup_s = res["metrics"]["setup_s"]["value"]
    assert sp["setup"]["uncovered_s"] >= 0.0
    assert sp["setup"]["covered_s"] + sp["setup"]["uncovered_s"] == \
        pytest.approx(setup_s, rel=1e-12)
    assert sp["parse_s"] > 0.0 and sp["capture_s"] == 0.0
    # on the CPU no device window: walls only
    assert sp["sweeps"] and all(s["window_s"] is None for s in sp["sweeps"])
    assert sp["outside_replays_pct"] is None
    assert "spans: set-up stages of setup_s" in err
    assert sp["counters"]["blocking_syncs"] > 0


def test_traced_run_records_its_timed_sweep(tiny):  # noqa: F811
    res, err = run_spans(tiny, 11, trace=1)
    assert res["correct"], err[-2000:]
    sp = res["spans"]
    assert sp["setup"]["uncovered_s"] is None and len(sp["sweeps"]) == 1
    assert sp["parse_s"] > 0.0 and "gaps" not in sp


def test_sweep_readings_and_the_share_outside_replays():
    mk = [{"name": "sweep", "depth": 0, "seq": i, "dur": 1.0, "path": "sweep",
           "attrs": a} for i, a in enumerate(
               [{}, {"sweep_device_window_s": 2.0, "replay_device_s": 1.9},
                {"sweep_device_window_s": 2.0, "replay_device_s": 1.7}])]
    sw = spans.timed_sweeps(mk)
    assert [s["outside_pct"] for s in sw] == pytest.approx([5.0, 15.0])
    assert spans.gap_share(sw) == pytest.approx(10.0)
    assert spans.gap_share(spans.timed_sweeps(mk[:1])) is None
