"""The ``rhs_fused_share`` reader on the counts a traced run hands it.

    python -m pytest benchmark/tests -q
"""

import pytest

from benchmark.core import spec


@pytest.fixture(scope="module")
def reader():
    return spec.metric_reader("rhs_fused_share")


def obs(counts, device_ops=1000):
    return {"counts": counts, "trace": {"device_ops": device_ops}}


def test_only_fused_evaluations_read_100(reader):
    got = reader.read(obs({"replays": 56, "rhs_fused": 2496,
                           "rhs_plain": 0}), lambda m: None)
    assert got == 100.0


def test_mixed_evaluations_read_their_share(reader):
    got = reader.read(obs({"rhs_fused": 30, "rhs_plain": 10}),
                      lambda m: None)
    assert got == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["parent", "cpu", "none"])
def test_nothing_to_read(reader, case):
    """A program without the counters (the parent), a CPU run (no device
    operation: the plain rates are the only route there) and a sweep that
    evaluated no gas RHS read nothing."""
    counts = {"replays": 56, "host_syncs": 55, "newton_iters": 2496}
    if case == "cpu":
        o = obs(dict(counts, rhs_fused=0, rhs_plain=40), device_ops=0)
    elif case == "none":
        o = obs(dict(counts, rhs_fused=0, rhs_plain=0))
    else:
        o = obs(counts)
    assert reader.read(o, lambda m: None) is None
