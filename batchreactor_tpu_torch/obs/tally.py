"""The program's host-side work counters, and the tally of a CUDA graph
being captured.

:data:`COUNTS` holds what the program did since the counts were last set
to 0 (:func:`reset`).  Code that runs inside a captured graph step counts
with :func:`count`: during the capture the count goes to that graph's
tally (:func:`capturing`), and the graph layer (``solver/graphs.py``) adds
the tally on every replay (:func:`add_count`), so a count means work the
card did.  Inside ``obs.recording`` every increment also lands on the
current recorder under the names of :data:`RECORDER_NAMES`.

The graph layer, the kinetics and the kernel wrappers all count here, so
none of them imports another to count.
"""

import contextlib
import threading

from .recorder import current as current_recorder

#: the counters since they were last set to 0: ``replays`` (graph
#: replays), ``host_syncs`` (blocking reads of a device value by the
#: host), ``newton_iters`` (Newton iterations executed: a fixed-trip window
#: counts every iteration it runs, masked or not), the gas production-rate
#: evaluations by route (``ops/gas_kinetics.py``): ``rhs_fused`` (the
#: ``gas_wdot`` kernel) and ``rhs_plain`` (aten ops), and ``gas_wdot``, the
#: launches of that kernel (``ops/gas_rates_cuda.py``)
COUNTS = {"replays": 0, "host_syncs": 0, "newton_iters": 0, "rhs_fused": 0,
          "rhs_plain": 0, "gas_wdot": 0}

#: the recorder counter each :data:`COUNTS` key lands on inside
#: ``obs.recording`` (``host_syncs`` under the JAX package's name)
RECORDER_NAMES = {"host_syncs": "blocking_syncs", "replays": "graph_replays",
                  "newton_iters": "newton_iters_executed",
                  "rhs_fused": "rhs_fused", "rhs_plain": "rhs_plain",
                  "gas_wdot": "gas_wdot_launches"}

# guards COUNTS: the mesh's host threads replay and count at the same time
_LOCK = threading.Lock()
# the tally of the graph this thread is capturing (None outside a capture)
_tally = threading.local()


def add_count(name, k=1):
    """Add ``k`` to :data:`COUNTS` ``[name]`` (and to the recording
    recorder, if any)."""
    with _LOCK:
        COUNTS[name] += k
    rec = current_recorder()
    if rec is not None:
        rec.counter(RECORDER_NAMES[name], k)


def count(name, k=1):
    """Add ``k`` to counter ``name``; inside a capture the count goes to
    the graph's tally instead, and every replay adds it."""
    tally = getattr(_tally, "value", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + k
    else:
        add_count(name, k)


@contextlib.contextmanager
def capturing(tally):
    """Send this thread's :func:`count` calls to the dict ``tally`` for
    the block (a graph capture)."""
    prev = getattr(_tally, "value", None)
    _tally.value = tally
    try:
        yield tally
    finally:
        _tally.value = prev


def reset(*names):
    """Set the counters ``names`` of :data:`COUNTS` to 0, every counter
    where none is named."""
    with _LOCK:
        for k in names or COUNTS:
            COUNTS[k] = 0
