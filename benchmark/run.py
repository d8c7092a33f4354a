"""The benchmark of ``batchreactor_tpu_torch`` on one or more NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  One run is one fresh process: it sets up
the cell named in ``BENCHMARK.json`` (configuration, traffic, metrics),
warms up the cell's own shapes, measures for ``--seconds`` (``--trace 1``:
one traced sweep instead, for the per-layer metrics), checks what
the timed path produced against the plain reference under
``benchmark/reference/``, and prints one JSON line last on standard output.
Without a CUDA device it exits non-zero and prints no result.
"""

import time

# set-up is timed from here: the interpreter's own start (a few tens of
# milliseconds) is the only part of the process it leaves out
T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark.core.runner import main
    sys.exit(main(sys.argv[1:], t_start=T_START))
