"""``newton_iters_per_sweep``: Newton iterations the step loop executed in
the traced sweep, masked ones included (a fixed-trip captured window runs
every iteration it holds): ``solver/graphs.py`` ``COUNTS["newton_iters"]``,
set to 0 before it."""

LAYER = "step loop"
SOURCE = "program_counter"
MOVES = "cond_per_s"


def read(obs, log):
    counts = obs.get("counts")
    if not counts or not counts.get("newton_iters"):
        return None
    return counts["newton_iters"]
