"""``host_syncs_per_sweep``: the host's blocking reads of a device value
during the traced sweep, the graph/poll layer's own counter
(``solver/graphs.py`` ``COUNTS["host_syncs"]``, set to 0 before it)."""

LAYER = "graph/poll"
SOURCE = "program_counter"
MOVES = "cond_per_s"


def read(obs, log):
    counts = obs.get("counts")
    if not counts or "host_syncs" not in counts:
        return None
    return counts["host_syncs"]
