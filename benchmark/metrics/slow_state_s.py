"""``slow_state_s``: how long the card stayed in its slow state after the
program's set-up, as the run waited it out (``core/settle.py``): the
seconds from the end of set-up until a graph of small kernels replays
within 3% of its speed before set-up.  Nothing on a CPU run."""

LAYER = "device"
SOURCE = "host_clock"
MOVES = "cond_per_s"


def read(obs, log):
    return obs.get("slow_state_s")
