"""Set-up's last step on a GPU: wait until the card runs short kernels as
fast as it did before the program's set-up.

On the H100 machines this benchmark runs on, the program's first sweep
(its graph captures and first allocations) leaves the card running every
kernel slower for a while: a graph of 2 000 small elementwise kernels
replays at 1.63-1.64 us a kernel instead of 1.45-1.46, at the same clocks,
for some 10 to 60 s whether the card works or idles, and then drops back
at once.  A coupled sweep runs 12% slower in that state, a 4096-lane map
sweep 5.7%.  The run waits it out after set-up, so the window measures
the card's steady speed; the wait, 0-50 s after set-up at random, is not
counted in ``setup_s`` (it would swing its medians by a third) and is
reported by the ``slow_state_s`` metric.

The reference speed is read before the program touches the card, by
:class:`Probe`, its own small graph.
"""

import time

#: a reading within this factor of the reference is the steady speed
RATIO = 1.03
#: the longest wait, in seconds
MAX_S = 90.0


class Probe:
    """A captured graph of 2000 small float64 kernels on ``device``;
    :meth:`read` times it with CUDA events."""

    def __init__(self, torch, device, n=1000, width=1024 * 66):
        self.torch = torch
        x = torch.zeros(width, dtype=torch.float64, device=device)
        y = torch.ones(width, dtype=torch.float64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            x.mul_(y).add_(y)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(n):
                x.mul_(y).add_(y)
        self.kernels = 2 * n
        self.buffers = (x, y)
        self.read()

    def read(self, reps=10, tries=3):
        """Microseconds per kernel: the least of ``tries`` timings of
        ``reps`` replays."""
        cuda = self.torch.cuda
        best = float("inf")
        for _ in range(tries):
            a = cuda.Event(enable_timing=True)
            b = cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                self.graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) * 1e3 / (reps * self.kernels))
        return best


def wait(probe, reference, log, max_s=MAX_S, poll_s=0.5):
    """Wait until ``probe`` reads within :data:`RATIO` of ``reference``, at
    most ``max_s`` seconds; returns the seconds waited."""
    t0 = time.perf_counter()
    first = last = probe.read()
    while last > RATIO * reference and time.perf_counter() - t0 < max_s:
        time.sleep(poll_s)
        last = probe.read()
    waited = time.perf_counter() - t0
    steady = last <= RATIO * reference
    log(f"settle: {reference:.4f} us/kernel before set-up, {first:.4f} "
        f"after, {last:.4f} after {waited:.1f} s"
        + ("" if steady else f": not steady within {max_s} s"))
    return waited
