"""File-mtime heartbeats: THE liveness convention of the shared-dir tiers.

One process's liveness signal is one file it touches every
``interval_s``; a reader calls the file's age against a ``dead_after_s``
threshold.  That is deliberately the weakest coordination primitive
that works on a shared filesystem — no sockets, no gossip, no extra
daemon.  Its reader here is the elastic multihost sweep
(``parallel/multihost.py``): a chunk whose claim owner stops heartbeating
is reassigned to a survivor.  Port of
``batchreactor_tpu/resilience/heartbeat.py``; stdlib-only, so liveness
reading works on a host whose devices are wedged.

Semantics are conservative by construction: a missed beat (ENOSPC, NFS
hiccup) reads as *slow*, not dead-forever — the next successful beat
resurrects the process; and :func:`file_age` returning ``None`` (file
missing) is "never registered", distinct from "stale".
"""

import os
import threading
import time


class Heartbeat(threading.Thread):
    """Daemon thread touching ``path`` every ``interval_s`` — the
    liveness signal :func:`file_age` / ``host_liveness`` readers call
    against their staleness threshold.  ``on_beat`` (optional) runs
    after each successful touch on the heartbeat thread and must never
    raise (exceptions are swallowed like a missed beat: a telemetry
    fault must not read as a dead process)."""

    def __init__(self, path, interval_s, on_beat=None, name=None):
        super().__init__(daemon=True,
                         name=name or "br-heartbeat")
        self.path = path
        self.interval_s = float(interval_s)
        self.on_beat = on_beat
        # not ``_stop``: that name is Thread's own, which join() calls
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            self.beat()
            self._halt.wait(self.interval_s)

    def beat(self):
        """One touch (also callable inline, e.g. before the thread
        starts, so a reader never sees a registered-but-beatless
        window)."""
        try:
            with open(self.path, "w") as f:
                f.write(str(time.time()))
        except OSError:
            return   # a missed beat reads as slow, not dead-forever
        if self.on_beat is not None:
            try:
                self.on_beat()
            except Exception:  # noqa: BLE001 — telemetry faults must
                pass           # not read as a dead process

    def stop(self):
        self._halt.set()


def file_age(path, now=None):
    """Seconds since ``path`` was last touched, or ``None`` when it
    does not exist (never registered — distinct from stale)."""
    try:
        return (time.time() if now is None else now) \
            - os.path.getmtime(path)
    except OSError:
        return None


def is_alive(path, dead_after_s, now=None):
    """True when the heartbeat at ``path`` is younger than
    ``dead_after_s`` (missing file = not alive)."""
    age = file_age(path, now=now)
    return age is not None and age <= float(dead_after_s)
