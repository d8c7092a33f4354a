"""Wedge watchdog: deadline-bounded blocking device waits
(``batchreactor_tpu/resilience/watchdog.py``).

A blocking device-to-host wait that never returns is invisible to the
host until an operator kills the process.  This module bounds such a wait
with a wall-clock deadline: the wait records a CUDA event behind the work
it waits for and polls ``event.query()`` until the event completes or the
deadline passes.  On a breach it

1. marks the devices involved *suspect* (:func:`mark_suspect`, a
   process-wide registry a driver can consult before dispatching more
   work), and
2. raises :class:`WedgeError`, so the retry layer
   (``parallel.checkpoint.checkpointed_sweep(retry=...)``) can reset and
   re-solve instead of the whole process hanging with the card.

Polling needs no watchdog thread: nothing is left waiting after a breach.
On the CPU the work is done when the call returns, so a guarded wait only
applies the fault injector's delay.

A wedged CUDA context cannot be revived in-process.  :func:`reset_backend`
drops the captured programs and the caching allocator's free blocks, which
is all a transient stall needs; a device that stays wedged fails every
retry, and the cure is process-level: :func:`terminate_self`,
``guard.run_guarded``, or the elastic tier's survivors taking over the
dead process's chunks.

Deadlines are off by default (``None``): :func:`resolve_fetch_deadline` is
the resolution rule (an explicit value passes through validated, ``None``
resolves from ``BR_FETCH_DEADLINE_S``; unset, empty or <= 0 means no
watchdog, and then no event, poll or thread is added anywhere)."""

import os
import signal
import threading
import time


class WedgeError(RuntimeError):
    """A blocking device wait exceeded its watchdog deadline.

    The device(s) involved are marked suspect (:func:`suspect_devices`)
    before this is raised; ``elapsed_s``/``deadline_s``/``devices``
    carry the breach details for ledgers."""

    def __init__(self, message, *, elapsed_s=None, deadline_s=None,
                 devices=()):
        super().__init__(message)
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        self.devices = tuple(devices)


_suspect_lock = threading.Lock()
_SUSPECT = {}   # device name -> unix time first marked


def mark_suspect(device):
    """Record ``device`` (any object; stored by ``str``) as suspect."""
    with _suspect_lock:
        _SUSPECT.setdefault(str(device), time.time())


def suspect_devices():
    """``{device_name: unix_time_marked}`` snapshot of the registry."""
    with _suspect_lock:
        return dict(_SUSPECT)


def clear_suspects():
    """Empty the suspect registry (after a verified-healthy probe)."""
    with _suspect_lock:
        _SUSPECT.clear()


def resolve_fetch_deadline(deadline=None):
    """The resolution rule for the per-wait watchdog deadline: explicit
    seconds pass through validated (> 0), ``None`` resolves from the
    ``BR_FETCH_DEADLINE_S`` variable; unset, empty or <= 0 means no
    watchdog."""
    if deadline is not None:
        d = float(deadline)
        if d <= 0:
            raise ValueError(f"fetch deadline must be > 0 s, got {deadline}")
        return d
    env = os.environ.get("BR_FETCH_DEADLINE_S", "")
    if not env:
        return None
    d = float(env)
    return d if d > 0 else None


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in x for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    return [] if x is None else [x]


def _events_of(x):
    """``(events, devices)`` to wait on for ``x``: a CUDA event as given,
    or one event recorded on the current stream of each CUDA device that
    holds a tensor of the nest ``x``; no event for CPU tensors."""
    import torch

    if hasattr(x, "query") and hasattr(x, "synchronize"):
        return [x], ["cuda"]
    events, devices = [], []
    for t in _leaves(x):
        if not torch.is_tensor(t):
            continue
        name = str(t.device)
        if name in devices:
            continue
        devices.append(name)
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            events.append(ev)
    return events, devices


def _guarded_wait(events, devices, deadline_s, label, recorder=None):
    """Poll ``events`` until all have completed, bounded by ``deadline_s``.

    The fault injector's ``hang_fetch`` delay holds the wait back inside
    this loop, so the deadline breach below fires exactly as it would on
    a real wedge.  On a breach the armed flight recorder (``obs.live``;
    no-op unarmed) gets the last counter snapshot and dumps its ring, and
    ``recorder`` the ``fetch_timeouts`` counter and a ``hung_fetch``
    fault event."""
    from . import inject

    t0 = time.perf_counter()
    release = t0 + inject.fetch_hang_delay()
    while True:
        now = time.perf_counter()
        if now >= release and all(e.query() for e in events):
            return
        elapsed = now - t0
        if elapsed > deadline_s:
            for d in devices:
                mark_suspect(d)
            from ..obs.live import flight_dump, flight_note_counters

            # the counters before the fault event, so the dumped ring
            # reads "last known state, then the fault"
            flight_note_counters(recorder)
            if recorder is not None:
                recorder.counter("fetch_timeouts")
                recorder.event("fault", kind="hung_fetch", label=label,
                               deadline_s=float(deadline_s),
                               elapsed_s=round(elapsed, 3), devices=devices)
            flight_dump(f"hung_fetch [{label}] after {deadline_s:g}s")
            raise WedgeError(
                f"blocking device wait [{label}] exceeded its "
                f"{deadline_s:g} s deadline ({elapsed:.1f} s elapsed); "
                f"device(s) marked suspect: {devices or 'unknown'}",
                elapsed_s=elapsed, deadline_s=deadline_s, devices=devices)
        # spin for the first millisecond (a window's flag is ready in
        # about that), then poll every half millisecond
        time.sleep(0 if elapsed < 1e-3 else 5e-4)


def block_with_deadline(x, deadline_s, recorder=None, *, label="block"):
    """Wait, bounded by ``deadline_s``, until the device work that
    produces ``x`` (a nest of tensors, or a CUDA event) has completed;
    ``recorder`` (an ``obs.Recorder``) gets a breach's fault telemetry."""
    events, devices = _events_of(x)
    _guarded_wait(events, devices, deadline_s, label, recorder)


def fetch_with_deadline(x, deadline_s, recorder=None, *, label="fetch"):
    """The tensors of the tuple ``x`` as host numpy arrays, the wait for
    them bounded by ``deadline_s``."""
    block_with_deadline(x, deadline_s, recorder, label=label)
    return tuple(t.detach().cpu().numpy() for t in x)


def reset_backend():
    """Best-effort in-process recovery between chunk retries after a
    wedge: drop every captured program (``solver/graphs.py``) so the retry
    captures and launches from scratch, never replaying a program whose
    state was in flight, and return the caching allocator's free blocks.
    It never moves work to the CPU, and it cannot revive a wedged CUDA
    context (module doc)."""
    import torch

    from ..solver import graphs

    graphs.clear_programs()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def terminate_self(grace_s=45.0):
    """SIGTERM the current process (letting the CUDA runtime unwind and
    release the card), escalating to SIGKILL after ``grace_s`` if the
    graceful path itself wedges.  For long-running drivers that prefer
    supervised replacement over in-process retry; never called by the
    library itself."""

    def _escalate():
        time.sleep(grace_s)
        os.kill(os.getpid(), signal.SIGKILL)

    threading.Thread(target=_escalate, daemon=True,
                     name="br-watchdog-sigkill").start()
    os.kill(os.getpid(), signal.SIGTERM)
