"""The SIGTERM-with-grace subprocess wrapper
(``batchreactor_tpu/resilience/guard.py``).

A supervised child gets SIGTERM first, so its CUDA runtime can unwind and
release the card, and SIGKILL only after a grace period.  Stdlib-only: a
supervisor that must outlive a device fault need not import torch."""

import dataclasses
import signal
import subprocess
import time


@dataclasses.dataclass
class GuardedResult:
    """Outcome of :func:`run_guarded`.  ``rc`` is the child's final
    return code (negative = died to a signal); ``timed_out`` marks a
    deadline breach (the child was SIGTERM'd, and SIGKILLed only if it
    ignored the grace window); ``stderr`` is None under
    ``merge_stderr``."""

    rc: int
    stdout: str
    stderr: str
    timed_out: bool
    wall_s: float


def run_guarded(cmd, timeout, *, grace_s=45.0, env=None, cwd=None,
                merge_stderr=False, text=True):
    """Run ``cmd`` with a deadline, enforcing SIGTERM-then-grace-then-
    SIGKILL teardown (module doc).

    ``timeout`` is the child's wall-clock budget in seconds; ``grace_s``
    is how long a SIGTERM'd child gets to unwind (45 s default, the
    JAX package's).
    ``merge_stderr`` folds stderr into stdout (one log of the child);
    otherwise both streams return separately.  ``env`` replaces the
    child environment when given (pass ``{**os.environ, ...}`` to
    extend)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT if merge_stderr else subprocess.PIPE,
        text=text)
    timed_out = False
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.send_signal(signal.SIGTERM)
        try:
            stdout, stderr = proc.communicate(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
    return GuardedResult(rc=proc.returncode, stdout=stdout or "",
                         stderr=None if merge_stderr else (stderr or ""),
                         timed_out=timed_out,
                         wall_s=time.perf_counter() - t0)
