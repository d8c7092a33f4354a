"""Retry and quarantine policies (``batchreactor_tpu/resilience/policy.py``).

Both policies follow the repo's knob conventions: ``True`` means "the
documented default policy", a dict is keyword overrides (unknown keys
fail loudly), ``None``/``False`` means off, and a policy instance passes
through, so call sites plumb one value end to end and the normalization
(:func:`normalize_retry` / :func:`normalize_quarantine`) is the one
validation point.

One deliberate difference from the JAX package (ROADMAP C6): a CUDA
runtime error is a ``RuntimeError`` in PyTorch (``torch.AcceleratorError``,
"CUDA error: ..."), and a sticky one leaves the process's CUDA context
unusable, so an in-process retry would fake a recovery or hang.
:func:`retryable` therefore refuses CUDA errors; every retry loop of the
port asks it before it retries.  Process-level recovery (a restart, or the
elastic tier's survivors taking over a dead process's chunks) is the cure
for those."""

import dataclasses

from .watchdog import WedgeError

#: exception classes a chunk retry absorbs: the wedge watchdog's breach,
#: runtime faults and OS-level I/O faults, less the CUDA errors that
#: :func:`retryable` refuses.  Programming errors (ValueError/TypeError)
#: re-raise immediately: retrying them would loop on a bug.
RETRYABLE = (WedgeError, RuntimeError, OSError)

# the message prefixes of PyTorch's CUDA runtime errors (c10's
# C10_CUDA_CHECK, the CUDA driver, cuBLAS and cuSOLVER checks)
_CUDA_MARKS = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS_",
               "CUSOLVER_STATUS_", "device-side assert")


def cuda_error(exc):
    """True for a CUDA runtime error: ``torch.AcceleratorError`` or a
    ``RuntimeError`` whose message carries one of CUDA's error prefixes.
    The watchdog's :class:`WedgeError` is not one (the device did not
    report a fault; the host stopped waiting)."""
    if isinstance(exc, WedgeError):
        return False
    if type(exc).__name__ == "AcceleratorError":
        return True
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _CUDA_MARKS)


def retryable(exc):
    """Whether a retry loop may absorb ``exc``: one of :data:`RETRYABLE`
    and not a CUDA runtime error (module doc)."""
    return isinstance(exc, RETRYABLE) and not cuda_error(exc)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Chunk retry policy for ``checkpointed_sweep(retry=...)``:
    ``max_retries`` re-solves after the first failure, sleeping
    ``backoff_s * backoff_factor**attempt`` between attempts."""

    max_retries: int = 2
    backoff_s: float = 0.5
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_s must be >= 0 and backoff_factor >= 1, got "
                f"{self.backoff_s}/{self.backoff_factor}")

    def delay(self, attempt):
        """Backoff before retry ``attempt`` (0-based)."""
        return float(self.backoff_s) * float(self.backoff_factor) ** attempt


def normalize_retry(retry):
    """None/False -> None (off); True -> default policy; int -> that
    many retries; dict -> keyword overrides; RetryPolicy -> itself."""
    if retry is None or retry is False:
        return None
    if retry is True:
        return RetryPolicy()
    if isinstance(retry, RetryPolicy):
        return retry
    if isinstance(retry, int):
        return RetryPolicy(max_retries=retry)
    if isinstance(retry, dict):
        try:
            return RetryPolicy(**retry)
        except TypeError as e:
            raise ValueError(f"bad retry policy dict {retry!r}: {e}") from e
    raise ValueError(f"retry must be None/bool/int/dict/RetryPolicy, "
                     f"got {type(retry).__name__}")


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Lane-quarantine policy (``quarantine.py`` module doc): failed lanes
    first re-solve with unchanged settings (``retry_pass``, which recovers
    transient corruption bit for bit), then in a tighter-tolerance,
    bigger-budget fallback pass (``rtol_factor``/``atol_factor`` scale the
    tolerances down, ``max_steps_factor`` raises the attempt budget).
    ``oracle=True``, the native CPU cross-check, waits for ROADMAP A16:
    the sweeps raise ``NotImplementedError`` on it."""

    retry_pass: bool = True
    rtol_factor: float = 0.01
    atol_factor: float = 0.01
    max_steps_factor: float = 4.0
    oracle: bool = False

    def __post_init__(self):
        if not (0 < self.rtol_factor <= 1.0) or not (0 < self.atol_factor
                                                     <= 1.0):
            raise ValueError(
                f"rtol_factor/atol_factor must be in (0, 1] (the fallback "
                f"pass TIGHTENS tolerances), got "
                f"{self.rtol_factor}/{self.atol_factor}")
        if self.max_steps_factor < 1.0:
            raise ValueError(f"max_steps_factor must be >= 1, "
                             f"got {self.max_steps_factor}")


def normalize_quarantine(quarantine):
    """None/False -> None (off); True -> default policy; dict -> keyword
    overrides; QuarantinePolicy -> itself."""
    if quarantine is None or quarantine is False:
        return None
    if quarantine is True:
        return QuarantinePolicy()
    if isinstance(quarantine, QuarantinePolicy):
        return quarantine
    if isinstance(quarantine, dict):
        try:
            return QuarantinePolicy(**quarantine)
        except TypeError as e:
            raise ValueError(
                f"bad quarantine policy dict {quarantine!r}: {e}") from e
    raise ValueError(f"quarantine must be None/bool/dict/QuarantinePolicy, "
                     f"got {type(quarantine).__name__}")


def fallback_kwargs(policy, solve_kw, *, default_rtol=1e-6,
                    default_atol=1e-10, default_max_steps=200_000):
    """The fallback pass's solver settings: ``solve_kw`` with tolerances
    scaled by the policy factors and the step budget raised.  One
    function so the api and checkpoint call sites cannot drift."""
    kw = dict(solve_kw)
    kw["rtol"] = float(solve_kw.get("rtol", default_rtol)) * policy.rtol_factor
    kw["atol"] = float(solve_kw.get("atol", default_atol)) * policy.atol_factor
    kw["max_steps"] = int(round(
        int(solve_kw.get("max_steps", default_max_steps))
        * policy.max_steps_factor))
    return kw
