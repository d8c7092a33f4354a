"""Compile & retrace detection for the port: :class:`CompileWatch`.

Port of ``batchreactor_tpu/obs/retrace.py``, with the same name and the
same ``summary()`` keys (``available``, ``compiles``, ``traces``,
``retraces``, ``compile_s``, ``cache_hits``, ``cache_misses``,
``by_label``).  The port compiles no XLA program; what the keys count
here:

* ``compiles`` — CUDA graph captures (``solver/graphs.py``
  ``Program._capture``: one per step of a program, at its first run on
  the card), plus builds of ``csrc/`` by ``nvcc`` at first use
  (``solver/linalg_cuda.py``); ``compile_s`` their walls.
* ``traces`` — programs built by ``graphs.program`` (a cache miss: the
  step functions and their buffers for one sweep shape).
* ``cache_hits`` — kernel libraries served from the hashed build cache on
  disk instead of ``nvcc`` (``cache_misses`` are the builds).
* ``retraces`` — a second capture of one step under one single-program
  label and program key: a warm sweep that re-captures, e.g. because a
  callable lost its identity and the program cache missed.  On the CPU,
  where nothing is captured, a second program *built* under one
  single-program label and program key is the retrace.

Events reach the watches entered on any thread through one module-level
dispatcher (:func:`dispatch`, called by ``graphs`` and ``linalg_cuda``);
labels are per thread, as in the reference.  A watch outside its
``with`` block costs nothing.
"""

import threading

_LOCK = threading.Lock()
_WATCHES = []


def dispatch(kind, **info):
    """Fan one event out to every entered watch: ``kind`` is ``"trace"``
    (a program built; ``device=``), ``"compile"`` (a graph captured,
    ``step=``, ``seconds=``; or an ``nvcc`` build, ``step="nvcc"``) or
    ``"cache_hit"`` (a kernel library loaded from the build cache)."""
    with _LOCK:
        watches = list(_WATCHES)
    for w in watches:
        w._on_event(kind, info)


class CompileWatch:
    """Counts program builds, graph captures and kernel builds per program
    label while entered (module doc).

    >>> watch = CompileWatch(recorder=rec)
    >>> with watch, watch.region("sweep-segment"):
    ...     res = ensemble_solve_segmented(...)
    >>> watch.summary()["compiles"]
    """

    def __init__(self, recorder=None, default_label="program"):
        self.recorder = recorder
        self.default_label = default_label
        self.by_label = {}
        self.available = None   # known at __enter__ (always True here)
        self._tls = threading.local()
        self._lock = threading.Lock()

    # ---- label regions ----------------------------------------------------
    def _label(self):
        stack = getattr(self._tls, "labels", None)
        return stack[-1] if stack else (self.default_label, False, None)

    def region(self, label, single_program=False, program_key=None):
        """Context manager: attribute events on this thread to ``label``
        while active (nests; innermost wins).  ``single_program=True``
        arms retrace detection for the label; ``program_key`` (e.g. the
        padded lane count) scopes it per program shape, so a bucket change
        is an expected first build, never a retrace."""
        watch = self

        class _Region:
            def __enter__(self):
                stack = getattr(watch._tls, "labels", None)
                if stack is None:
                    stack = watch._tls.labels = []
                stack.append((label, single_program, program_key))
                return self

            def __exit__(self, *exc):
                watch._tls.labels.pop()
                return False

        return _Region()

    # ---- lifecycle --------------------------------------------------------
    def __enter__(self):
        self.available = True
        with _LOCK:
            _WATCHES.append(self)
        return self

    def __exit__(self, *exc):
        with _LOCK:
            if self in _WATCHES:
                _WATCHES.remove(self)
        return False

    # ---- events (any thread) ----------------------------------------------
    def _entry(self):
        label, single, _pk = self._label()
        with self._lock:
            e = self.by_label.setdefault(
                label, {"traces": 0, "compiles": 0, "compile_s": 0.0,
                        "cache_hits": 0, "cache_misses": 0,
                        "cache_load_s": 0.0, "retraces": 0,
                        "single_program": single, "programs": {}})
            e["single_program"] = e["single_program"] or single
            return e

    def _on_event(self, kind, info):
        label, _single, pkey = self._label()
        e = self._entry()
        pk = "" if pkey is None else str(pkey)
        slot = None
        with self._lock:
            if kind == "trace":
                e["traces"] += 1
                if info.get("device") == "cpu":
                    slot = pk
            elif kind == "cache_hit":
                e["cache_hits"] += 1
            elif kind == "compile":
                e["compiles"] += 1
                e["compile_s"] += float(info.get("seconds", 0.0))
                if info.get("step") == "nvcc":
                    e["cache_misses"] += 1
                else:
                    slot = f"{pk}/{info.get('step')}" if pk else str(
                        info.get("step"))
            retrace = False
            if slot is not None:
                n = e["programs"].get(slot, 0) + 1
                e["programs"][slot] = n
                retrace = e["single_program"] and n > 1
                if retrace:
                    e["retraces"] += 1
        if retrace and self.recorder is not None:
            self.recorder.event("retrace", label=label, program=slot,
                                compiles=e["compiles"],
                                duration_s=float(info.get("seconds", 0.0)))

    # ---- views ------------------------------------------------------------
    def summary(self):
        """``{"available", "compiles", "traces", "retraces", "compile_s",
        "cache_hits", "cache_misses", "by_label"}`` totals over the watch
        window (module doc for what each counts in the port)."""
        with self._lock:
            by_label = {k: {**v, "programs": dict(v["programs"])}
                        for k, v in self.by_label.items()}
        return {
            "available": bool(self.available),
            "compiles": sum(v["compiles"] for v in by_label.values()),
            "traces": sum(v["traces"] for v in by_label.values()),
            "retraces": sum(v["retraces"] for v in by_label.values()),
            "compile_s": sum(v["compile_s"] for v in by_label.values()),
            "cache_hits": sum(v["cache_hits"] for v in by_label.values()),
            "cache_misses": sum(v["cache_misses"]
                                for v in by_label.values()),
            "by_label": by_label,
        }

    @property
    def retraces(self):
        return sum(v["retraces"] for v in self.by_label.values())
