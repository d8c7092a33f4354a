"""Chunked, checkpointed ensemble sweeps
(``batchreactor_tpu/parallel/checkpoint.py``).

The batch is split into fixed-size chunks; each chunk's SolveResult lands
in one ``.npz`` beside a manifest, and a re-run with the same arguments
loads the chunks whose files exist and solves only the missing ones.
Recovery from a killed process is "run the same command again".  The
``.npz`` keeps the JAX package's schema (``_FIELDS``, ``obs_*``, ``prov``,
``cfg_*``), so each package reads the other's chunks.

Fault tolerance (``resilience/``): chunk saves are crash-atomic (tmp +
``os.replace``), resume *validates* each existing chunk and re-solves a
corrupt one instead of crashing, ``retry=`` re-solves failed or wedged
chunks with exponential backoff and a per-chunk attempt ledger in the
manifest, ``chunk_budget_s=`` bounds each chunk's device wait, and
``quarantine=`` re-solves non-success lanes before a chunk is saved, with
per-lane provenance in the chunk.  ``recorder=`` waits for ROADMAP A14
and ``oracle=`` for A16 (``NotImplementedError``).
"""

import concurrent.futures as _futures
import dataclasses
import hashlib
import json
import os
import threading
import time
import zipfile

import numpy as np
import torch

from ..solver.common import SolveResult, check_deferred
from ..solver.graphs import tree_map
from .sweep import ensemble_solve, ensemble_solve_segmented

_FIELDS = ("t", "y", "status", "n_accepted", "n_rejected", "ts", "ys",
           "n_saved", "h")

#: exception classes a chunk LOAD may raise on a torn/corrupt file:
#: resume treats any of them as "this chunk does not exist" and re-solves
_CORRUPT_ERRORS = (zipfile.BadZipFile, OSError, EOFError, KeyError,
                   ValueError)

# (keyword, default, ROADMAP item) of checkpointed_sweep's deferred options
_DEFERRED = (("recorder", None, "A14"), ("oracle", None, "A16"))

#: chunk counters since they were last set to 0: ``chunks_solved`` (chunk
#: solves that completed, retries not counted twice) and ``chunks_corrupt``
#: (chunk files set aside as ``*.corrupt`` on load)
COUNTS = {"chunks_solved": 0, "chunks_corrupt": 0}


def reset_counts():
    """Set every chunk counter to 0."""
    for k in COUNTS:
        COUNTS[k] = 0


def _host(x):
    return x.detach().cpu().numpy()


def _obs_dict(res):
    """SolveResult.observed as a plain {str: tensor} dict (or None): a
    flat dict of arrays is the schema a chunk can hold."""
    obs = res.observed
    if obs is None:
        return None
    if not (isinstance(obs, dict) and all(isinstance(k, str) for k in obs)):
        raise TypeError(
            "checkpointing supports observer states that are flat "
            f"{{str: array}} dicts; got {type(obs).__name__}")
    return obs


def host_result(res):
    """The checkpointed part of a SolveResult as host (CPU) tensors:
    ``_FIELDS``, the observer fold and the provenance, each an owned copy
    (the pipelined gear's next chunk overwrites its device buffers)."""
    obs = _obs_dict(res)
    return SolveResult(
        **{f: getattr(res, f).detach().cpu().clone() for f in _FIELDS},
        observed=(None if obs is None else
                  {k: v.detach().cpu().clone() for k, v in obs.items()}),
        provenance=(None if res.provenance is None
                    else res.provenance.detach().cpu().clone()))


def save_result(path, res, cfgs=None):
    """Write a (batched) SolveResult [+ conditions] to one .npz, crash-
    atomically: the payload lands in ``<path>.tmp.npz`` and is
    ``os.replace``d into place.  Per-lane provenance persists as
    ``prov``, the observer fold as ``obs_*``, the conditions as
    ``cfg_*``."""
    payload = {f: _host(getattr(res, f)) for f in _FIELDS}
    obs = _obs_dict(res)
    if obs is not None:
        for k, v in obs.items():
            payload[f"obs_{k}"] = _host(v)
    if res.provenance is not None:
        payload["prov"] = np.asarray(_host(res.provenance), dtype=np.int8)
    for k, v in (cfgs or {}).items():
        payload[f"cfg_{k}"] = _host(v)
    tmp = path + ".tmp.npz"  # savez appends .npz unless already suffixed
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_result(path):
    """Inverse of :func:`save_result` -> (SolveResult, cfgs dict), CPU
    tensors."""
    with np.load(path) as z:
        obs = {k[4:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("obs_")}
        res = SolveResult(**{f: torch.from_numpy(z[f]) for f in _FIELDS},
                          observed=obs or None,
                          provenance=(torch.from_numpy(z["prov"])
                                      if "prov" in z.files else None))
        cfgs = {k[4:]: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("cfg_")}
    return res, cfgs


def _concat_results(parts):
    """Host chunk results as one SolveResult.  Chunks resumed from a
    quarantine-off run carry no provenance: they are primary by
    definition, so the mixed case fills zeros for them."""
    observed = None
    if parts and parts[0].observed is not None:
        observed = {k: torch.cat([p.observed[k] for p in parts])
                    for k in parts[0].observed}
    provenance = None
    if parts and any(p.provenance is not None for p in parts):
        provenance = torch.cat([
            (p.provenance if p.provenance is not None
             else torch.zeros(p.status.shape[0], dtype=torch.int8))
            for p in parts])
    return SolveResult(**{f: torch.cat([getattr(p, f) for p in parts])
                          for f in _FIELDS},
                       observed=observed, provenance=provenance)


# ---------------------------------------------------------------------------
# the resume fingerprint
# ---------------------------------------------------------------------------

def _hash_value(h, v, depth=0):
    """Content hash of a value a sweep's callables or settings hold:
    tensors by dtype, shape and bytes (through the host, so the device
    does not enter), dataclasses, dicts, tuples and lists by their
    entries, functions by :func:`_hash_callable`, plain scalars and
    strings by ``repr``.  Anything else (a device, a captured program, a
    lock) enters by its type's name only: its ``repr`` may hold an address
    or a device, which would differ between processes."""
    if torch.is_tensor(v):
        h.update(f"{v.dtype}{tuple(v.shape)}".encode())
        h.update(np.ascontiguousarray(_host(v)).tobytes())
    elif isinstance(v, np.ndarray):
        h.update(f"{v.dtype}{v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, (bool, int, float, complex, str, bytes,
                        type(None), np.generic)):
        h.update(repr(v).encode())
    elif isinstance(v, torch.device):
        pass
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        h.update(type(v).__qualname__.encode())
        for f in dataclasses.fields(v):
            h.update(f.name.encode())
            _hash_value(h, getattr(v, f.name), depth)
    elif isinstance(v, dict):
        for k in sorted(v, key=repr):
            h.update(repr(k).encode())
            _hash_value(h, v[k], depth)
    elif isinstance(v, (tuple, list)):
        h.update(type(v).__name__.encode())
        for e in v:
            _hash_value(h, e, depth)
    elif callable(v) and hasattr(v, "__code__"):
        if depth < 3:
            _hash_callable(h, v, depth + 1)
    else:
        h.update(type(v).__qualname__.encode())


def _hash_code(h, code):
    """A code object's bytecode and constants.  Nested code objects
    recurse (their ``repr`` holds an address) and a frozenset enters
    sorted (its order follows the process's string-hash seed)."""
    h.update(code.co_code)
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            _hash_code(h, c)
        elif isinstance(c, frozenset):
            h.update(repr(sorted(map(repr, c))).encode())
        else:
            h.update(repr(c).encode())


def _hash_callable(h, fn, depth=0):
    """Content hash of a callable: its qualified name and code, and what
    its closure captures (a ``make_gas_rhs`` closure hashes its mechanism
    tensors, so resuming with another mechanism changes the fingerprint
    even though every such closure is named ``rhs``)."""
    h.update(getattr(fn, "__qualname__", type(fn).__qualname__).encode())
    code = getattr(fn, "__code__", None)
    if code is not None:
        _hash_code(h, code)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            _hash_value(h, cell.cell_contents, depth)
        except ValueError:   # an empty cell
            pass


#: knobs that change a chunk's schema: they pin the resume fingerprint
SCHEMA_KNOBS = ("energy",)

#: segmented-gear, watchdog and admission knobs: results-neutral, so a
#: resume under another value serves the same chunks
_FP_EXEMPT_KEYS = ("pipeline", "poll_every", "fetch_deadline", "admission",
                   "refill", "mesh")


def _sweep_fingerprint(rhs, y0s, cfgs, solve_kw):
    """Content hash pinning a sweep's inputs: the rhs (code and captured
    mechanism tensors), initial states, per-lane conditions and solver
    settings.  A resume into a checkpoint directory whose fingerprint
    differs fails loudly instead of serving chunks of another sweep.  The
    hash reads tensors through the host and leaves devices out, so every
    process of a sweep, on any device, computes the same one."""
    h = hashlib.sha256()
    h.update(b"br-torch-sweep-fingerprint-v1")
    h.update(b"method=" + str(solve_kw.get("method", "bdf")).encode())
    _hash_callable(h, rhs)
    _hash_value(h, y0s)
    for k in sorted(cfgs):
        h.update(k.encode())
        _hash_value(h, cfgs[k])
    for k in sorted(solve_kw):
        if k == "method" or k in _FP_EXEMPT_KEYS:
            continue
        h.update(k.encode())
        v = solve_kw[k]
        if callable(v):
            _hash_callable(h, v)
        else:
            _hash_value(h, v)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# manifest + attempt ledger
# ---------------------------------------------------------------------------
_PINNED_KEYS = ("B", "chunk_size", "t0", "t1", "fingerprint")
_LEDGER_CAP = 20   # attempt records kept per chunk (newest win)


def _write_manifest_atomic(path, manifest):
    # a per-process tmp name: elastic processes racing to create the
    # manifest must not share one tmp
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)


def ensure_manifest(ckpt_dir, pinned):
    """Create-or-validate ``manifest.json`` against the ``pinned`` sweep
    identity; returns the (mutable) per-chunk attempt ledger dict.  Only
    the pinned keys take part in the resume-mismatch check."""
    manifest_path = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            prev = json.load(f)
        prev_pinned = {k: prev.get(k) for k in _PINNED_KEYS}
        if prev_pinned != pinned:
            raise ValueError(
                f"checkpoint dir {ckpt_dir} holds a different sweep "
                f"({prev_pinned} != {pinned}); use a fresh directory")
        return prev.get("attempts", {})
    _write_manifest_atomic(manifest_path, {**pinned, "attempts": {}})
    return {}


class _Ledger:
    """Per-chunk attempt ledger persisted inside ``manifest.json``: which
    chunk failed, how, how many times, before it solved.  Appends are
    lock-guarded and each write rewrites the manifest atomically."""

    def __init__(self, ckpt_dir, pinned, attempts):
        self._path = os.path.join(ckpt_dir, "manifest.json")
        self._pinned = pinned
        self.attempts = attempts
        self.extra = {}
        self._lock = threading.Lock()

    def annotate(self, **extra):
        """Attach operational (non-pinned) metadata to the manifest."""
        with self._lock:
            self.extra.update(extra)
            self._write()

    def record(self, chunk, outcome, attempt, error=None):
        with self._lock:
            entry = {"attempt": int(attempt), "outcome": outcome,
                     "time": time.time()}
            if error is not None:
                entry["kind"] = type(error).__name__
                entry["error"] = str(error)[:300]
            rows = self.attempts.setdefault(str(int(chunk)), [])
            rows.append(entry)
            del rows[:-_LEDGER_CAP]
            self._write()

    def _write(self):
        _write_manifest_atomic(self._path, {**self._pinned, **self.extra,
                                            "attempts": self.attempts})


# ---------------------------------------------------------------------------
# chunk solve (shared with the multihost tier)
# ---------------------------------------------------------------------------
_SEGMENTED_ONLY = ("segment_steps", "pipeline", "poll_every",
                   "fetch_deadline", "admission", "refill")


def _solve_chunk(rhs, y0c, t0, t1, cfgc, solve_kw):
    """Solve one chunk through the configured path: the monolithic
    ``ensemble_solve``, or with ``segment_steps > 0`` in ``solve_kw``
    ``ensemble_solve_segmented`` with ``max_steps`` mapped onto the exact
    per-lane attempt budget.  Module-level so the elastic tier and the
    quarantine passes run the chunk program the primary attempt ran."""
    seg_steps = int(solve_kw.get("segment_steps", 0) or 0)
    if seg_steps > 0:
        kw = {k: v for k, v in solve_kw.items()
              if k not in ("segment_steps", "max_steps")}
        ms = int(solve_kw.get("max_steps", 200_000))
        return ensemble_solve_segmented(
            rhs, y0c, t0, t1, cfgc, segment_steps=seg_steps,
            max_segments=max(1, -(-ms // seg_steps)), max_attempts=ms, **kw)
    kw = {k: v for k, v in solve_kw.items() if k not in _SEGMENTED_ONLY}
    return ensemble_solve(rhs, y0c, t0, t1, cfgc, **kw)


def _resolve_run_kw(solve_kw, y0s, B):
    """``solve_kw`` as the chunks run it: ``linsolve="auto"`` resolved
    once with the whole sweep's lane count (as ``batch_reactor_sweep``
    does), so every chunk, shard or process runs the linear algebra of
    the unchunked sweep."""
    from ..solver.linalg import resolve_linsolve
    from .sweep import _mesh_devices

    mesh = solve_kw.get("mesh")
    dev = y0s.device if mesh is None else _mesh_devices(mesh)[0]
    return {**solve_kw, "linsolve": resolve_linsolve(
        solve_kw.get("linsolve", "auto"),
        method=solve_kw.get("method", "bdf"), device=dev, batch=int(B),
        n=int(y0s.shape[1]))}


def _check_segmented_knobs(solve_kw, names):
    """The gear, watchdog and admission knobs configure the segmented
    driver only: an explicit value without ``segment_steps > 0`` raises
    instead of reporting a configuration that never ran."""
    if int(solve_kw.get("segment_steps", 0) or 0) <= 0:
        explicit = [k for k in names if solve_kw.get(k) is not None]
        if explicit:
            raise ValueError(
                f"{'/'.join(explicit)} are segmented-path knobs; set "
                f"segment_steps > 0 or drop the arguments")


def _sync(res):
    """Wait for a chunk's device work (its state) to complete."""
    if res.y.is_cuda:
        torch.cuda.synchronize(res.y.device)


# ---------------------------------------------------------------------------
# chunk wall-clock budget (the wedge watchdog's per-chunk deadline)
# ---------------------------------------------------------------------------
def resolve_chunk_budget(chunk_budget_s=None):
    """The resolution rule for the per-chunk watchdog budget: explicit
    seconds (> 0) or ``"auto"`` pass through, ``None`` resolves from
    ``BR_CHUNK_BUDGET_S`` (a float, or ``auto``); unset, empty or <= 0
    means no budget."""
    if chunk_budget_s is None:
        chunk_budget_s = os.environ.get("BR_CHUNK_BUDGET_S", "") or None
    if chunk_budget_s is None:
        return None
    if chunk_budget_s == "auto":
        return "auto"
    b = float(chunk_budget_s)
    if b <= 0:
        return None
    return b


class _ChunkBudget:
    """Each chunk's wall-clock budget.  Fixed mode returns the configured
    seconds.  ``"auto"`` calibrates from completed chunks: ``mult x`` the
    cost-scaled median observed wall (per unit of the chunk's predicted
    ``lane_cost`` sum when one was given, per lane otherwise), floored at
    ``min_s``; the first chunk runs unbudgeted.  ``BR_CHUNK_BUDGET_MULT``
    / ``BR_CHUNK_BUDGET_MIN_S`` tune the margin (defaults 4x / 30 s)."""

    def __init__(self, mode):
        self.mode = mode
        self.mult = float(os.environ.get("BR_CHUNK_BUDGET_MULT", "4"))
        self.min_s = float(os.environ.get("BR_CHUNK_BUDGET_MIN_S", "30"))
        self._ratios = []

    def budget_for(self, rel_cost):
        if self.mode is None:
            return None
        if self.mode != "auto":
            return float(self.mode)
        if not self._ratios:
            return None
        per_unit = float(np.median(self._ratios))
        return max(self.min_s, self.mult * per_unit * float(rel_cost))

    def observe(self, wall_s, rel_cost):
        if self.mode == "auto" and rel_cost > 0:
            self._ratios.append(float(wall_s) / float(rel_cost))


def _wait_chunk(res, budget_s, label):
    """Wait for the chunk's device work, bounded by ``budget_s`` (None:
    unbounded)."""
    if budget_s is None:
        _sync(res)
    else:
        from ..resilience.watchdog import block_with_deadline

        block_with_deadline(res.y, budget_s, label=label)


def _stream_pending_chunks(rhs, y0s, t0, t1, cfgs, ckpt_dir, parts, *,
                           chunk_size, resident, refill, refill_spec,
                           solve_kw, chunk_log, retry, qpol, ledger,
                           load_chunk, save_async, subset_solve):
    """``checkpointed_sweep``'s admission backlog mode: every pending
    (not-on-disk) chunk's lanes form ONE backlog streamed through the
    resident admission program, and a chunk's ``.npz`` is written the
    moment its last lane is harvested: chunks become completion units
    instead of execution units, while incremental resume is preserved.
    Harvested rows arrive in caller lane order, so chunk files are
    position-identical to the chunked path's.

    ``retry=`` wraps the whole streaming pass: chunks finalized before a
    retryable fault stay on disk, and the retry re-streams only the lanes
    still pending.  Fills ``parts`` with the per-chunk results in chunk
    order."""
    from ..resilience import inject
    from ..resilience import quarantine as _quarantine
    from ..resilience.policy import RETRYABLE, retryable
    from ..resilience.watchdog import WedgeError, reset_backend
    from .sweep import resolve_pipeline_defaults

    B = int(y0s.shape[0])
    tail = tuple(y0s.shape[1:])
    dtype = y0s.dtype
    chunks = [(i, lo, min(lo + chunk_size, B))
              for i, lo in enumerate(range(0, B, chunk_size))]
    ledger.annotate(admission={
        "resident": int(resident), "refill": refill_spec,
        "order": "backlog-sequential (chunk-major; lane_cost-sorted "
                 "lane order when given)"})
    done = {}
    for i, lo, hi in chunks:
        path = os.path.join(ckpt_dir, f"chunk_{i:05d}.npz")
        if os.path.exists(path):
            r = load_chunk(i, path)
            if r is not None:
                done[i] = r
    seg_steps = int(solve_kw["segment_steps"])
    ms = int(solve_kw.get("max_steps", 200_000))
    kw = {k: v for k, v in solve_kw.items()
          if k not in ("segment_steps", "max_steps")}
    per_lane_segs = max(1, -(-ms // seg_steps))

    def finalize(i, lo, hi, buf, attempt):
        n = hi - lo
        chunk_cfgs = {k: v[lo:hi] for k, v in cfgs.items()}
        res = SolveResult(
            t=torch.as_tensor(buf["t"], dtype=dtype),
            y=torch.as_tensor(buf["y"], dtype=dtype),
            status=torch.as_tensor(buf["status"]),
            n_accepted=torch.as_tensor(buf["n_accepted"]),
            n_rejected=torch.as_tensor(buf["n_rejected"]),
            # n_save=0 placeholders (the solvers' (1,)-row convention)
            ts=torch.full((n, 1), float("inf"), dtype=dtype),
            ys=torch.zeros((n, 1) + tail, dtype=dtype),
            n_saved=torch.zeros((n,), dtype=torch.int64),
            h=torch.as_tensor(buf["h"], dtype=dtype),
            observed=({k: torch.as_tensor(v) for k, v in
                       buf["observed"].items()}
                      if "observed" in buf else None))
        # fault injection (global lane indices in solve order) before the
        # quarantine, as on the chunked path
        res = inject.poison_lanes(res, lo, hi)
        if qpol is not None:
            res, _ = _quarantine.resolve(res, y0s[lo:hi], chunk_cfgs,
                                         subset_solve, policy=qpol)
        att = res.n_accepted.numpy() + res.n_rejected.numpy()
        if chunk_log is not None:
            retry_note = f" (attempt {attempt})" if attempt else ""
            chunk_log(f"[ckpt] chunk {i} ({n} lanes): streamed"
                      f"{retry_note}, attempts mean {att.mean():.0f} "
                      f"max {att.max()}")
        ledger.record(i, "ok", attempt)
        res = host_result(res)
        save_async(i, os.path.join(ckpt_dir, f"chunk_{i:05d}.npz"), res,
                   chunk_cfgs)
        done[i] = res

    attempts = (retry.max_retries if retry is not None else 0) + 1
    for attempt in range(attempts):
        pend = [c for c in chunks if c[0] not in done]
        if not pend:
            break
        backlog = np.concatenate([np.arange(lo, hi) for _, lo, hi in pend])
        bl_chunk = np.concatenate([np.full((hi - lo,), i)
                                   for i, lo, hi in pend])
        bl_local = np.concatenate([np.arange(hi - lo) for _, lo, hi in pend])
        spans = {i: (lo, hi) for i, lo, hi in pend}
        bufs, counts = {}, {i: 0 for i, _, _ in pend}

        def alloc(n, payload):
            b = {"t": np.zeros((n,)), "y": np.zeros((n,) + tail),
                 "status": np.zeros((n,), np.int32),
                 "n_accepted": np.zeros((n,), np.int64),
                 "n_rejected": np.zeros((n,), np.int64),
                 "h": np.zeros((n,))}
            if "observed" in payload:
                b["observed"] = {k: np.zeros((n,) + v.shape[1:], v.dtype)
                                 for k, v in payload["observed"].items()}
            return b

        def on_harvest(gids, payload):
            for ci in np.unique(bl_chunk[gids]):
                ci = int(ci)
                sel = np.nonzero(bl_chunk[gids] == ci)[0]
                lo, hi = spans[ci]
                buf = bufs.get(ci)
                if buf is None:
                    buf = bufs[ci] = alloc(hi - lo, payload)
                rows = bl_local[gids[sel]]
                for f in ("t", "y", "status", "n_accepted", "n_rejected",
                          "h"):
                    buf[f][rows] = payload[f][sel]
                if "observed" in buf:
                    for k in buf["observed"]:
                        buf["observed"][k][rows] = payload["observed"][k][
                            sel]
                counts[ci] += sel.size
                if counts[ci] == hi - lo:
                    finalize(ci, lo, hi, bufs.pop(ci), attempt)

        sel = torch.as_tensor(backlog, device=y0s.device)
        y0_b = y0s[sel]
        cfg_b = {k: v[sel.to(v.device)] for k, v in cfgs.items()}
        # admitted lanes park within per_lane_segs segments of admission,
        # but refills only happen at poll boundaries: up to per_lane_segs
        # + poll_every segments per generation, +1 generation of slack
        _, poll = resolve_pipeline_defaults(kw.get("pipeline"),
                                            kw.get("poll_every"))
        n_seg = ((per_lane_segs + int(poll))
                 * (-(-backlog.size // int(resident)) + 1))
        try:
            ensemble_solve_segmented(
                rhs, y0_b, t0, t1, cfg_b, segment_steps=seg_steps,
                max_segments=n_seg, max_attempts=ms,
                admission=int(resident), refill=refill,
                _on_harvest=on_harvest, **kw)
            break
        except RETRYABLE as e:
            last = attempt == attempts - 1 or not retryable(e)
            for i, _, _ in pend:
                if i not in done:
                    ledger.record(i, "error", attempt, e)
            if chunk_log is not None:
                chunk_log(f"[ckpt] streamed pass attempt {attempt} "
                          f"FAILED ({type(e).__name__}); "
                          f"{'giving up' if last else 'retrying'}")
            if last:
                raise
            if isinstance(e, WedgeError):
                reset_backend()
            time.sleep(retry.delay(attempt))
    leftover = [i for i, _, _ in chunks if i not in done]
    if leftover:
        raise RuntimeError(
            f"streamed sweep left chunks {leftover} incomplete (lanes "
            f"never admitted: the segment budget under-covered the "
            f"backlog)")
    parts.extend(done[i] for i, _, _ in chunks)


def checkpointed_sweep(rhs, y0s, t0, t1, cfgs, ckpt_dir, *, chunk_size=512,
                       lane_cost=None, chunk_log=None, retry=None,
                       chunk_budget_s=None, quarantine=None, admission=None,
                       refill=None, recorder=None, oracle=None, **solve_kw):
    """``ensemble_solve`` with chunk-level checkpoint/resume.

    Splits the (B, ...) batch into ``chunk_size`` pieces; chunk i's result
    is persisted to ``ckpt_dir/chunk_{i:05d}.npz`` as soon as it finishes.
    The npz compression and write run on a background thread (each chunk
    converted to host copies first), so the next chunk's device solve
    overlaps it; every pending save is drained before this function
    returns.  On re-invocation, chunks with an existing file are loaded
    instead of re-solved (the manifest pins B, chunk_size, t0, t1 and a
    content fingerprint of the inputs, so a mismatched resume fails
    loudly); a chunk file that fails to load is renamed ``*.corrupt`` and
    re-solved.  Returns the full concatenated SolveResult on the host
    (``_FIELDS``, the observer fold and, with quarantine, the provenance).

    ``solve_kw`` configures each chunk's solve (``ensemble_solve``, or with
    ``segment_steps > 0`` ``ensemble_solve_segmented``, whose ``max_steps``
    maps onto the exact per-lane attempt budget; its ``pipeline``/
    ``poll_every``/``fetch_deadline``/``mesh`` pass through).
    ``linsolve="auto"`` resolves once with the whole sweep's lane count,
    so each chunk runs the linear algebra of the unchunked sweep.

    ``lane_cost`` — optional (B,) predicted per-lane cost: lanes are
    solved in ascending-cost order so each chunk is cost-homogeneous, and
    results come back in the caller's lane order.

    ``admission=``/``refill=`` (grammar ``parallel.sweep.
    resolve_admission``; needs ``segment_steps > 0``, no ``mesh``,
    ``n_save=0`` and no ``chunk_budget_s``) stream the pending chunks'
    lanes as one backlog through a resident program (``admission=True``:
    ``chunk_size`` slots), writing each chunk the moment its last lane is
    harvested.  The quarantine's same-settings pass then re-solves a
    chunk through the per-chunk program, another batch shape than the
    stream's, so its recovery is tolerance-level rather than bit for bit.

    Fault tolerance (``resilience/``):

    * ``retry=`` (None/True/int/dict/``RetryPolicy``) re-solves a chunk
      whose solve raised a retryable fault (``resilience.retryable``: the
      watchdog's ``WedgeError``, other runtime and OS faults, never a CUDA
      error) up to ``max_retries`` times with exponential backoff, after
      ``resilience.reset_backend()`` on a wedge.  Every attempt lands in
      the per-chunk ledger inside ``manifest.json`` (``attempts``).
    * ``chunk_budget_s=`` (seconds, ``"auto"``, or None ->
      ``BR_CHUNK_BUDGET_S``) bounds each chunk's device wait; a breach is
      a ``WedgeError``.
    * ``quarantine=`` (None/True/dict/``QuarantinePolicy``) re-solves
      non-success lanes (``resilience/quarantine.py``) before the chunk is
      saved; per-lane provenance persists in the npz (``prov``).

    ``energy=`` declares a non-isothermal sweep: it pins the fingerprint
    (the chunk state grows the T column) and is not forwarded.
    ``recorder=`` waits for ROADMAP A14 and ``oracle=`` for A16.
    """
    from ..energy.eqns import resolve_energy
    from ..resilience import inject
    from ..resilience import quarantine as _quarantine
    from ..resilience.policy import (RETRYABLE, fallback_kwargs,
                                     normalize_quarantine, normalize_retry,
                                     retryable)
    from ..resilience.watchdog import WedgeError, reset_backend
    from .sweep import resolve_admission

    check_deferred({"recorder": recorder, "oracle": oracle}, _DEFERRED)
    retry = normalize_retry(retry)
    qpol = normalize_quarantine(quarantine)
    _quarantine.check_oracle(qpol)
    energy = resolve_energy(solve_kw.pop("energy", None))
    resident_req, refill_spec = resolve_admission(
        admission, refill, n_lanes=int(y0s.shape[0]))
    if resident_req is not None:
        if int(solve_kw.get("segment_steps", 0) or 0) <= 0:
            raise ValueError(
                "admission= streams chunks through the segmented driver; "
                "set segment_steps > 0 or drop the admission knobs")
        if solve_kw.get("mesh") is not None:
            raise ValueError(
                "admission= is incompatible with mesh= (parallel/sweep.py "
                "admission contract); drop one of them")
        if solve_kw.get("n_save"):
            raise ValueError(
                "admission= requires n_save=0; stream reductions through "
                "observer= instead")
        if chunk_budget_s is not None:
            raise ValueError(
                "chunk_budget_s is a per-chunk watchdog and admission= "
                "dissolves the chunk as execution unit; use "
                "fetch_deadline= (the streaming driver's wedge surface) "
                "instead")
    budget = _ChunkBudget(resolve_chunk_budget(
        None if resident_req is not None else chunk_budget_s))
    _check_segmented_knobs(solve_kw, ("pipeline", "poll_every",
                                      "fetch_deadline"))
    if "buckets" in solve_kw:
        # one spelling per ladder in the fingerprint; buckets=None hashes
        # like the knob absent
        from ..aot.buckets import normalize_buckets

        solve_kw["buckets"] = normalize_buckets(solve_kw["buckets"])
        if solve_kw["buckets"] is None:
            del solve_kw["buckets"]
    if chunk_log is not None:
        # the writer thread logs concurrently with the main thread:
        # serialize in the library so any chunk_log callable is safe
        _log_lock = threading.Lock()
        _raw_log = chunk_log

        def chunk_log(msg):
            with _log_lock:
                _raw_log(msg)
    perm = inv_perm = None
    cost_sorted = None
    if lane_cost is not None:
        lane_cost = np.asarray(lane_cost)
        if lane_cost.shape != (y0s.shape[0],):
            raise ValueError(f"lane_cost must be shape ({y0s.shape[0]},), "
                             f"got {lane_cost.shape}")
        # stable sort: equal-cost lanes keep caller order, so the
        # permutation (and the fingerprint of the permuted y0s) is
        # deterministic across runs
        perm = np.argsort(lane_cost, kind="stable")
        inv_perm = np.argsort(perm, kind="stable")
        y0s = y0s[torch.as_tensor(perm, device=y0s.device)]
        cfgs = {k: v[torch.as_tensor(perm, device=v.device)]
                for k, v in cfgs.items()}
        cost_sorted = lane_cost[perm]
    B = int(y0s.shape[0])
    os.makedirs(ckpt_dir, exist_ok=True)
    fp_kw = solve_kw if energy is None else {**solve_kw, "energy": energy}
    pinned = {"B": B, "chunk_size": chunk_size, "t0": float(t0),
              "t1": float(t1),
              "fingerprint": _sweep_fingerprint(rhs, y0s, cfgs, fp_kw)}
    ledger = _Ledger(ckpt_dir, pinned, ensure_manifest(ckpt_dir, pinned))
    run_kw = _resolve_run_kw(solve_kw, y0s, B)

    def _rel_cost(lo, hi):
        if cost_sorted is not None:
            return float(np.sum(cost_sorted[lo:hi]))
        return float(hi - lo)

    def _solve_with_retry(i, lo, hi, y0c, cfgc):
        attempts = (retry.max_retries if retry is not None else 0) + 1
        for attempt in range(attempts):
            try:
                t_start = time.perf_counter()
                res = _solve_chunk(rhs, y0c, t0, t1, cfgc, run_kw)
                _wait_chunk(res, budget.budget_for(_rel_cost(lo, hi)),
                            f"chunk{i}")
                wall = time.perf_counter() - t_start
                budget.observe(wall, _rel_cost(lo, hi))
                ledger.record(i, "ok", attempt)
                return res, wall, attempt
            except RETRYABLE as e:
                ledger.record(i, "error", attempt, e)
                last = attempt == attempts - 1 or not retryable(e)
                if chunk_log is not None:
                    chunk_log(f"[ckpt] chunk {i} attempt {attempt} "
                              f"FAILED ({type(e).__name__}); "
                              f"{'giving up' if last else 'retrying'}")
                if last:
                    raise
                if isinstance(e, WedgeError):
                    reset_backend()
                time.sleep(retry.delay(attempt))

    def _subset_solve(y0_sub, cfg_sub, pass_name):
        kw = (run_kw if pass_name == "retry"
              else fallback_kwargs(qpol, run_kw))
        return _solve_chunk(rhs, y0_sub, t0, t1, cfg_sub, kw)

    parts = []
    pending = []
    # one worker, and at most ONE save in flight: save i overlaps solve
    # i+1, but solve i+2 waits for save i, so a save failure surfaces
    # within one chunk and a killed process loses at most one queued save
    executor = _futures.ThreadPoolExecutor(max_workers=1)
    primary = []

    def _await_last():
        try:
            pending[-1].result()
        except Exception:
            primary.append(pending[-1])
            raise
        pending.pop()

    def _save_async(i, path, res, chunk_cfgs):
        # host copies before the save is queued: the next chunk's graphs
        # overwrite the device buffers
        chunk_cfgs = {k: v.detach().cpu().clone()
                      for k, v in chunk_cfgs.items()}

        def job():
            t_save = time.perf_counter()
            save_result(path, res, chunk_cfgs)
            # test-only: the corrupt-chunk simulation tears the file AFTER
            # the atomic save
            inject.corrupt_path(path, i)
            if chunk_log is not None:
                chunk_log(f"[ckpt] chunk {i} saved "
                          f"({time.perf_counter() - t_save:.2f}s, async)")
        if pending:
            _await_last()
        # test-only: the killed-process simulation, once the previous
        # chunk's save is done and before this one's
        inject.kill_now(i)
        pending.append(executor.submit(job))

    def _load_chunk(i, path):
        """Load an existing chunk file; a torn or corrupt one is kept
        aside (``*.corrupt``) and ``None`` is returned so the caller
        re-solves."""
        try:
            res, _ = load_result(path)
            if chunk_log is not None:
                chunk_log(f"[ckpt] chunk {i} loaded from {path}")
            return res
        except _CORRUPT_ERRORS as e:
            os.replace(path, path + ".corrupt")
            COUNTS["chunks_corrupt"] += 1
            if chunk_log is not None:
                chunk_log(f"[ckpt] chunk {i} file corrupt "
                          f"({type(e).__name__}): re-solving")
            return None

    try:
        if resident_req is not None:
            _stream_pending_chunks(
                rhs, y0s, t0, t1, cfgs, ckpt_dir, parts,
                chunk_size=chunk_size,
                resident=(chunk_size if admission is True
                          else resident_req),
                refill=refill, refill_spec=refill_spec, solve_kw=run_kw,
                chunk_log=chunk_log, retry=retry, qpol=qpol, ledger=ledger,
                load_chunk=_load_chunk, save_async=_save_async,
                subset_solve=_subset_solve)
        else:
            for i, lo in enumerate(range(0, B, chunk_size)):
                hi = min(lo + chunk_size, B)
                path = os.path.join(ckpt_dir, f"chunk_{i:05d}.npz")
                chunk_cfgs = {k: v[lo:hi] for k, v in cfgs.items()}
                res = (_load_chunk(i, path) if os.path.exists(path)
                       else None)
                if res is None:
                    res, solve_s, attempt = _solve_with_retry(
                        i, lo, hi, y0s[lo:hi], chunk_cfgs)
                    COUNTS["chunks_solved"] += 1
                    # test-only: the NaN-lane simulation (global lane
                    # indices in solve order), before the quarantine
                    res = inject.poison_lanes(res, lo, hi)
                    if qpol is not None:
                        res, _ = _quarantine.resolve(
                            res, y0s[lo:hi], chunk_cfgs, _subset_solve,
                            policy=qpol)
                    res = host_result(res)
                    if chunk_log is not None:
                        att = res.n_accepted.numpy() + res.n_rejected.numpy()
                        retry_note = (f" (attempt {attempt})" if attempt
                                      else "")
                        chunk_log(
                            f"[ckpt] chunk {i} ({hi - lo} lanes): solve "
                            f"{solve_s:.2f}s ({(hi - lo) / solve_s:.1f} "
                            f"cond/s){retry_note}, attempts mean "
                            f"{att.mean():.0f} max {att.max()}")
                    _save_async(i, path, res, chunk_cfgs)
                parts.append(res)
        # durability barrier: a failed save fails the sweep call, not a
        # later resume
        while pending:
            _await_last()
    finally:
        executor.shutdown(wait=True)
        for fut in pending:
            if fut in primary:
                continue
            exc = fut.done() and fut.exception()
            if exc and chunk_log is not None:
                chunk_log(f"[ckpt] WARNING: background save also failed "
                          f"during unwind: {exc!r}")
    out = _concat_results(parts)
    if inv_perm is not None:
        inv = torch.as_tensor(inv_perm)
        out = SolveResult(**{f: tree_map(lambda x: x[inv], getattr(out, f))
                             for f in SolveResult.__dataclass_fields__})
    return out
