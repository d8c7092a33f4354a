"""Multi-process ensemble sweeps (``batchreactor_tpu/parallel/multihost.py``)
on ``torch.distributed``.

Two tiers:

* **collective** — :func:`ensemble_solve_multihost`: every process holds
  the same full batch, solves its contiguous share of the lanes on its own
  device and the results are gathered over the ``gloo`` backend, the only
  collective (lanes exchange no data).  ``gloo`` runs on the CPU and under
  a GPU alike; NCCL refuses two ranks on one GPU, which a one-card machine
  needs.

      from batchreactor_tpu_torch.parallel import multihost as mh
      mh.initialize("localhost:29500", num_processes=N, process_id=i)
      res = mh.ensemble_solve_multihost(rhs, y0s, 0.0, t1, cfgs, jac=jac,
                                        device="cuda:0")

* **elastic** — :func:`elastic_checkpointed_sweep`: no collective at all.
  Processes coordinate through a shared checkpoint directory: chunks are
  claimed with atomic ``O_EXCL`` files, liveness is a per-process
  heartbeat file, and a chunk whose claim owner stops heartbeating is
  taken over by a survivor.  A dead process can never hang a survivor,
  which a collective would.
"""

import json
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.heartbeat import Heartbeat
from ..resilience.heartbeat import file_age as heartbeat_file_age
from ..solver.common import SolveResult
from ..solver.graphs import tree_map
from .sweep import Mesh, _mesh_devices, pad_batch

#: the elastic tier's counters since they were last set to 0 (the JAX
#: package's recorder counters of the same names): ``chunks_reassigned``
#: (chunks taken over from a dead owner), ``chunk_retries`` and
#: ``chunks_corrupt`` (chunk files set aside on collection)
COUNTS = {"chunks_reassigned": 0, "chunk_retries": 0, "chunks_corrupt": 0}


def reset_counts():
    """Set every counter of the elastic tier to 0."""
    for k in COUNTS:
        COUNTS[k] = 0


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, timeout_s=None):
    """Join (or start) the ``gloo`` process group (module doc):
    ``coordinator_address`` (``"host:port"``, the rank-0 process's TCP
    store; ``None`` reads the ``MASTER_ADDR``/``MASTER_PORT``
    environment), ``num_processes`` and this process's ``process_id``;
    ``timeout_s`` bounds the group's collectives."""
    import datetime

    import torch.distributed as dist

    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id, **kw)


def _world():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize() "
                           "in every process first")
    return dist.get_world_size(), dist.get_rank()


def global_mesh(axis="batch", device=None):
    """A :class:`~.sweep.Mesh` with one device per process, in rank order:
    each process contributes ``device`` (``None``: its CUDA device), and
    the names are exchanged through the process group."""
    import torch.distributed as dist

    world, _ = _world()
    names = [None] * world
    dist.all_gather_object(names, str(resolve_device(device)))
    return Mesh(names, (axis,))


def _local_span(B, mesh):
    """This process's contiguous lanes and its mesh entries: the mesh
    lists each process's devices in rank order, an equal number each."""
    world, rank = _world()
    if mesh.size % world:
        raise ValueError(f"{mesh} does not give each of the {world} "
                         f"processes an equal number of devices")
    per_dev = B // mesh.size
    k = mesh.size // world
    return (slice(rank * k * per_dev, (rank + 1) * k * per_dev),
            Mesh(mesh.devices[rank * k:(rank + 1) * k], mesh.axis_names))


def scatter_batch(x, mesh, axis="batch"):
    """This process's shard of the host-replicated (B, ...) array ``x``
    (numpy or tensor), on its first mesh device."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    span, local = _local_span(int(x.shape[0]), mesh)
    return x[span].to(_mesh_devices(local)[0])


def gather_batch(t):
    """Every process's equal-shape shard of a per-lane tensor, concatenated
    in rank order on the host (a ``gloo`` all-gather)."""
    import torch.distributed as dist

    world, _ = _world()
    x = t.detach().cpu().contiguous()
    as_bool = x.dtype == torch.bool
    if as_bool:
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
    return out.to(torch.bool) if as_bool else out


def ensemble_solve_multihost(rhs, y0s, t0, t1, cfgs, *, mesh=None,
                             axis="batch", gather=True, device=None,
                             **solve_kw):
    """``ensemble_solve`` across the processes of the group (module doc).

    ``y0s`` (B, n) and each ``cfgs`` entry (B,) must be identical on every
    process (host-replicated); B must divide the mesh's device count (pad
    with ``sweep.pad_batch``).  ``mesh`` defaults to :func:`global_mesh`
    over ``device``.  Each process solves its lanes on its own mesh
    entries; ``solve_kw`` is ``ensemble_solve``'s, or with
    ``segment_steps > 0`` the segmented driver's (as in
    ``checkpointed_sweep``), and ``linsolve="auto"`` resolves with the
    whole batch.  With ``gather=True`` every per-lane result field comes
    back whole, on the host, on every process; ``gather=False`` returns
    this process's lanes."""
    from .checkpoint import _resolve_run_kw, _solve_chunk

    if mesh is None:
        mesh = global_mesh(axis, device)
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    y0s = torch.as_tensor(y0s)
    B = int(y0s.shape[0])
    if pad_batch(B, mesh) != B:
        raise ValueError(
            f"the mesh's device count {mesh.size} must divide the batch "
            f"size {B}; pad to {pad_batch(B, mesh)} lanes first "
            f"(pad_to_mesh/pad_batch)")
    span, local = _local_span(B, mesh)
    dev = _mesh_devices(local)[0]
    y_loc = y0s[span].to(dev)
    c_loc = {k: torch.as_tensor(v)[span].to(dev) for k, v in cfgs.items()}
    kw = _resolve_run_kw(dict(solve_kw), y_loc, B)
    if local.size > 1:
        kw["mesh"] = local
    res = _solve_chunk(rhs, y_loc, t0, t1, c_loc, kw)
    if not gather:
        return res
    return SolveResult(**{f: tree_map(gather_batch, getattr(res, f))
                          for f in SolveResult.__dataclass_fields__})


# ---------------------------------------------------------------------------
# the elastic tier
# ---------------------------------------------------------------------------

def _hosts_dir(ckpt_dir):
    d = os.path.join(ckpt_dir, "hosts")
    os.makedirs(d, exist_ok=True)
    return d


def _heartbeat_path(ckpt_dir, process_id):
    return os.path.join(_hosts_dir(ckpt_dir), f"p{int(process_id)}.hb")


def host_liveness(ckpt_dir, dead_after_s):
    """Per-process liveness from the heartbeat files:
    ``{process_id: (age_s, alive)}``, ``alive`` meaning heartbeat age <=
    ``dead_after_s`` (a missed beat reads as slow, not dead-forever)."""
    out = {}
    d = _hosts_dir(ckpt_dir)
    now = time.time()
    for name in sorted(os.listdir(d)):
        if not (name.startswith("p") and name.endswith(".hb")):
            continue
        pid = int(name[1:-3])
        age = heartbeat_file_age(os.path.join(d, name), now=now)
        if age is None:
            continue
        out[pid] = (age, age <= dead_after_s)
    return out


def elastic_checkpointed_sweep(rhs, y0s, t0, t1, cfgs, ckpt_dir, *,
                               process_id, num_processes, chunk_size=512,
                               heartbeat_s=0.5, dead_after_s=None,
                               poll_s=0.25, timeout_s=600.0, retry=None,
                               quarantine=None, chunk_budget_s=None,
                               chunk_log=None, recorder=None, oracle=None,
                               live=None, **solve_kw):
    """Wedge-resilient multi-process checkpointed sweep (module doc):
    every process runs this with the same arguments and its own
    ``process_id``; chunks are first partitioned round-robin, each solve
    is claimed (atomic ``O_EXCL`` claim file) and saved through the
    crash-atomic chunk writer, and once a process's own partition is done
    it scans for missing chunks whose claim owner has stopped heartbeating
    (``dead_after_s``, default ``6 x heartbeat_s``): those are taken over
    (claim rewritten atomically, counted in ``COUNTS["chunks_reassigned"]``)
    and solved by the survivor.  Two survivors racing for one chunk is
    benign: both write the same file, atomically.

    ``solve_kw`` is the per-chunk solver configuration
    (``checkpointed_sweep``'s, ``linsolve="auto"`` resolved with the whole
    sweep), and ``retry=``/``quarantine=``/``chunk_budget_s=`` work as
    there; a breach of the budget exhausts the retries, propagates and
    stops this process's heartbeat on the way out, so the peers take its
    chunks over.  The directory interoperates with a single-process
    ``checkpointed_sweep`` resume.  No attempt ledger is written
    (concurrent manifest rewrites would race); the claim files carry the
    ownership history.  ``recorder=``/``live=`` wait for ROADMAP A14 and
    ``oracle=`` for A16.

    Returns the full concatenated SolveResult (loaded from the chunk
    files, so every surviving process returns the same values).  Raises
    after ``timeout_s`` without progress (own, or peers' chunks
    appearing) while chunks are still missing."""
    from ..resilience import inject
    from ..resilience import quarantine as _quarantine
    from ..resilience.policy import (RETRYABLE, fallback_kwargs,
                                     normalize_quarantine, normalize_retry,
                                     retryable)
    from ..resilience.watchdog import WedgeError, reset_backend
    from ..solver.common import check_deferred
    from .checkpoint import (_CORRUPT_ERRORS, _ChunkBudget,
                             _check_segmented_knobs, _concat_results,
                             _resolve_run_kw, _solve_chunk,
                             _sweep_fingerprint, _wait_chunk,
                             ensure_manifest, host_result, load_result,
                             resolve_chunk_budget, save_result)

    check_deferred({"recorder": recorder, "live": live, "oracle": oracle},
                   (("recorder", None, "A14"), ("live", None, "A14"),
                    ("oracle", None, "A16")))
    if not (0 <= int(process_id) < int(num_processes)):
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    _check_segmented_knobs(solve_kw, ("pipeline", "poll_every",
                                      "fetch_deadline", "admission",
                                      "refill"))
    if dead_after_s is None:
        dead_after_s = 6.0 * float(heartbeat_s)
    retry = normalize_retry(retry)
    qpol = normalize_quarantine(quarantine)
    _quarantine.check_oracle(qpol)
    budget = _ChunkBudget(resolve_chunk_budget(chunk_budget_s))
    B = int(y0s.shape[0])
    n_chunks = -(-B // int(chunk_size))
    os.makedirs(ckpt_dir, exist_ok=True)
    pinned = {"B": B, "chunk_size": chunk_size, "t0": float(t0),
              "t1": float(t1),
              "fingerprint": _sweep_fingerprint(rhs, y0s, cfgs, solve_kw)}
    ensure_manifest(ckpt_dir, pinned)
    run_kw = _resolve_run_kw(solve_kw, y0s, B)
    hb = Heartbeat(_heartbeat_path(ckpt_dir, process_id), heartbeat_s,
                   name="br-elastic-heartbeat")
    hb.beat()
    hb.start()

    def chunk_path(i):
        return os.path.join(ckpt_dir, f"chunk_{i:05d}.npz")

    def claim_path(i):
        return chunk_path(i) + ".claim"

    def read_claim(i):
        try:
            with open(claim_path(i)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            # a torn claim (the writer died between the O_EXCL create and
            # the dump): a claim by an unknown owner aged by the file's
            # mtime, so the staleness path can take it over
            try:
                mtime = os.path.getmtime(claim_path(i))
            except OSError:
                return None
            return {"pid": -1, "time": mtime}

    def try_claim(i):
        """First claim via O_CREAT|O_EXCL: exactly one winner."""
        try:
            fd = os.open(claim_path(i),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"pid": int(process_id), "time": time.time()}, f)
        return True

    def steal_claim(i, owner):
        """Take a dead owner's chunk over: atomic claim rewrite."""
        tmp = claim_path(i) + f".steal{process_id}"
        with open(tmp, "w") as f:
            json.dump({"pid": int(process_id), "time": time.time(),
                       "stolen_from": int(owner)}, f)
        os.replace(tmp, claim_path(i))
        COUNTS["chunks_reassigned"] += 1
        if chunk_log is not None:
            chunk_log(f"[elastic] p{process_id} reassigned chunk {i} "
                      f"from dead p{owner}")

    def _subset_solve(y0_sub, cfg_sub, pass_name):
        kw = (run_kw if pass_name == "retry"
              else fallback_kwargs(qpol, run_kw))
        return _solve_chunk(rhs, y0_sub, t0, t1, cfg_sub, kw)

    def solve_and_save(i):
        lo = i * int(chunk_size)
        hi = min(lo + int(chunk_size), B)
        chunk_cfgs = {k: v[lo:hi] for k, v in cfgs.items()}
        attempts = (retry.max_retries if retry is not None else 0) + 1
        for attempt in range(attempts):
            try:
                t_start = time.perf_counter()
                res = _solve_chunk(rhs, y0s[lo:hi], t0, t1, chunk_cfgs,
                                   run_kw)
                _wait_chunk(res, budget.budget_for(hi - lo),
                            f"elastic-chunk{i}")
                break
            except RETRYABLE as e:
                last = attempt == attempts - 1 or not retryable(e)
                if chunk_log is not None:
                    chunk_log(f"[elastic] p{process_id} chunk {i} attempt "
                              f"{attempt} FAILED ({type(e).__name__}); "
                              f"{'giving up' if last else 'retrying'}")
                if last:
                    # propagates: the finally below stops the heartbeat,
                    # so the surviving peers take this process's chunks
                    raise
                COUNTS["chunk_retries"] += 1
                if isinstance(e, WedgeError):
                    reset_backend()
                time.sleep(retry.delay(attempt))
        wall = time.perf_counter() - t_start
        budget.observe(wall, hi - lo)
        # test-only: the NaN-lane simulation before the quarantine
        res = inject.poison_lanes(res, lo, hi)
        if qpol is not None:
            res, _ = _quarantine.resolve(res, y0s[lo:hi], chunk_cfgs,
                                         _subset_solve, policy=qpol)
        # test-only: the killed-process simulation exits here, after the
        # solve and before the save, so the chunk file stays missing and
        # the claim goes stale
        inject.kill_now(i)
        save_result(chunk_path(i), host_result(res), chunk_cfgs)
        if chunk_log is not None:
            chunk_log(f"[elastic] p{process_id} chunk {i} "
                      f"({hi - lo} lanes) solved+saved in {wall:.2f}s")

    def owner_dead(cl, live_hosts):
        """A claim owner is dead when its heartbeat (or, if it never beat,
        its claim) is older than ``dead_after_s``."""
        owner = int(cl.get("pid", -1))
        if owner in live_hosts:
            return not live_hosts[owner][1]
        return (time.time() - float(cl.get("time", 0))) > dead_after_s

    try:
        # pass 1: this process's own partition (round-robin)
        for i in range(n_chunks):
            if i % int(num_processes) != int(process_id):
                continue
            if os.path.exists(chunk_path(i)):
                continue
            cl = read_claim(i)
            if cl is not None and int(cl.get("pid", -1)) == int(process_id):
                solve_and_save(i)   # our own claim from a crashed run
            elif cl is None and try_claim(i):
                solve_and_save(i)
        # pass 2: take chunks over from the dead until all exist (or wait
        # for a live peer that is just slower); the timeout is time
        # without progress, own or observed
        deadline = time.time() + float(timeout_s)
        prev_missing = None
        while True:
            missing = [i for i in range(n_chunks)
                       if not os.path.exists(chunk_path(i))]
            if not missing:
                break
            if prev_missing is not None and len(missing) < prev_missing:
                deadline = time.time() + float(timeout_s)
            prev_missing = len(missing)
            progressed = False
            live_hosts = host_liveness(ckpt_dir, dead_after_s)
            for i in missing:
                cl = read_claim(i)
                if cl is None:
                    if try_claim(i):
                        solve_and_save(i)
                        progressed = True
                elif int(cl.get("pid", -1)) == int(process_id):
                    solve_and_save(i)
                    progressed = True
                elif owner_dead(cl, live_hosts):
                    steal_claim(i, int(cl.get("pid", -1)))
                    solve_and_save(i)
                    progressed = True
            if progressed:
                deadline = time.time() + float(timeout_s)
                continue
            if time.time() > deadline:
                raise RuntimeError(
                    f"elastic sweep p{process_id}: {len(missing)} "
                    f"chunk(s) still missing after {timeout_s:g}s without "
                    f"progress, every claim held by a live process "
                    f"({[read_claim(i) for i in missing]})")
            time.sleep(float(poll_s))

        # collect, still inside the heartbeat's lifetime: a chunk file that
        # exists but fails to load is set aside and re-solved here
        parts = []
        for i in range(n_chunks):
            try:
                parts.append(load_result(chunk_path(i))[0])
            except _CORRUPT_ERRORS as e:
                os.replace(chunk_path(i), chunk_path(i) + ".corrupt")
                COUNTS["chunks_corrupt"] += 1
                if chunk_log is not None:
                    chunk_log(f"[elastic] p{process_id} chunk {i} file "
                              f"corrupt ({type(e).__name__}): re-solving")
                solve_and_save(i)
                parts.append(load_result(chunk_path(i))[0])
    finally:
        hb.stop()
    return _concat_results(parts)
