"""Ensemble sweeps: one reactor condition per lane, lane-batched.

Port of ``batchreactor_tpu/parallel/sweep.py``: :func:`ensemble_solve`
(one solver call over the whole horizon), its forward-sensitivity twin
:func:`ensemble_solve_forward`, :func:`ensemble_solve_segmented` with its
two gears, shape buckets and the streaming continuous-batching driver,
:func:`temperature_sweep`, :func:`sweep_report`, :func:`ignition_observer`
and :func:`ignition_delay`.  Both solvers run under every entry point
(``method="bdf"`` or ``"sdirk"``).

A segment is one solve bounded to ``segment_steps`` attempts per lane;
between segments terminated lanes are parked at ``t1`` (they re-enter as
zero-span solves that change nothing) and the others resume from the
carried state (BDF's history, SDIRK's step size and PI memory).  The
segmented driver has two gears, bit for bit the same:

* **blocking** (``pipeline=False``): the solver's own loops, which stop
  each loop once no lane needs it, and the park/budget bookkeeping in host
  numpy arrays.  Every Newton iteration, window attempt and window costs a
  host sync.  It is the reference gear.
* **pipelined** (the default, as in the JAX package): a segment is three
  steps of a :class:`~..solver.graphs.Program`, captured as CUDA graphs on
  the card and run eagerly on the CPU: ``begin`` (the solver's entry from
  the segment carry), ``window`` (one fixed-trip step window:
  ``make_stepper(...).window(carry, fixed=True)``, every attempt and
  every Newton iteration run under the lanes' own masks, so it makes no
  host decision) and ``end`` (the control block: parking, the
  ``final_status``/``final_t`` latch, the exact ``max_attempts`` budget,
  the accepted/rejected accumulators and the trajectory gather, all on
  the device).  The host replays ``window`` until the in-segment flag (any
  lane still running this segment, one int copied to pinned memory behind
  a CUDA event) reads 0, so a segment runs exactly the windows the
  blocking gear's loop runs and no replay is wasted; after ``end`` it
  reads one more flag, any lane still live, and stops there.  That is
  one host sync per window against one per Newton iteration.  The status
  vector (``final_status``, accepted steps) is copied to the host without
  a wait behind a segment's ``end`` and read at the flag that follows; the
  host acts on it every ``poll_every`` segments (``progress``, the
  streaming driver's harvests, compactions and shifts).
  Trajectory rows (``n_save``) are gathered on the device lane-major and
  copied to the host on a side stream by a drain thread.

``buckets=`` pads the lane count onto a ladder rung (``aot/buckets.py``)
with dead copies of the last lane, stripped from every result, so any
sweep size replays the graphs of a small set of shapes.  ``admission=``
streams the lanes through a fixed number of resident slots
(:func:`_run_segmented_streaming`): finished lanes are harvested at poll
points, a captured compaction moves live lanes to the front and refills
the freed slots from the backlog, and the resident program shifts down
(or, with ``upshift=``, up) the bucket ladder.  Results come back in the
caller's lane order.

``mesh=`` (a :class:`Mesh`) splits the lanes over the mesh's devices: the
batch is padded to a multiple of the device count with copies of the last
lane, each device solves its contiguous shard on a host thread of its own
(shards that share a device run one after another on that device's
thread), with no collective, and the results come back in the caller's
lane order.  The callables run on every shard's device as given: on a mesh
of several CUDA devices they must not close over tensors of another device
(``batch_reactor_sweep(mesh=)`` builds them per device).
``mesh_resident=`` splits a streaming sweep the same way, one stream per
device.  ``fetch_deadline=`` bounds every blocking host read of the
segmented drivers (the choke point in ``solver/graphs.py``) and raises
``resilience.WedgeError`` past it.

Telemetry (``obs/``): ``stats=True``/``timeline=N`` on every entry point
carry the solvers' per-lane counters and attempt rings (``SolveResult.
stats``), folded across segments as the step counts are (counters by a
masked add, the gauge by max, the ring replaced), moved with their lane
through the streaming driver's compactions and un-shuffled at harvest;
they come back with each gear's existing fetches, so no host sync is
added.  ``recorder=`` (an ``obs.Recorder``) gets the ``segment``, ``poll``
and ``compact`` spans, the reference's counters (``blocking_syncs`` is
the run's host syncs: ``graphs.recording``) and the occupancy pair;
``watch=`` (an ``obs.CompileWatch``) sees the programs built and the
graphs captured under the ``sweep-segment``/``sweep-compact`` labels;
``live=`` (an ``obs.LiveRegistry``) gets an in-flight publish at each
status poll and is retired on return.

Functions take the device of the tensors they are given.  The serving
hook ``_feed`` (with ``admission=``) appends lanes to the streaming
driver's backlog while it runs; the serving scheduler feeds it.
"""

import contextlib
import os
import queue
import threading
import warnings

import numpy as np
import torch

from ..aot.buckets import downshift_bucket, resolve_bucket, upshift_bucket
from ..obs import counters as obs_counters
from ..obs.recorder import span_or_null
from ..obs.retrace import CompileWatch
from ..obs.timeline import validate as validate_timeline
from ..solver import bdf, graphs, sdirk
from ..solver.common import (DT_UNDERFLOW, MAX_STEPS_REACHED, RUNNING,
                             SUCCESS, SolveResult, check_deferred,
                             jacfwd_lanes)
from ..solver.linalg import factor_zeros, resolve_linsolve

_SOLVERS = {"sdirk": sdirk.solve, "bdf": bdf.solve}

# (keyword, default, ROADMAP item) of the JAX sweep's options that wait
# for a later slice: none left
_DEFERRED = ()

#: the streaming driver's counters since they were last set to 0 (the
#: JAX package's recorder counters of the same names): ``compactions``,
#: ``admitted_lanes`` (backlog lanes admitted into freed slots),
#: ``harvested_lanes``, ``bucket_downshifts``, ``bucket_upshifts``, and
#: the occupancy pair ``lane_attempts`` (accepted + rejected attempts of
#: the caller's lanes) over ``lane_capacity`` (segments x resident slots x
#: ``segment_steps``)
STREAM_COUNTS = {"compactions": 0, "admitted_lanes": 0,
                 "harvested_lanes": 0, "bucket_downshifts": 0,
                 "bucket_upshifts": 0, "lane_attempts": 0,
                 "lane_capacity": 0}
# streams of mesh_resident= add their counts from one thread each
_STREAM_LOCK = threading.Lock()


def reset_stream_counts():
    """Set every streaming counter to 0."""
    with _STREAM_LOCK:
        for k in STREAM_COUNTS:
            STREAM_COUNTS[k] = 0


def resolve_pipeline_defaults(pipeline=None, poll_every=None):
    """The resolution rule for the segmented gear knobs: explicit values
    pass through; ``None`` resolves from ``BENCH_PIPELINE`` (pipelined
    unless it is ``"0"``) and ``BENCH_POLL_EVERY`` (default 4), the
    variables the JAX package reads."""
    if pipeline is None:
        pipeline = os.environ.get("BENCH_PIPELINE", "1") != "0"
    if poll_every is None:
        poll_every = int(os.environ.get("BENCH_POLL_EVERY", "4"))
    return bool(pipeline), int(poll_every)


def resolve_admission(admission=None, refill=None, *, n_lanes=None):
    """The validation and resolution rule for ``admission``/``refill``.

    * ``admission=None``/``False`` — continuous batching off; ``refill``
      must be ``None`` too.
    * ``admission=True`` — resident slots = the whole lane count (the
      compaction and down-shift gear alone).
    * ``admission=int k >= 1`` — ``k`` resident slots; the other lanes
      form the backlog.
    * ``refill=None`` — 0.25; a float in (0, 1] is a fraction of the
      resident slots, an int >= 1 a count of freed slots.

    Returns ``(resident, refill_spec)``, ``resident=None`` when off; the
    driver converts a fraction to slots after bucket padding
    (:func:`_refill_slots`)."""
    if admission is None or admission is False:
        if refill is not None:
            raise ValueError(
                "refill= tunes the admission queue; pass admission= "
                "(resident lane count, or True) or drop the argument")
        return None, None
    if admission is True:
        if not n_lanes:
            raise ValueError("admission=True needs a known lane count")
        resident = int(n_lanes)
    elif isinstance(admission, bool) or not isinstance(
            admission, (int, np.integer)):
        raise ValueError(
            f"admission must be None/False (off), True (resident = all "
            f"lanes), or a positive int resident lane count; got "
            f"{admission!r}")
    else:
        resident = int(admission)
        if resident < 1:
            raise ValueError(
                f"admission resident lane count must be >= 1, got "
                f"{resident}")
    if refill is None:
        refill_spec = 0.25
    elif isinstance(refill, bool):
        raise ValueError(
            f"refill must be a fraction in (0, 1] or a positive int "
            f"freed-slot count; got {refill!r}")
    elif isinstance(refill, (int, np.integer)):
        if refill < 1:
            raise ValueError(
                f"refill slot count must be >= 1, got {refill}")
        refill_spec = int(refill)
    elif isinstance(refill, float):
        if not 0.0 < refill <= 1.0:
            raise ValueError(
                f"refill fraction must be in (0, 1], got {refill}")
        refill_spec = float(refill)
    else:
        raise ValueError(
            f"refill must be a fraction in (0, 1] or a positive int "
            f"freed-slot count; got {refill!r}")
    return resident, refill_spec


def _refill_slots(refill_spec, B):
    """Freed-slot threshold for a ``B``-slot resident program (fractions
    round up; thresholds clamp to [1, B])."""
    if isinstance(refill_spec, int):
        return max(1, min(refill_spec, B))
    return max(1, min(B, int(np.ceil(refill_spec * B))))


class Mesh:
    """A 1-D device mesh (the port of ``jax.sharding.Mesh`` as the sweeps
    use it): ``devices``, the torch devices the lanes split over in order
    (a device may appear more than once), and ``axis_names``, the name of
    the lane axis (``("batch",)``)."""

    def __init__(self, devices, axis_names=("batch",)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.axis_names = tuple(axis_names)

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names})")


def make_mesh(devices=None, axis="batch"):
    """1-D mesh over the given devices, or every CUDA device (raises
    without a GPU: the port never falls back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] "
                "for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis,))


def pad_batch(batch_size, mesh):
    """Smallest multiple of the device count (a :class:`Mesh` or an int)
    >= ``batch_size`` (the lane count an even split needs; the padding
    lanes are copies)."""
    n = mesh.size if isinstance(mesh, Mesh) else int(mesh)
    return ((int(batch_size) + n - 1) // n) * n


def _check_mesh(mesh, axis):
    """A mesh whose axis is ``axis`` and whose CUDA devices exist here."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    for d in mesh.devices:
        if d.type == "cuda" and not (torch.cuda.is_available() and (
                d.index or 0) < torch.cuda.device_count()):
            raise RuntimeError(f"{mesh} lists {d}, which does not exist "
                               f"here")


def _mesh_devices(mesh):
    """The mesh's devices, a CUDA device without an index taken as the
    current one."""
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in mesh.devices]


def _cat_results(parts):
    """SolveResults of consecutive lane blocks as one, every per-lane
    field concatenated on the first block's device."""
    out = {}
    for f in SolveResult.__dataclass_fields__:
        vals = [getattr(p, f) for p in parts]
        out[f] = None if vals[0] is None else graphs.tree_map(
            lambda x, *rest: torch.cat([x] + [r.to(x.device)
                                              for r in rest]), *vals)
    return SolveResult(**out)


def _mesh_map(mesh, y0s, cfgs, solve):
    """Split the lanes of ``y0s``/``cfgs`` over ``mesh`` and solve them
    (module doc): ``solve(device, y0_shard, cfg_shard)`` per shard, on one
    host thread per distinct device (inline with one device), and the
    shards' results concatenated in lane order, the padding stripped."""
    B = y0s.shape[0]
    devices = _mesh_devices(mesh)
    y0p, cfgp = _pad_lanes(y0s, cfgs, pad_batch(B, mesh) - B)
    per = y0p.shape[0] // len(devices)
    results = [None] * len(devices)
    by_dev = {}
    for i, d in enumerate(devices):
        by_dev.setdefault(d, []).append(i)

    def work(dev, idx):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            for i in idx:
                sl = slice(i * per, (i + 1) * per)
                results[i] = solve(dev, y0p[sl].to(dev),
                                   {k: v[sl].to(dev)
                                    for k, v in cfgp.items()})

    if len(by_dev) == 1:
        work(*next(iter(by_dev.items())))
    else:
        errors = []

        def run(dev, idx):
            try:
                work(dev, idx)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=item, daemon=True,
                                    name=f"br-mesh-{item[0]}")
                   for item in by_dev.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    return unpad_result(_cat_results(results), B)


def _pad_lanes(y0s, cfgs, n_pad):
    """Append ``n_pad`` dead lanes, copies of the last lane: they finish
    exactly when their source does, never touch a live lane, and are
    stripped by :func:`unpad_result`."""
    if not n_pad:
        return y0s, cfgs
    y0s = torch.cat([y0s, y0s[-1:].expand((n_pad,) + y0s.shape[1:])])
    cfgs = {k: torch.cat([v, v[-1:].expand((n_pad,) + v.shape[1:])])
            for k, v in cfgs.items()}
    return y0s, cfgs


def pad_to_mesh(y0s, cfgs, mesh):
    """Pad the lane axis to a multiple of the mesh's device count with
    copies of the last lane.  Returns (y0s, cfgs, original_B); slice
    results back with :func:`unpad_result`."""
    B = y0s.shape[0]
    y0s, cfgs = _pad_lanes(y0s, cfgs, pad_batch(B, mesh) - B)
    return y0s, cfgs, B


def pad_to_bucket(y0s, cfgs, bucket):
    """Pad the lane axis up to ``bucket`` lanes with dead copy-lanes.
    Returns (y0s, cfgs, original_B); slice results back with
    :func:`unpad_result`."""
    B = y0s.shape[0]
    if bucket < B:
        raise ValueError(f"bucket {bucket} < lane count {B}")
    y0s, cfgs = _pad_lanes(y0s, cfgs, bucket - B)
    return y0s, cfgs, B


def _slice_lanes(x, B):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _slice_lanes(v, B) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_slice_lanes(v, B) for v in x)
    return x[:B] if x.ndim >= 1 else x


def unpad_result(res, B):
    """A SolveResult sliced back to its first ``B`` lanes (every per-lane
    tensor, the observer fold and the solver state too); the inverse of
    :func:`pad_to_bucket`, a no-op when nothing was padded."""
    if int(res.y.shape[0]) == B:
        return res
    return SolveResult(**{f: _slice_lanes(getattr(res, f), B)
                          for f in SolveResult.__dataclass_fields__})


def _check_method(method, newton_tol):
    if method not in _SOLVERS:
        raise ValueError(f"unknown method {method!r}; use "
                         f"{sorted(_SOLVERS)}")
    if method != "sdirk" and newton_tol != 0.03:
        # bdf derives its Newton tolerance from rtol, CVODE-style
        raise ValueError(
            f"newton_tol is an sdirk-only knob; method={method!r} "
            f"got newton_tol={newton_tol}")


def _solver_kw(method, newton_tol, jac_window, setup_economy, stale_tol,
               freeze_precond=False):
    """The method-specific keywords of one solver call."""
    if method == "sdirk":
        return {"jac_window": jac_window, "newton_tol": newton_tol}
    return {"jac_window": jac_window, "freeze_precond": freeze_precond,
            "setup_economy": setup_economy, "stale_tol": stale_tol}


def _lane_obs(observer, observer_init, B, dt, dev):
    """``observer_init`` broadcast to (B,) lanes (None without observer)."""
    if observer is None:
        return None
    return {k: torch.as_tensor(v, dtype=dt, device=dev).expand(B).clone()
            for k, v in observer_init.items()}


def ensemble_solve(rhs, y0s, t0, t1, cfgs, *, rtol=1e-6, atol=1e-10,
                   max_steps=200_000, n_save=0, dt0=None, dt_min_factor=1e-22,
                   linsolve="auto", jac=None, observer=None,
                   observer_init=None, jac_window=1, newton_tol=0.03,
                   method="bdf", freeze_precond=False, setup_economy=False,
                   stale_tol=0.3, buckets=None, mesh=None, axis="batch",
                   stats=False, timeline=None):
    """Solve every lane of ``y0s`` (B, n) over [t0, t1] in one solver call
    of at most ``max_steps`` attempts per lane.  ``cfgs`` is a dict of
    per-lane tensors; ``t0``/``t1`` are shared.  Returns the solver's
    SolveResult.

    ``method`` is ``"bdf"`` or ``"sdirk"``; ``newton_tol`` is SDIRK's and
    ``freeze_precond``/``setup_economy``/``stale_tol`` are BDF's (each
    raises under the other method).  ``linsolve="auto"`` resolves here
    with the sweep's (padded) B and n (``solver.linalg.resolve_linsolve``),
    so ``"lu32p"`` self-selects for BDF on the GPU at B * n >=
    LU32P_MIN_BN.  ``observer_init`` may hold Python floats; they are
    broadcast to (B,) lanes.  ``buckets`` pads B onto a ladder rung
    (``aot/buckets.py``) with dead copies of the last lane, stripped from
    the result.  ``mesh`` (a :class:`Mesh` whose axis is ``axis``) splits
    the lanes over its devices (module doc); ``"auto"`` then resolves with
    the whole padded batch, so every shard runs the same linear algebra.
    ``stats=True``/``timeline=N`` return the solver's per-lane counters and
    attempt rings in ``SolveResult.stats`` (``obs/counters.py``)."""
    timeline = validate_timeline(timeline, stats)
    _check_method(method, newton_tol)
    if freeze_precond and method != "bdf":
        raise ValueError(
            f"freeze_precond is a bdf-only knob; method={method!r}")
    if setup_economy and method != "bdf":
        raise ValueError(
            f"setup_economy is a bdf-only knob; method={method!r}")
    if mesh is not None:
        _check_mesh(mesh, axis)
        B_live = y0s.shape[0]
        y0s, cfgs, _ = pad_to_bucket(y0s, cfgs, resolve_bucket(
            B_live, buckets, mesh_size=mesh.size))
        kw = dict(rtol=rtol, atol=atol, max_steps=max_steps, n_save=n_save,
                  dt0=dt0, dt_min_factor=dt_min_factor, jac=jac,
                  observer=observer, observer_init=observer_init,
                  jac_window=jac_window, newton_tol=newton_tol,
                  method=method, freeze_precond=freeze_precond,
                  setup_economy=setup_economy, stale_tol=stale_tol,
                  stats=stats, timeline=timeline,
                  linsolve=resolve_linsolve(
                      linsolve, method=method,
                      device=_mesh_devices(mesh)[0],
                      batch=pad_batch(y0s.shape[0], mesh), n=y0s.shape[1]))
        return unpad_result(_mesh_map(
            mesh, y0s, cfgs, lambda dev, y, c: ensemble_solve(
                rhs, y, t0, t1, c, **kw)), B_live)
    B_live = y0s.shape[0]
    y0s, cfgs, _ = pad_to_bucket(y0s, cfgs, resolve_bucket(B_live, buckets))
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    linsolve = resolve_linsolve(linsolve, method=method, device=dev,
                                batch=B, n=n)
    return unpad_result(_SOLVERS[method](
        rhs, y0s, float(t0), float(t1), cfgs, rtol=rtol, atol=atol,
        max_steps=max_steps, n_save=n_save, dt0=dt0,
        dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
        observer=observer,
        observer_init=_lane_obs(observer, observer_init, B, dt, dev),
        stats=stats, timeline=timeline,
        **_solver_kw(method, newton_tol, jac_window, setup_economy,
                     stale_tol, freeze_precond)), B_live)


def ensemble_solve_forward(rhs_theta, y0s, t0, t1, theta, cfgs, *,
                           mesh=None, axis="batch", rtol=1e-6, atol=1e-10,
                           max_steps=200_000, jac=None, jac_window=1,
                           linsolve="auto", sens_iters=2, S0=None,
                           stats=False):
    """Forward-sensitivity ensemble sweep: one theta, per-lane conditions.

    The sensitivity twin of :func:`ensemble_solve`: every lane integrates
    state and tangents S = dy/dtheta in one tangent-carrying BDF solve
    (``sensitivity.forward.solve_forward``); ``result.tangents`` is
    (B, P, n) with rows in ``sensitivity.params.names`` order.  The
    tangents leave the state's step grid as the plain solve takes it.

    ``rhs_theta(t, y, theta, cfg)`` is the theta-parameterized RHS
    (``sensitivity.params.make_rhs_theta``); ``theta`` (a dict of (K,)
    tensors) is shared by the lanes.  ``jac`` is the analytic Jacobian at
    that theta.  ``S0`` defaults to zeros.  ``linsolve="auto"`` resolves
    with the sweep's B and n (``solver.linalg.resolve_linsolve``), so a
    GRI-3.0 sweep at B = 1024 takes ``"lu32p"`` on the GPU and every
    tangent solve goes through the kernel's factor.  ``mesh`` splits the
    lanes (and ``S0``) over its devices as :func:`ensemble_solve` does,
    ``theta`` copied to each.  ``stats=True`` returns the per-lane
    counters in ``SolveResult.stats``."""
    from ..sensitivity.forward import solve_forward

    B, n = y0s.shape
    if mesh is not None:
        _check_mesh(mesh, axis)
        ls = resolve_linsolve(linsolve, method="bdf",
                              device=_mesh_devices(mesh)[0],
                              batch=pad_batch(B, mesh), n=n)
        lanes = dict(cfgs)
        per_lane_s0 = S0 is not None and S0.ndim == 3
        if per_lane_s0:
            lanes["__S0"] = S0

        def shard(dev, y, c):
            c = dict(c)
            s0 = (c.pop("__S0") if per_lane_s0 else
                  None if S0 is None else S0.to(dev))
            return ensemble_solve_forward(
                rhs_theta, y, t0, t1, {k: v.to(dev)
                                       for k, v in theta.items()}, c,
                rtol=rtol, atol=atol, max_steps=max_steps, jac=jac,
                jac_window=jac_window, linsolve=ls, sens_iters=sens_iters,
                S0=s0, stats=stats)

        return _mesh_map(mesh, y0s, lanes, shard)
    linsolve = resolve_linsolve(linsolve, method="bdf", device=y0s.device,
                                batch=B, n=n)
    return solve_forward(rhs_theta, y0s, float(t0), float(t1), theta, cfgs,
                         rtol=rtol, atol=atol, max_steps=max_steps, jac=jac,
                         jac_window=jac_window, linsolve=linsolve,
                         sens_iters=sens_iters, S0=S0, stats=stats)


def temperature_sweep(rhs, y0, T_grid, t1, base_cfg=None, **kw):
    """One initial state ``y0`` (n,) swept over a temperature grid (B,),
    on ``y0``'s device: ``cfg["T"]`` is the grid, ``base_cfg`` values are
    broadcast to the lanes, and ``kw`` goes to :func:`ensemble_solve`."""
    dt, dev = y0.dtype, y0.device
    T_grid = torch.as_tensor(T_grid, dtype=dt, device=dev)
    B = T_grid.shape[0]
    y0s = y0.expand((B,) + tuple(y0.shape)).clone()
    cfg = {k: torch.as_tensor(v, dtype=dt, device=dev).expand(B).clone()
           for k, v in (base_cfg or {}).items()}
    cfg["T"] = T_grid
    return ensemble_solve(rhs, y0s, 0.0, t1, cfg, **kw)


def ensemble_solve_segmented(rhs, y0s, t0, t1, cfgs, *, segment_steps=1024,
                             max_segments=10_000, max_attempts=None,
                             progress=None, rtol=1e-6, atol=1e-10,
                             linsolve="auto", jac=None, observer=None,
                             observer_init=None, dt_min_factor=1e-22,
                             n_save=0, rhs_bundle=None, jac_window=1,
                             newton_tol=0.03, method="bdf",
                             setup_economy=False, stale_tol=0.3,
                             pipeline=None, poll_every=None, buckets=None,
                             admission=None, refill=None, upshift=None,
                             upshift_patience=2, mesh=None, axis="batch",
                             fetch_deadline=None, mesh_resident=None,
                             stats=False, recorder=None, watch=None,
                             timeline=None, live=None, _live_source="sweep",
                             _on_harvest=None, _feed=None, **deferred):
    """Solve every lane of ``y0s`` (B, n) over [t0, t1] with the device
    work bounded to ``segment_steps`` step attempts per lane per segment;
    segments repeat until every lane terminates.

    State carried between segments: per-lane (t, y, next h, observer fold,
    and BDF's history with, under ``setup_economy``, the carried
    factorization, or SDIRK's PI controller memory ``err_prev``).
    A lane that terminates is parked at ``t1`` so later segments hold it
    (a zero-span solve).  ``max_attempts`` bounds accepted + rejected
    attempts per lane across segments, parking a lane that reaches it
    with MAX_STEPS_REACHED.  ``n_save`` > 0 keeps the first ``n_save``
    accepted rows per lane in host arrays; each segment's device buffer is
    ``min(n_save, segment_steps)`` rows.  ``progress(payload)`` is called
    once per segment with the segment index, lanes done, lane count,
    accepted total and, with ``n_save``, the accepted times drained; the
    pipelined gear calls it at its status polls.

    ``pipeline`` picks the gear (module doc): ``None`` resolves to the
    pipelined gear (``BENCH_PIPELINE=0`` flips the default), ``False`` is
    the blocking gear, the reference; the two are bit for bit the same.
    ``poll_every`` (default 4, ``BENCH_POLL_EVERY``) is the pipelined
    gear's stride of status polls.  On CUDA the pipelined gear replays
    CUDA graphs and raises if a capture or a replay fails; it never falls
    back to the eager loop.

    ``rhs_bundle``: ``rhs`` is then a builder, ``rhs(bundle) -> (rhs_fn,
    jac_fn)`` (``jac`` is ignored; ``jac_fn=None`` takes the
    ``torch.func.jacfwd`` fallback), and the bundle's tensors are copied
    into the pipelined program's static inputs.  The program is keyed by
    the builder, the bundle's shapes and a digest of its values (the
    kinetics derive index tensors from the stoichiometry once per tensor),
    so re-parsed copies of one mechanism replay one set of graphs.

    ``buckets`` pads the lane count onto a ladder rung (``aot/buckets.py``)
    with dead copies of the last lane, stripped from the result;
    ``progress`` reports the padded count.  ``admission``/``refill``
    (grammar :func:`resolve_admission`) stream the lanes through a fixed
    number of resident slots (:func:`_run_segmented_streaming`); they need
    the pipelined gear and ``n_save=0``.  ``upshift`` (a resident-lane
    ceiling >= the resident count, with a ``buckets`` ladder) lets a
    backlogged stream climb the ladder, one rung per shift, after
    ``upshift_patience`` qualifying polls.

    ``linsolve="auto"`` resolves here with the sweep's padded B and n
    (``solver.linalg.resolve_linsolve``), so ``"lu32p"`` self-selects on
    the GPU at B * n >= LU32P_MIN_BN.  ``observer_init`` may hold Python
    floats; they are broadcast to (B,) lanes.

    ``mesh`` (a :class:`Mesh` whose axis is ``axis``; not with
    ``admission``) splits the lanes over its devices (module doc; the
    bundle of ``rhs_bundle`` is copied to each), with ``"auto"`` resolved
    for the whole padded batch.  ``mesh_resident`` (with ``admission``:
    ``True`` for every device of the lanes' kind, an int for the first
    that many, or a :class:`Mesh`) runs one stream per device, each with
    ``admission / devices`` resident slots over its share of the lanes.
    ``fetch_deadline`` (seconds; ``None`` resolves from
    ``BR_FETCH_DEADLINE_S``, unset = off) bounds every blocking host read
    of the segmented driver (the gears' flag reads, the drain thread's
    copies, the blocking gear's loop breaks) and raises
    ``resilience.WedgeError`` past it; off, a read adds nothing.

    ``_on_harvest(gids, payload)`` (streaming driver only: the
    ``checkpointed_sweep`` backlog mode) is called at each harvest with
    the caller's lane indices and their host rows (``t``, ``y``,
    ``status``, ``h``, ``n_accepted``, ``n_rejected`` and, with an
    observer, ``observed``; with ``stats``, ``stats``).  ``_feed(n_space,
    idle)`` (streaming driver only: the serving scheduler's hook) makes the
    backlog live: once the static backlog is used up and slots have
    parked, the driver harvests, then asks the feed for up to ``n_space``
    more lanes (the free slots, plus the up-shift headroom when
    ``upshift`` is armed); the feed returns ``(y0_rows, cfg_rows)`` host
    blocks, whose lanes take the next indices, or ``None`` to close for
    good.  With ``idle=True`` no resident lane is running: the feed may
    block until work arrives, and an empty answer then closes it.  While
    a feed is open the drain-tail down-shift does not fire.

    Telemetry (module doc): ``stats=True`` returns each lane's counters
    summed over the segments it ran in (``SolveResult.stats``), and
    ``timeline=N`` (with ``stats``) its last N attempts, the ring resumed
    across segments on the global attempt index, so it equals the
    monolithic solve's at ``jac_window=1``; both gears give equal values,
    bit for bit.  ``recorder`` gets spans and counters (``None``: the
    thread's current recorder, ``obs.recording``), ``watch`` the
    builds and captures (with a recorder and no watch, a private watch
    whose retraces land as recorder events), ``live`` an in-flight
    publish at each status poll under the source ``_live_source``.
    """
    from ..resilience.watchdog import resolve_fetch_deadline

    check_deferred(deferred, _DEFERRED)
    if recorder is None:
        recorder = graphs.current_recorder()
    timeline = validate_timeline(timeline, stats)
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    pipeline, poll_every = resolve_pipeline_defaults(pipeline, poll_every)
    if poll_every < 1:
        raise ValueError(f"poll_every must be >= 1, got {poll_every}")
    _check_method(method, newton_tol)
    if setup_economy and method != "bdf":
        raise ValueError(
            f"setup_economy is a bdf-only knob; method={method!r}")
    fetch_deadline = resolve_fetch_deadline(fetch_deadline)
    resident, refill_spec = resolve_admission(admission, refill,
                                              n_lanes=y0s.shape[0])
    if _feed is not None and resident is None:
        # a live backlog exists only on the streaming driver: ignoring the
        # feed would strand every lane it was going to supply
        raise ValueError(
            "_feed is a streaming-driver hook; pass admission= (continuous "
            "batching) or drop the feed")
    if mesh is not None:
        _check_mesh(mesh, axis)
        if resident is not None or _on_harvest is not None:
            raise ValueError(
                "admission= is incompatible with mesh= (each device would "
                "need the whole backlog); use mesh_resident= to stream "
                "over several devices")
        B_live = y0s.shape[0]
        y0s, cfgs, _ = pad_to_bucket(y0s, cfgs, resolve_bucket(
            B_live, buckets, mesh_size=mesh.size))
        seg_kw = dict(
            segment_steps=segment_steps, max_segments=max_segments,
            max_attempts=max_attempts, progress=progress, rtol=rtol,
            atol=atol, jac=jac, observer=observer,
            observer_init=observer_init, dt_min_factor=dt_min_factor,
            n_save=n_save, jac_window=jac_window, newton_tol=newton_tol,
            method=method, setup_economy=setup_economy, stale_tol=stale_tol,
            pipeline=pipeline, poll_every=poll_every,
            fetch_deadline=fetch_deadline, upshift=upshift,
            stats=stats, timeline=timeline, recorder=recorder,
            watch=watch, live=live,
            linsolve=resolve_linsolve(
                linsolve, method=method, device=_mesh_devices(mesh)[0],
                batch=pad_batch(y0s.shape[0], mesh), n=y0s.shape[1]))
        return unpad_result(_mesh_map(
            mesh, y0s, cfgs, lambda dev, y, c: ensemble_solve_segmented(
                rhs, y, t0, t1, c, rhs_bundle=_to_device(rhs_bundle, dev),
                _live_source=f"{_live_source}-{dev}", **seg_kw)), B_live)
    kw = dict(segment_steps=int(segment_steps),
              max_segments=int(max_segments), max_attempts=max_attempts,
              rtol=rtol, atol=atol, linsolve=linsolve,
              jac=None if rhs_bundle is not None else jac,
              observer=observer, dt_min_factor=dt_min_factor,
              jac_window=jac_window, newton_tol=newton_tol, method=method,
              setup_economy=setup_economy, stale_tol=float(stale_tol),
              rhs_bundle=rhs_bundle, progress=progress,
              poll_every=poll_every, stats=stats, timeline=timeline,
              recorder=recorder, live=live)
    if resident is not None:
        if not pipeline:
            raise ValueError(
                "admission= needs the pipelined gear (the compaction/"
                "refill step rides the run-ahead dispatch); drop "
                "pipeline=False or the admission knobs")
        if n_save:
            raise ValueError(
                "admission= requires n_save=0 (a per-lane trajectory "
                "buffer does not survive slot reuse); stream reductions "
                "through observer= instead")
        if upshift is not None:
            if buckets is None:
                raise ValueError(
                    "upshift= climbs the buckets= ladder (aot/buckets."
                    "py); pass buckets= or drop the upshift knob")
            if (isinstance(upshift, bool)
                    or not isinstance(upshift, (int, np.integer))
                    or int(upshift) < resident):
                raise ValueError(
                    f"upshift must be an int resident-lane ceiling >= "
                    f"the admission resident count ({resident}); got "
                    f"{upshift!r}")
        if int(upshift_patience) < 1:
            raise ValueError(
                f"upshift_patience must be >= 1, got {upshift_patience}")
        devs = _resolve_mesh_resident(mesh_resident, y0s.device)
        if devs is not None and len(devs) > 1:
            if _on_harvest is not None or _feed is not None:
                raise ValueError("_on_harvest and _feed serve one stream's "
                                 "lane indices; drop mesh_resident=")
            n_dev = len(devs)
            if resident % n_dev:
                raise ValueError(
                    f"admission={resident} resident slots do not divide "
                    f"over the {n_dev} devices of mesh_resident")
            kw.pop("jac")
            kw.pop("rhs_bundle")
            kw.update(max_attempts=max_attempts, observer_init=observer_init,
                      buckets=buckets, refill=refill,
                      upshift=None if upshift is None else upshift // n_dev,
                      upshift_patience=upshift_patience, pipeline=True,
                      fetch_deadline=fetch_deadline, watch=watch)
            return _mesh_map(
                Mesh(devs), y0s, cfgs,
                lambda dev, y, c: ensemble_solve_segmented(
                    rhs, y, t0, t1, c, jac=jac,
                    rhs_bundle=_to_device(rhs_bundle, dev),
                    admission=resident // n_dev,
                    _live_source=f"{_live_source}-{dev}", **kw))
        with _telemetry(recorder, watch, fetch_deadline) as watch:
            return _run_segmented_streaming(
                rhs, y0s, float(t0), float(t1), cfgs, observer_init,
                resident=resident, refill_spec=refill_spec, buckets=buckets,
                upshift=None if upshift is None else int(upshift),
                upshift_patience=int(upshift_patience),
                on_harvest=_on_harvest, feed=_feed, watch=watch,
                live_source=str(_live_source), **kw)
    if _on_harvest is not None:
        raise ValueError("_on_harvest is a streaming-driver hook; pass "
                         "admission= (continuous batching) or drop it")
    if mesh_resident:
        raise ValueError(
            "mesh_resident= splits the streaming admission driver over "
            "devices; pass admission= (continuous batching) or use mesh= "
            "for static sweeps")
    if upshift is not None:
        raise ValueError(
            "upshift= autoscales the streaming admission driver's "
            "resident bucket; pass admission= (continuous batching) or "
            "drop the upshift knobs")
    B_live = y0s.shape[0]
    y0s, cfgs, _ = pad_to_bucket(y0s, cfgs, resolve_bucket(B_live, buckets))
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    kw["linsolve"] = resolve_linsolve(linsolve, method=method, device=dev,
                                      batch=B, n=n)
    obs0 = _lane_obs(observer, observer_init, B, dt, dev)
    with _telemetry(recorder, watch, fetch_deadline) as watch:
        if pipeline:
            res = _run_segmented_pipelined(
                rhs, y0s, float(t0), float(t1), cfgs, obs0,
                n_save=int(n_save), watch=watch, n_live_lanes=B_live,
                live_source=str(_live_source), **kw)
        else:
            kw.pop("live")
            res = _run_segmented_blocking(rhs, y0s, float(t0), float(t1),
                                          cfgs, obs0, n_save=int(n_save),
                                          **kw)
        return unpad_result(res, B_live)


@contextlib.contextmanager
def _telemetry(recorder, watch, fetch_deadline):
    """The context of one segmented run: the watchdog deadline of its host
    reads, ``recorder`` as the thread's current recorder (``None`` keeps
    the one its caller entered), and ``watch`` (with a recorder and no
    watch, a private ``CompileWatch`` entered here whose default label,
    ``sweep-host``, is not the armed one); yields the watch."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(graphs.fetch_deadline(fetch_deadline))
        if recorder is not None:
            stack.enter_context(graphs.recording(recorder))
        if watch is None and recorder is not None:
            watch = stack.enter_context(CompileWatch(
                recorder=recorder, default_label="sweep-host"))
        yield watch


def _region(watch, label, B):
    """``watch``'s single-program region ``label`` keyed on the lane count
    (a bucket change is a first build, not a retrace), or a no-op."""
    if watch is None:
        return contextlib.nullcontext()
    return watch.region(label, single_program=True, program_key=f"b{B}")


def _retire_live(live, recorder, final_counters, source="sweep"):
    """Clear-on-return of a driver's live overlay: fold the final counter
    totals onto the recorder and drop the overlay atomically
    (``LiveRegistry.retire``) when the registry fronts this recorder, else
    fold and clear separately."""
    if live is not None and (final_counters is None
                             or live.recorder is recorder):
        live.retire(source, final_counters)
        return
    if final_counters and recorder is not None:
        for k, v in final_counters.items():
            recorder.counter(k, v)
    if live is not None:
        live.clear(source)


def _stats_zeros(method, B, dtype, dev, timeline):
    """The zero stats block of the segment carry: the keys of the solver's
    ``SolveResult.stats`` (the step counts, the counters, BDF's order
    histogram and, with ``timeline``, the empty ring)."""
    from ..solver.common import init_stats, init_timeline

    if method == "bdf":
        st = init_stats(("n_accepted", "n_rejected") + bdf.STATS_KEYS, B,
                        dev, order_slots=bdf.MAXORD + 1)
    else:
        st = init_stats(("n_accepted", "n_rejected")
                        + obs_counters.COMMON_KEYS, B, dev)
    if timeline is not None:
        ring, _ = init_timeline(timeline, None, B, dtype, dev)
        st.update(timeline_t=ring["t"], timeline_h=ring["h"],
                  timeline_code=ring["code"])
    return st


def _fold_stats(acc, seg, running):
    """Device twin of ``obs.counters.accumulate`` for lanes that ran this
    segment (``running`` (B,)): counters add, the gauge keeps its peak, the
    ring is replaced (the solver was handed the carried one)."""
    out = {}
    for k, a in acc.items():
        v = seg[k]
        m = running.reshape(running.shape + (1,) * (v.ndim - 1))
        if k in obs_counters.GAUGE_KEYS:
            out[k] = torch.maximum(a, torch.where(m, v, 0))
        elif k in obs_counters.TIMELINE_KEYS:
            out[k] = torch.where(m, v, a)
        else:
            out[k] = a + torch.where(m, v, 0)
    return out


def _timeline_state(st, n_acc, n_rej):
    """The solver's ``timeline_state`` from a carried stats block and the
    lanes' attempts so far."""
    return {"t": st["timeline_t"], "h": st["timeline_h"],
            "code": st["timeline_code"], "base": n_acc + n_rej}


def _resolve_mesh_resident(mesh_resident, device):
    """The devices of ``mesh_resident=``: ``None``/``False`` -> None (one
    stream); ``True`` -> every device of ``device``'s kind (the CUDA
    devices, or the CPU); an int ``n`` -> the first ``n`` of them; a
    :class:`Mesh` -> its devices (a device may repeat, as on ``mesh=``)."""
    if mesh_resident is None or mesh_resident is False:
        return None
    if isinstance(mesh_resident, Mesh):
        _check_mesh(mesh_resident, mesh_resident.axis_names[0])
        return _mesh_devices(mesh_resident)
    local = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [torch.device("cpu")])
    if mesh_resident is True:
        return local
    if isinstance(mesh_resident, bool) or not isinstance(
            mesh_resident, (int, np.integer)):
        raise ValueError(
            f"mesh_resident must be None/False (off), True (every local "
            f"device), or a positive int device count; got "
            f"{mesh_resident!r}")
    n = int(mesh_resident)
    if n < 1 or n > len(local):
        raise ValueError(f"mesh_resident={n} outside the 1..{len(local)} "
                         f"local device range")
    return local[:n]


def _to_device(x, dev):
    """``x`` (a bundle: dataclasses, tuples and tensors) with every tensor
    on ``dev``."""
    import dataclasses

    if torch.is_tensor(x):
        return x.to(dev)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))})
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, dev) for v in x)
    return x


def _economy(method, setup_economy, jac_window):
    """At jac_window=1 the setup economy is a structural no-op and the
    solver returns the 4-tuple state, so the carry grows no economy slot."""
    return bool(setup_economy) and jac_window > 1 and method == "bdf"


def _init_segment_carry(y0s, t0, method, obs0, n_save, economy, linsolve,
                        stats=False, timeline=None):
    """The segment carry of a cold start: ``y``, ``t``, ``h`` (-1: the
    heuristic first step), the observer fold ``obs`` (its init, or a dummy
    lane vector without an observer), BDF's ``sstate`` (an all-zero
    history is a cold lane) or SDIRK's PI memory ``e`` (-1: fresh), and
    the control block ``ctrl`` that the blocking gear keeps on the host:
    ``final_status``, ``final_t``, the accepted and rejected totals, with
    ``n_save`` the rows saved and with ``stats`` the stats block
    (:func:`_stats_zeros`)."""
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    seg = {"y": y0s,
           "t": torch.full((B,), float(t0), dtype=dt, device=dev),
           "h": torch.full((B,), -1.0, dtype=dt, device=dev),
           "obs": (obs0 if obs0 is not None
                   else {"_": torch.zeros(B, dtype=dt, device=dev)})}
    if method == "bdf":
        sstate = (torch.zeros((B, bdf.MAXORD + 3, n), dtype=dt, device=dev),
                  torch.ones(B, dtype=torch.int64, device=dev),
                  torch.full((B,), -1.0, dtype=dt, device=dev),
                  torch.zeros(B, dtype=torch.int64, device=dev))
        if economy:
            sstate = sstate + ({
                "fac": factor_zeros(linsolve, B, n, dt, dev),
                "c0": torch.zeros(B, dtype=dt, device=dev),
                "ok": torch.zeros(B, dtype=torch.bool, device=dev),
                "age": torch.zeros(B, dtype=torch.int64, device=dev)},)
        seg["sstate"] = sstate
    else:
        seg["e"] = torch.full((B,), -1.0, dtype=dt, device=dev)
    seg["ctrl"] = {
        "final_status": torch.full((B,), RUNNING, dtype=torch.int32,
                                   device=dev),
        "final_t": torch.full((B,), float("nan"), dtype=dt, device=dev),
        "n_acc": torch.zeros(B, dtype=torch.int64, device=dev),
        "n_rej": torch.zeros(B, dtype=torch.int64, device=dev)}
    if n_save:
        seg["ctrl"]["saved"] = torch.zeros(B, dtype=torch.int64, device=dev)
    if stats:
        seg["ctrl"]["stats"] = _stats_zeros(method, B, dt, dev, timeline)
    return seg


def _run_segmented_blocking(rhs, y0s, t0, t1, cfgs, obs, *, segment_steps,
                            max_segments, max_attempts, rtol, atol,
                            linsolve, jac, observer, dt_min_factor, n_save,
                            jac_window, newton_tol, method, setup_economy,
                            stale_tol, rhs_bundle, progress, poll_every,
                            stats=False, timeline=None, recorder=None):
    """The blocking gear: one solver call per segment (its loops stop once
    no lane needs them) and the park/budget bookkeeping on the host, the
    stats folded there too (``obs.counters.accumulate``)."""
    del poll_every  # the blocking gear reads every segment
    if rhs_bundle is not None:
        rhs, jac = rhs(rhs_bundle)
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    seg_save = min(int(n_save), int(segment_steps)) if n_save else 0
    carry = _init_segment_carry(
        y0s, t0, method, obs, 0,
        _economy(method, setup_economy, jac_window), linsolve)
    y, t, h = carry["y"], carry["t"], carry["h"]
    e, sstate = carry.get("e"), carry.get("sstate")
    final_status = np.full((B,), RUNNING, dtype=np.int32)
    final_t = np.full((B,), np.nan)
    n_acc = np.zeros((B,), dtype=np.int64)
    n_rej = np.zeros((B,), dtype=np.int64)
    if n_save:
        all_ts = np.full((B, int(n_save)), np.inf)
        all_ys = np.zeros((B, int(n_save), n))
        saved = np.zeros((B,), dtype=np.int64)
    seg_t = None
    stats_acc = None
    for seg in range(max_segments):
        kw = _solver_kw(method, newton_tol, jac_window, setup_economy,
                        stale_tol)
        kw.update({"err0": e} if method == "sdirk"
                  else {"solver_state": sstate})
        if stats:
            kw.update(stats=True, timeline=timeline)
            if timeline is not None and stats_acc is not None:
                kw["timeline_state"] = _timeline_state(stats_acc, n_acc,
                                                       n_rej)
        with span_or_null(recorder, "segment", index=seg):
            res = _SOLVERS[method](
                rhs, y, t, t1, cfgs, rtol=rtol, atol=atol,
                max_steps=segment_steps, n_save=seg_save, dt0=h,
                dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
                observer=observer, observer_init=obs, **kw)
            st_keys = list(res.stats) if stats else []
            got = graphs.fetch(res.status, res.n_accepted, res.n_rejected,
                               res.t, *(res.stats[k] for k in st_keys))
        status, seg_acc, seg_rej, seg_t = got[:4]
        # only lanes still live this segment contribute step counts: parked
        # lanes re-enter as zero-span solves
        running = final_status == RUNNING
        n_acc += np.where(running, seg_acc, 0)
        n_rej += np.where(running, seg_rej, 0)
        if stats:
            stats_acc = obs_counters.accumulate(
                stats_acc, dict(zip(st_keys, got[4:])), running)
        drained_ts = None
        if n_save:
            seg_n, = graphs.fetch(res.n_saved)
            take = np.where(running, np.minimum(seg_n, int(n_save) - saved),
                            0)
            if take.max() > 0:
                seg_ts, seg_ys = graphs.fetch(res.ts, res.ys)
                col = np.arange(seg_ts.shape[1])
                src = col[None, :] < take[:, None]
                b_idx, c_idx = np.nonzero(src)
                dst = saved[b_idx] + c_idx
                all_ts[b_idx, dst] = seg_ts[b_idx, c_idx]
                all_ys[b_idx, dst] = seg_ys[b_idx, c_idx]
                saved += take
                drained_ts = seg_ts[b_idx, c_idx]
        terminal = status != MAX_STEPS_REACHED
        newly_terminal = running & terminal
        final_status = np.where(newly_terminal, status, final_status)
        # a terminal lane reports the t of the segment where it terminated
        final_t = np.where(newly_terminal, seg_t, final_t)
        if max_attempts is not None:
            exhausted = (final_status == RUNNING) & (
                n_acc + n_rej >= int(max_attempts))
            final_status = np.where(exhausted, MAX_STEPS_REACHED,
                                    final_status)
            final_t = np.where(exhausted, seg_t, final_t)
        parked = torch.as_tensor(final_status != RUNNING, device=dev)
        was_parked = torch.as_tensor(~running, device=dev)
        t = torch.where(parked, t1, res.t)
        y = res.y
        # lanes parked before this segment keep their last live h (and PI
        # memory)
        h = torch.where(was_parked, h, res.h)
        if method == "sdirk":
            e = torch.where(was_parked, e, res.err_prev)
        else:
            sstate = res.solver_state
        if observer is not None:
            obs = res.observed
        done = not bool(np.any(final_status == RUNNING))
        if progress is not None:
            payload = {"segment": seg, "lanes_done": int(
                (final_status != RUNNING).sum()), "n_lanes": B,
                "accepted_total": int(n_acc.sum())}
            if drained_ts is not None:
                payload["drained_ts"] = drained_ts
            progress(payload)
        if done:
            break
    else:
        final_status[final_status == RUNNING] = MAX_STEPS_REACHED
    # lanes that never terminated (budget exhausted) report their current t
    final_t = np.where(np.isnan(final_t), seg_t, final_t)

    if n_save:
        ts_out = torch.as_tensor(all_ts, dtype=dt)
        ys_out = torch.as_tensor(all_ys, dtype=dt)
        n_saved_out = torch.as_tensor(saved)
    else:
        ts_out, ys_out, n_saved_out = res.ts, res.ys, res.n_saved
    return SolveResult(
        t=torch.as_tensor(final_t, dtype=dt),
        y=y, status=torch.as_tensor(final_status),
        n_accepted=torch.as_tensor(n_acc), n_rejected=torch.as_tensor(n_rej),
        ts=ts_out, ys=ys_out, n_saved=n_saved_out, h=h,
        observed=obs if observer is not None else None,
        err_prev=e if method == "sdirk" else None, solver_state=sstate,
        stats=(None if stats_acc is None else
               {k: torch.as_tensor(v) for k, v in stats_acc.items()}))


# ---------------------------------------------------------------------------
# the pipelined gear: a segment as captured steps of a Program
# ---------------------------------------------------------------------------

def _signature(x):
    """A hashable description of a bundle: the structure, every tensor's
    shape, dtype and device, a digest of its values, and the other
    fields as they are."""
    import dataclasses
    import hashlib

    if torch.is_tensor(x):
        data = x.detach().cpu().contiguous().numpy().tobytes()
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device),
                hashlib.sha256(data).hexdigest())
    if dataclasses.is_dataclass(x):
        return (type(x).__qualname__,) + tuple(
            (f.name, _signature(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return x


def _bundle_tensors(x):
    """A bundle with every tensor field as its own nest entry (dataclasses
    become dicts of their tensor fields), for the program's buffers."""
    import dataclasses

    if torch.is_tensor(x):
        return x
    if dataclasses.is_dataclass(x):
        return {f.name: _bundle_tensors(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if torch.is_tensor(getattr(x, f.name))}
    if isinstance(x, (tuple, list)):
        return tuple(_bundle_tensors(v) for v in x)
    return None


def _bundle_view(template, buffers):
    """``template`` (the bundle) with its tensor fields replaced by the
    program's buffers."""
    import dataclasses

    if torch.is_tensor(template):
        return buffers
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **buffers)
    if isinstance(template, (tuple, list)):
        return type(template)(_bundle_view(t, b)
                              for t, b in zip(template, buffers))
    return template


def _segment_program(rhs, jac, observer, bundle, B, n, dtype, dev, cfgs,
                     obs_keys, *, method, rtol, atol, segment_steps,
                     dt_min_factor, linsolve, jac_window, newton_tol,
                     setup_economy, stale_tol, seg_save, n_save,
                     has_budget, stats=False, timeline=None, owner=None):
    """The cached :class:`~..solver.graphs.Program` of one segment shape:
    its steps ``begin``, ``window``, ``end`` and ``compact`` (module doc)
    over the state entries ``seg`` (the segment carry), ``w`` (the
    solver's carry), ``cfg``, ``t1`` (B,), ``budget`` (1,), ``flag`` (1,)
    and, with ``n_save``, ``drain``; ``compact`` reads ``order``,
    ``admit_y``, ``admit_cfg``, ``fresh``, ``n_live`` and ``n_new``.
    ``stats``/``timeline`` are part of the key: a telemetry sweep never
    replays a stats-free program, nor the reverse.  So is ``owner`` (a
    serving epoch's name): two epochs of one shape on one device each get
    their own buffers, since they run at the same time."""
    bundle_sig = None if bundle is None else _signature(bundle)
    key = ("segment", method, id(rhs), id(jac), id(observer), bundle_sig,
           B, n, str(dtype), str(dev), linsolve, jac_window,
           bool(setup_economy), stale_tol, rtol, atol, segment_steps,
           dt_min_factor, newton_tol, seg_save, n_save, has_budget,
           tuple((k, tuple(v.shape[1:]), str(v.dtype))
                 for k, v in cfgs.items()),
           obs_keys, bool(stats), timeline, owner)
    return graphs.program(key, lambda: _build_segment_program(
        rhs, jac, observer, bundle, B, n, dtype, dev, method=method,
        rtol=rtol, atol=atol, segment_steps=segment_steps,
        dt_min_factor=dt_min_factor, linsolve=linsolve,
        jac_window=jac_window, newton_tol=newton_tol,
        setup_economy=setup_economy, stale_tol=stale_tol,
        seg_save=seg_save, n_save=n_save, has_budget=has_budget,
        stats=stats, timeline=timeline))


def _build_segment_program(rhs, jac, observer, bundle, B, n, dtype, dev, *,
                           method, rtol, atol, segment_steps, dt_min_factor,
                           linsolve, jac_window, newton_tol, setup_economy,
                           stale_tol, seg_save, n_save, has_budget,
                           stats=False, timeline=None):
    # the stepper is built once, over a cfg dict that every step refreshes
    # from the state's buffers, and (bundle mode) over the functions the
    # builder makes from the state's bundle buffers at each step
    cfg = {}
    cur = {}
    if bundle is not None:
        builder = rhs

        def rhs(t, y, c):
            return cur["rhs"](t, y, c)

        def jac(t, y, c):
            return cur["jac"](t, y, c)

    def prelude(s):
        cfg.clear()
        cfg.update(s["cfg"])
        if bundle is not None:
            f, j = builder(_bundle_view(bundle, s["bundle"]))
            cur["rhs"] = f
            cur["jac"] = j if j is not None else jacfwd_lanes(f)

    if method == "bdf":
        st = bdf.make_stepper(
            rhs, cfg, B, n, dtype, dev, rtol=rtol, atol=atol,
            max_steps=segment_steps, n_save=seg_save,
            dt_min_factor=dt_min_factor, linsolve=linsolve, jac=jac,
            observer=observer, jac_window=jac_window,
            setup_economy=setup_economy, stale_tol=stale_tol, stats=stats,
            timeline=timeline)
    else:
        st = sdirk.make_stepper(
            rhs, cfg, B, n, dtype, dev, rtol=rtol, atol=atol,
            max_steps=segment_steps, n_save=seg_save,
            newton_tol=newton_tol, dt_min_factor=dt_min_factor,
            linsolve=linsolve, jac=jac, observer=observer,
            jac_window=jac_window, stats=stats, timeline=timeline)

    def begin(s):
        prelude(s)
        seg = s["seg"]
        obs0 = seg["obs"] if observer is not None else None
        ctrl = seg["ctrl"]
        tl = (_timeline_state(ctrl["stats"], ctrl["n_acc"], ctrl["n_rej"])
              if timeline is not None else None)
        if method == "bdf":
            w = st.init(seg["y"], seg["t"], s["t1"], dt0=seg["h"],
                        solver_state=seg["sstate"], observer_init=obs0,
                        timeline_state=tl)
        else:
            w = st.init(seg["y"], seg["t"], s["t1"], dt0=seg["h"],
                        err0=seg["e"], observer_init=obs0,
                        timeline_state=tl)
        return {"w": w}

    def window(s):
        prelude(s)
        w = st.window(s["w"], fixed=True)
        return {"w": w, "flag": (w["status"] == RUNNING).any().reshape(1)}

    def end(s):
        # the blocking gear's host bookkeeping, statement for statement
        seg, res = s["seg"], st.result(s["w"])
        ctrl = seg["ctrl"]
        running = ctrl["final_status"] == RUNNING
        n_acc = ctrl["n_acc"] + torch.where(running, res.n_accepted, 0)
        n_rej = ctrl["n_rej"] + torch.where(running, res.n_rejected, 0)
        terminal = res.status != MAX_STEPS_REACHED
        newly = running & terminal
        final_status = torch.where(newly, res.status, ctrl["final_status"])
        final_t = torch.where(newly, res.t, ctrl["final_t"])
        if has_budget:
            exhausted = (final_status == RUNNING) & (n_acc + n_rej
                                                     >= s["budget"])
            final_status = torch.where(exhausted, MAX_STEPS_REACHED,
                                       final_status)
            final_t = torch.where(exhausted, res.t, final_t)
        ctrl2 = {"final_status": final_status.to(torch.int32),
                 "final_t": final_t, "n_acc": n_acc, "n_rej": n_rej}
        if stats:
            ctrl2["stats"] = _fold_stats(ctrl["stats"], res.stats, running)
        out = {}
        if n_save:
            saved = ctrl["saved"]
            take = torch.where(running, torch.minimum(res.n_saved,
                                                      n_save - saved), 0)
            ctrl2["saved"] = saved + take
            # the rows lane-major, in-lane order (the blocking gear's
            # np.nonzero order) at the front of a flat buffer; the slot
            # past the end takes the rows that do not exist
            cap = B * seg_save
            off = torch.cumsum(take, 0) - take
            col = torch.arange(seg_save, device=dev)
            dst = torch.where(col[None, :] < take[:, None],
                              off[:, None] + col[None, :], cap).reshape(-1)
            flat_ts = torch.zeros(cap + 1, dtype=dtype, device=dev)
            flat_ts = flat_ts.index_put((dst,), res.ts.reshape(-1))
            flat_ys = torch.zeros((cap + 1, n), dtype=dtype, device=dev)
            flat_ys = flat_ys.index_put((dst,), res.ys.reshape(cap, n))
            out["drain"] = {"take": take, "ts": flat_ts, "ys": flat_ys}
        parked = final_status != RUNNING
        seg2 = {"y": res.y, "t": torch.where(parked, s["t1"], res.t),
                "h": torch.where(~running, seg["h"], res.h),
                "obs": res.observed if observer is not None else seg["obs"],
                "ctrl": ctrl2}
        if method == "bdf":
            seg2["sstate"] = res.solver_state
        else:
            seg2["e"] = torch.where(~running, seg["e"], res.err_prev)
        out["seg"] = seg2
        out["flag"] = (final_status == RUNNING).any().reshape(1)
        return out

    def compact(s):
        seg, cfg = _compact_admit(s["seg"], s["cfg"], s["order"],
                                  s["admit_y"], s["admit_cfg"], s["fresh"],
                                  s["n_live"], s["n_new"])
        return {"seg": seg, "cfg": cfg}

    return graphs.Program(dev, {"begin": begin, "window": window,
                                "end": end, "compact": compact})


def _compact_admit(seg, cfgs, order, new_y0, new_cfgs, fresh, n_live,
                   n_new):
    """The streaming driver's compaction and admission (the ``compact``
    step; ``batchreactor_tpu/parallel/sweep.py::_compact_admit``): every
    row of the segment carry and of the conditions permuted by ``order``
    (live lanes first, computed on the host from the polled status), then
    the ``n_new`` slots from ``n_live`` on overwritten by admitted lanes:
    ``new_y0`` rows for the state, ``fresh`` (a cold carry) for the rest
    of the carry, ``new_cfgs`` rows for the conditions.  ``n_live`` and
    ``n_new`` are device scalars, so one captured graph serves every
    compaction of a rung.  Slots past ``n_live + n_new`` keep their
    permuted parked carry and re-enter as zero-span no-ops."""
    B = order.shape[0]

    def perm(x):
        return x.index_select(0, order)

    idx = torch.arange(B, device=order.device)
    admit = (idx >= n_live) & (idx < n_live + n_new)

    def sel(f, p):
        return torch.where(admit.reshape((B,) + (1,) * (p.ndim - 1)), f, p)

    fresh = dict(fresh)
    fresh["y"] = new_y0
    return (graphs.tree_map(sel, fresh, graphs.tree_map(perm, seg)),
            graphs.tree_map(sel, new_cfgs, graphs.tree_map(perm, cfgs)))


def _segment_inputs(prog, seg, cfgs, t1, max_attempts, bundle):
    """Load a sweep's carry and operands into ``prog``'s state."""
    B = seg["y"].shape[0]
    dt, dev = seg["y"].dtype, seg["y"].device
    parts = {"seg": seg, "cfg": dict(cfgs),
             "t1": torch.full((B,), t1, dtype=dt, device=dev),
             "budget": torch.full((1,), int(max_attempts or 0),
                                  dtype=torch.int64, device=dev)}
    if bundle is not None:
        parts["bundle"] = _bundle_tensors(bundle)
    prog.set(**parts)


class _Flags:
    """The host's reads of the program's device values: the flag after a
    step (one int through pinned memory behind a CUDA event on the card,
    counted as a host sync) and the status poll, copied without a wait
    and read at the next flag."""

    def __init__(self, prog):
        self.prog = prog
        self.cuda = prog.on_cuda
        if self.cuda:
            self.pin = torch.empty(1, dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()
        self.polled = None

    def read(self):
        graphs.add_count("host_syncs")
        flag = self.prog.state["flag"]
        if not self.cuda:
            return bool(flag[0])
        self.pin.copy_(flag, non_blocking=True)
        self.event.record()
        graphs.wait_event(self.event, "flag")
        return bool(self.pin[0])

    def poll(self, rejected=False):
        """Start copying the status vector and accepted totals (and with
        ``rejected`` the rejected ones); the next :meth:`read` waits for
        them too."""
        ctrl = self.prog.state["seg"]["ctrl"]
        vals = (ctrl["final_status"], ctrl["n_acc"])
        if rejected:
            vals += (ctrl["n_rej"],)
        if self.cuda:
            vals = tuple(v.to("cpu", non_blocking=True) for v in vals)
        self.polled = vals

    def take_poll(self):
        """The polled (status, accepted[, rejected]) as numpy, read after a
        flag."""
        vals, self.polled = self.polled, None
        return tuple(v.numpy() for v in vals)


def _run_segment(prog, flags, watch=None, recorder=None, index=0):
    """One segment: ``begin``, ``window`` until no lane is running in it
    (the first window always runs: a lane still live enters a segment
    short of t1), then ``end``; a ``segment`` span on ``recorder``, its
    captures under ``watch``'s ``sweep-segment`` label."""
    with span_or_null(recorder, "segment", index=index), \
            _region(watch, "sweep-segment", prog.state["t1"].shape[0]):
        prog.run("begin")
        prog.run("window")
        while flags.read():
            prog.run("window")
        prog.run("end")


def _poll_read(flags, recorder, seg, take):
    """The flag read after a segment's ``end`` at a poll point, as a
    ``poll`` span (its wall on ``poll_wait_s``: the only time the
    pipelined host waits for the card), with the polled vectors when
    ``take``.  Returns (any lane live, polled vectors or None)."""
    with span_or_null(recorder, "poll", upto=seg) as sp:
        live = flags.read()
        polled = flags.take_poll() if take else None
    if recorder is not None:
        recorder.counter("poll_wait_s", sp["dur"])
    return live, polled


def _result_clone(x):
    return graphs.tree_map(lambda v: v.detach().clone(), x)


def _run_segmented_pipelined(rhs, y0s, t0, t1, cfgs, obs, *, segment_steps,
                             max_segments, max_attempts, rtol, atol,
                             linsolve, jac, observer, dt_min_factor, n_save,
                             jac_window, newton_tol, method, setup_economy,
                             stale_tol, rhs_bundle, progress, poll_every,
                             stats=False, timeline=None, recorder=None,
                             watch=None, live=None, live_source="sweep",
                             n_live_lanes=None):
    """The pipelined gear (module doc): bit for bit the blocking gear's
    results, with one host sync per window.  ``live`` gets an in-flight
    publish at every status poll, from the vectors the poll copies anyway
    (the occupancy pair and the segment/lanes gauges); the stats block
    comes back with the final fetch."""
    B, n = y0s.shape
    dt, dev = y0s.dtype, y0s.device
    nl_live = int(B if n_live_lanes is None else n_live_lanes)
    seg_save = min(int(n_save), int(segment_steps)) if n_save else 0
    economy = _economy(method, setup_economy, jac_window)
    with span_or_null(recorder, "prep"):
        with _region(watch, "sweep-segment", B):
            prog = _segment_program(
                rhs, jac, observer, rhs_bundle, B, n, dt, dev, cfgs,
                tuple(obs) if obs is not None else None, method=method,
                rtol=rtol, atol=atol, segment_steps=segment_steps,
                dt_min_factor=dt_min_factor, linsolve=linsolve,
                jac_window=jac_window, newton_tol=newton_tol,
                setup_economy=economy, stale_tol=stale_tol,
                seg_save=seg_save, n_save=int(n_save),
                has_budget=max_attempts is not None, stats=stats,
                timeline=timeline)
        _segment_inputs(prog, _init_segment_carry(
            y0s, t0, method, obs, n_save, economy, linsolve, stats,
            timeline), cfgs, t1, max_attempts, rhs_bundle)
    flags = _Flags(prog)
    drainer = (_TrajectoryDrainer(B, int(n_save), n, prog.on_cuda,
                                  graphs.current_deadline(), recorder)
               if n_save else None)
    emitted = 0

    def emit(status_np, acc_np, launched):
        nonlocal emitted
        if progress is None:
            return
        lanes_done = int((status_np != RUNNING).sum())
        acc_tot = int(acc_np.sum())
        ready = (drainer.pop_ready() if drainer is not None
                 else [(s, None) for s in range(emitted, launched)])
        for s, dts in ready:
            payload = {"segment": s, "lanes_done": lanes_done,
                       "n_lanes": B, "accepted_total": acc_tot}
            if dts is not None and len(dts):
                payload["drained_ts"] = dts
            progress(payload)
            emitted = s + 1

    def publish(seg, status_np, acc_np, rej_np, launched):
        lanes_done = int((status_np != RUNNING).sum())
        live.publish(
            live_source,
            counters={"lane_attempts": int(acc_np[:nl_live].sum()
                                           + rej_np[:nl_live].sum()),
                      "lane_capacity": (int(launched) * B
                                        * int(segment_steps))},
            gauges={"segment": int(seg), "lanes_done": lanes_done,
                    "lanes_total": B, "lanes_running": B - lanes_done})

    # the status vector is copied (without a wait, read at the flag) at
    # the poll points only when someone reads it
    take = progress is not None or live is not None
    done = False
    launched = 0
    try:
        for seg in range(max_segments):
            _run_segment(prog, flags, watch, recorder, seg)
            launched = seg + 1
            if drainer is not None:
                drainer.submit(seg, prog.state["drain"])
            if launched % poll_every == 0 or launched == max_segments:
                if take:
                    flags.poll(rejected=live is not None)
                running_any, polled = _poll_read(flags, recorder, seg, take)
                if live is not None:
                    publish(seg, *polled, launched)
                if progress is not None:
                    emit(*polled[:2], launched)
            else:
                running_any = flags.read()
            if not running_any:
                done = True
                break
    except BaseException:
        # a fault mid-window (a watchdog breach) leaves the program's state
        # in flight: it is never replayed, and the drain thread is joined
        # without letting its own error mask this one
        graphs.discard(prog)
        if drainer is not None:
            drainer.close(raise_error=False)
        _retire_live(live, recorder, None, live_source)
        raise
    if drainer is not None:
        drainer.close()

    with span_or_null(recorder, "finish"):
        seg = prog.state["seg"]
        ctrl = seg["ctrl"]
        st_keys = list(ctrl["stats"]) if stats else []
        got = graphs.fetch(
            ctrl["final_status"], ctrl["final_t"], ctrl["n_acc"],
            ctrl["n_rej"], seg["t"], *(ctrl["stats"][k] for k in st_keys))
        fs, ft, na, nr, t_np = got[:5]
        emit(fs, na, launched)
        fs = np.array(fs, copy=True)
        if not done:
            # max_segments exhausted with lanes still running
            fs[fs == RUNNING] = MAX_STEPS_REACHED
        # never-terminated lanes report their current t (a lane still running
        # was never parked, so its carried t is the last segment's)
        ft = np.where(np.isnan(ft), t_np, ft)
        # the occupancy pair: the caller's lanes' attempts against the attempt
        # capacity of the padded program (pad lanes read as idle capacity)
        final_counters = None
        if recorder is not None and launched:
            final_counters = {
                "lane_attempts": int(na[:nl_live].sum() + nr[:nl_live].sum()),
                "lane_capacity": int(launched) * B * int(segment_steps)}
        _retire_live(live, recorder, final_counters, live_source)
        w = prog.state["w"]
        if n_save:
            ts_out = torch.as_tensor(drainer.all_ts, dtype=dt)
            ys_out = torch.as_tensor(drainer.all_ys, dtype=dt)
            n_saved_out = torch.as_tensor(drainer.saved)
        else:
            ts_out, ys_out, n_saved_out = (w["ts"].clone(), w["ys"].clone(),
                                           w["n_saved"].clone())
        return SolveResult(
            t=torch.as_tensor(ft, dtype=dt), y=seg["y"].clone(),
            status=torch.as_tensor(fs), n_accepted=torch.as_tensor(na),
            n_rejected=torch.as_tensor(nr), ts=ts_out, ys=ys_out,
            n_saved=n_saved_out, h=seg["h"].clone(),
            observed=(_result_clone(seg["obs"]) if observer is not None
                      else None),
            err_prev=seg["e"].clone() if method == "sdirk" else None,
            solver_state=(_result_clone(seg["sstate"]) if method == "bdf"
                          else None),
            stats=({k: torch.as_tensor(v) for k, v in zip(st_keys, got[5:])}
                   if stats else None))


class _TrajectoryDrainer:
    """The pipelined gear's trajectory drain: each segment's rows, gathered
    lane-major on the device by the ``end`` step, scattered into the
    (B, n_save) host arrays in segment order.

    On CUDA the main thread clones the segment's drain buffers on its
    stream (the next ``end`` replay overwrites them) and records an event;
    a worker thread waits for the event, copies the per-lane row counts
    and then only the rows that exist to pinned memory on a side stream,
    and scatters them while the card solves the next segment.  Worker
    failures are re-raised by :meth:`close` and the next :meth:`submit`.
    On the CPU the drain runs inline."""

    def __init__(self, B, n_save, n, threaded, deadline=None,
                 recorder=None):
        self.all_ts = np.full((B, n_save), np.inf)
        self.recorder = recorder
        # the watchdog deadline of the sweep's thread, which the worker
        # applies to its own waits
        self._deadline = deadline
        self.all_ys = np.zeros((B, n_save, n))
        self.saved = np.zeros((B,), dtype=np.int64)
        self._drained = {}
        self._done_upto = -1
        self._lock = threading.Lock()
        self._exc = None
        self._thread = None
        if threaded:
            self._stream = torch.cuda.Stream()
            self._q = queue.Queue(maxsize=8)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="br-sweep-drain")
            self._thread.start()

    def submit(self, seg, drain):
        if self._exc is not None:
            raise self._exc
        if self._thread is None:
            self._drain(seg, drain)
            return
        snap = {k: v.clone() for k, v in drain.items()}
        event = torch.cuda.Event()
        event.record()
        self._q.put((seg, snap, event))

    def pop_ready(self):
        """(seg, drained_ts) for every drained segment, in order."""
        out = []
        with self._lock:
            for s in sorted(self._drained):
                if s <= self._done_upto:
                    out.append((s, self._drained.pop(s)))
        return out

    def close(self, raise_error=True):
        """Drain the queue, join the worker, re-raise any failure (unless
        ``raise_error`` is False: the caller is unwinding from its own)."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
        if self._exc is not None and raise_error:
            raise self._exc

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue   # keep consuming so submit cannot deadlock
            seg, snap, event = item
            try:
                with torch.cuda.stream(self._stream), \
                        graphs.fetch_deadline(self._deadline):
                    self._stream.wait_event(event)
                    self._drain(seg, snap)
            except BaseException as e:  # noqa: BLE001 — re-raised by close
                with self._lock:
                    self._exc = e

    def _host(self, *tensors):
        """Copies to the host; on the drain stream, then waited for."""
        if self._thread is None:
            return tuple(t.numpy() for t in tensors)
        out = tuple(t.to("cpu", non_blocking=True) for t in tensors)
        done = torch.cuda.Event()
        done.record(self._stream)
        graphs.wait_event(done, "drain")
        return tuple(t.numpy() for t in out)

    def _drain(self, seg, drain):
        with span_or_null(self.recorder, "drain", segment=seg):
            self._drain_rows(seg, drain)

    def _drain_rows(self, seg, drain):
        take, = self._host(drain["take"])
        tot = int(take.sum())
        if self.recorder is not None and tot:
            self.recorder.counter("drain_rows", tot)
        ts_np = np.empty((0,))
        if tot:
            ts_np, ys_np = self._host(drain["ts"][:tot], drain["ys"][:tot])
            cum = np.cumsum(take)
            pos = np.arange(tot)
            b_idx = np.searchsorted(cum, pos, side="right")
            c_idx = pos - (cum - take)[b_idx]
            dst = self.saved[b_idx] + c_idx
            # all_ts, all_ys and saved belong to the worker until close()
            # joins it; the sweep's thread reads them only after that
            self.all_ts[b_idx, dst] = ts_np  # brlint: disable=unguarded-shared-mutation
            self.all_ys[b_idx, dst] = ys_np  # brlint: disable=unguarded-shared-mutation
        self.saved += take  # brlint: disable=unguarded-shared-mutation
        with self._lock:
            self._drained[seg] = ts_np
            self._done_upto = seg


# ---------------------------------------------------------------------------
# the streaming driver: continuous batching over resident slots
# ---------------------------------------------------------------------------

def _grow_tail(tree, grow):
    """Every leading-lane tensor grown by ``grow`` copies of its last row
    (the up-shift's resize; a copied row holds real values)."""
    return graphs.tree_map(
        lambda x: torch.cat([x, x[-1:].expand((grow,) + x.shape[1:])]),
        tree)


class _Backlog:
    """The streaming driver's lanes, in the caller's order, on the host
    (pinned memory when the stream runs on the card): a compaction copies
    only the rows it admits to the device, and a live feed appends rows
    into room that doubles when it runs out, so a long-lived stream never
    copies its whole backlog again."""

    def __init__(self, y0s, cfgs, pin):
        self.pin = pin
        self.n = int(y0s.shape[0])
        self.y = self._host(y0s)
        self.cfg = {k: self._host(v) for k, v in cfgs.items()}

    def _host(self, x, rows=None):
        shape = (x.shape[0] if rows is None else rows,) + tuple(x.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, pin_memory=self.pin)
        if rows is None:
            out.copy_(x)
        return out

    def append(self, y_rows, cfg_rows):
        """Append ``k`` host rows: ``y_rows`` (k, n) and ``cfg_rows`` (a
        dict of (k, ...) arrays with each leaf's trailing shape)."""
        k = int(y_rows.shape[0])
        lo, hi = self.n, self.n + k
        if hi > self.y.shape[0]:
            cap = max(hi, 2 * self.y.shape[0])
            grown = self._host(self.y, cap)
            grown[:lo] = self.y[:lo]
            self.y = grown
            for key, v in self.cfg.items():
                g = self._host(v, cap)
                g[:lo] = v[:lo]
                self.cfg[key] = g
        self.y[lo:hi] = torch.as_tensor(np.asarray(y_rows),
                                        dtype=self.y.dtype)
        for key, v in self.cfg.items():
            v[lo:hi] = torch.as_tensor(
                np.asarray(cfg_rows[key]), dtype=v.dtype).reshape(
                    (k,) + tuple(v.shape[1:]))
        self.n = hi

    def rows(self, lo, hi, dev):
        """Lanes ``lo:hi`` on ``dev`` (copies that do not wait on the
        host when the rows are pinned)."""
        return (self.y[lo:hi].to(dev, non_blocking=True),
                {k: v[lo:hi].to(dev, non_blocking=True)
                 for k, v in self.cfg.items()})


def _run_segmented_streaming(rhs, y0s, t0, t1, cfgs, observer_init, *,
                             resident, refill_spec, buckets, upshift,
                             upshift_patience, segment_steps, max_segments,
                             max_attempts, rtol, atol, linsolve, jac,
                             observer, dt_min_factor, jac_window, newton_tol,
                             method, setup_economy, stale_tol, rhs_bundle,
                             progress, poll_every, on_harvest=None,
                             feed=None, stats=False, timeline=None,
                             recorder=None, watch=None, live=None,
                             live_source="sweep"):
    """Continuous batching: one resident program of B slots streams
    through N lanes.  Its loop is the pipelined gear's, and at each status
    poll (every ``poll_every`` segments, and whenever every resident lane
    has parked):

    1. **harvest** — finished slots' final state, step counts and
       observer fold are fetched and written to the N-lane outputs at the
       caller's lane index (``slot_gid`` maps slots to lanes);
    2. **compact + admit** — once ``refill`` slots have parked, the
       ``compact`` step (one graph per rung, its counts in device
       scalars) permutes live lanes to the front and refills freed slots
       from the backlog;
    3. **down-shift** — backlog empty and the live lanes fitting a smaller
       ``buckets`` rung: the carry is compacted and sliced onto that
       rung's program;
    4. **up-shift** (``upshift=``) — a backlog that has filled the next
       rung's extra slots for ``upshift_patience`` polls grows the carry
       onto the next rung up; the same patience and a cooldown damp the
       down-shift, so the ladder does not thrash.

    Lanes are independent, so every lane's results equal the
    admission-off sweep's; on the CPU bit for bit.  The stats block rides
    the carry, moves with its lane through every compaction and shift, and
    is harvested with the lane's other rows; ``live`` gets the queue's
    state (backlog, harvested and admitted lanes, resident bucket) at
    every poll, its gauges suffixed with the epoch tag of a
    ``live_source`` other than ``"sweep"``.  ``feed`` (the ``_feed`` hook
    of :func:`ensemble_solve_segmented`) appends lanes to the backlog at a
    poll once the backlog is used up; an epoch tag also gives the epoch
    its own programs (``owner`` of :func:`_segment_program`), so two
    epochs on one device never replay one set of buffers."""
    N, n = y0s.shape
    dtype, dev = y0s.dtype, y0s.device
    backlog_rows = _Backlog(y0s.detach(), {k: v.detach()
                                           for k, v in cfgs.items()},
                            pin=dev.type == "cuda")
    cfg_all = backlog_rows.cfg
    owner = None if live_source == "sweep" else live_source
    n0 = min(int(resident), N)
    B = resolve_bucket(n0, buckets)
    refill_n = _refill_slots(refill_spec, B)
    upshift_cap = (None if upshift is None
                   else resolve_bucket(max(int(upshift), 1), buckets))
    economy = _economy(method, setup_economy, jac_window)
    # the JAX package resolves "auto" with the first rung: every rung of a
    # stream runs the same linear algebra
    linsolve = resolve_linsolve(linsolve, method=method, device=dev,
                                batch=B, n=n)
    obs_keys = tuple(observer_init) if observer is not None else None

    def rung(B_):
        with _region(watch, "sweep-segment", B_):
            return _segment_program(
                rhs, jac, observer, rhs_bundle, B_, n, dtype, dev, cfg_all,
                obs_keys, method=method, rtol=rtol, atol=atol,
                segment_steps=segment_steps, dt_min_factor=dt_min_factor,
                linsolve=linsolve, jac_window=jac_window,
                newton_tol=newton_tol, setup_economy=economy,
                stale_tol=stale_tol, seg_save=0, n_save=0,
                has_budget=max_attempts is not None, stats=stats,
                timeline=timeline, owner=owner)

    def fresh_carry(B_):
        return _init_segment_carry(
            torch.zeros((B_, n), dtype=dtype, device=dev), t0, method,
            _lane_obs(observer, observer_init, B_, dtype, dev), 0, economy,
            linsolve, stats, timeline)

    def load(prog, seg, cfg, B_):
        _segment_inputs(prog, seg, cfg, t1, max_attempts, rhs_bundle)
        prog.set(fresh=fresh_carry(B_))

    # resident block 0: min(B, N) backlog lanes; a bucket larger than the
    # whole backlog pads with dead copies (slot id -1, never harvested)
    n_seed = min(B, N)
    y_blk, cfg_blk = _pad_lanes(*backlog_rows.rows(0, n_seed, dev),
                                B - n_seed)
    slot_gid = np.concatenate([np.arange(n_seed, dtype=np.int64),
                               np.full((B - n_seed,), -1, dtype=np.int64)])
    next_gid = n_seed
    prog = rung(B)
    load(prog, _init_segment_carry(
        y_blk, t0, method, _lane_obs(observer, observer_init, B, dtype, dev),
        0, economy, linsolve, stats, timeline), cfg_blk, B)
    flags = _Flags(prog)

    # N-lane outputs in the caller's order
    out_t = np.full((N,), np.nan)
    out_status = np.full((N,), RUNNING, dtype=np.int32)
    out_y = backlog_rows.y[:N].numpy().copy()
    out_h = np.full((N,), -1.0)
    out_acc = np.zeros((N,), dtype=np.int64)
    out_rej = np.zeros((N,), dtype=np.int64)
    out_obs = None
    if observer is not None:
        # never-admitted lanes report the observer's initial values
        out_obs = {k: np.full((N,), float(v)) for k, v in
                   observer_init.items()}
    out_stats = None
    if stats:
        # never-admitted lanes report zero counters and an empty ring
        out_stats = {k: np.zeros((N,) + tuple(v.shape[1:]),
                                 dtype=str(v.dtype).replace("torch.", ""))
                     for k, v in prog.state["seg"]["ctrl"]["stats"].items()}
    counts = {k: 0 for k in STREAM_COUNTS}

    def counted(name, k=1):
        counts[name] += k
        if recorder is not None:
            recorder.counter(name, k)
    capacity_lane_segs = 0
    up_streak = down_streak = shift_cooldown = 0

    def harvest(status_np, force=False):
        """Fetch finished slots, write them in the caller's order, retire
        their lane ids; ``force`` also takes still-running slots as
        MAX_STEPS_REACHED at their current t (max_segments exhausted)."""
        parked = status_np != RUNNING
        rows = np.nonzero((parked | force) & (slot_gid >= 0))[0]
        if rows.size == 0:
            return
        seg = prog.state["seg"]
        ctrl = seg["ctrl"]
        obs_t = list(seg["obs"].values()) if observer is not None else []
        st_keys = list(out_stats) if stats else []
        got = graphs.fetch(seg["y"], seg["h"], seg["t"], ctrl["final_t"],
                           ctrl["n_acc"], ctrl["n_rej"], *obs_t,
                           *(ctrl["stats"][k] for k in st_keys))
        y_f, h_f, t_f, ft_f, na_f, nr_f = got[:6]
        st_f = dict(zip(st_keys, got[6 + len(obs_t):]))
        got = got[:6 + len(obs_t)]
        gids = slot_gid[rows]
        out_status[gids] = np.where(parked[rows], status_np[rows],
                                    MAX_STEPS_REACHED)
        ft_rows = ft_f[rows]
        out_t[gids] = np.where(np.isnan(ft_rows), t_f[rows], ft_rows)
        out_y[gids] = y_f[rows]
        out_h[gids] = h_f[rows]
        out_acc[gids] = na_f[rows]
        out_rej[gids] = nr_f[rows]
        if observer is not None:
            for k, v in zip(seg["obs"], got[6:]):
                out_obs[k][gids] = v[rows]
        for k, v in st_f.items():
            out_stats[k][gids] = v[rows]
        slot_gid[rows] = -1
        counts["harvested_lanes"] += rows.size
        if on_harvest is not None:
            payload = {"t": out_t[gids], "y": y_f[rows],
                       "status": out_status[gids], "h": h_f[rows],
                       "n_accepted": na_f[rows], "n_rejected": nr_f[rows]}
            if observer is not None:
                payload["observed"] = {k: v[rows] for k, v in
                                       zip(seg["obs"], got[6:])}
            if stats:
                payload["stats"] = {k: v[rows] for k, v in st_f.items()}
            on_harvest(gids, payload)

    def compact(status_np, n_new):
        """Run the ``compact`` step and mirror its permutation on the
        slot-to-lane map."""
        nonlocal slot_gid, next_gid
        parked = status_np != RUNNING
        order_np = np.argsort(parked, kind="stable")
        n_live = int((~parked).sum())
        new_y = torch.zeros((B, n), dtype=dtype, device=dev)
        new_cfg = {k: torch.zeros((B,) + v.shape[1:], dtype=v.dtype,
                                  device=dev) for k, v in cfg_all.items()}
        if n_new:
            y_sel, cfg_sel = backlog_rows.rows(next_gid, next_gid + n_new,
                                               dev)
            new_y[n_live:n_live + n_new] = y_sel
            for k, v in cfg_sel.items():
                new_cfg[k][n_live:n_live + n_new] = v
        with span_or_null(recorder, "compact", admitted=n_new), \
                _region(watch, "sweep-compact", B):
            prog.set(order=torch.as_tensor(order_np).to(dev),
                     admit_y=new_y, admit_cfg=new_cfg,
                     n_live=torch.full((1,), n_live, dtype=torch.int64,
                                       device=dev),
                     n_new=torch.full((1,), n_new, dtype=torch.int64,
                                      device=dev))
            prog.run("compact")
        slot_gid = slot_gid[order_np]
        counted("compactions")
        if n_new:
            slot_gid[n_live:n_live + n_new] = np.arange(
                next_gid, next_gid + n_new, dtype=np.int64)
            next_gid += n_new
            counted("admitted_lanes", n_new)

    def move(B2, seg, cfg):
        """Switch to the B2-lane rung with the given carry."""
        nonlocal prog, flags, B, refill_n
        prog = rung(B2)
        load(prog, seg, cfg, B2)
        flags = _Flags(prog)
        B = B2
        refill_n = _refill_slots(refill_spec, B)

    def downshift(status_np):
        nonlocal slot_gid
        n_live = int((status_np == RUNNING).sum())
        B2 = downshift_bucket(n_live, buckets, B)
        if B2 is None:
            return False
        compact(status_np, 0)
        cut = graphs.tree_map(lambda x: x[:B2].clone(),
                              (prog.state["seg"], prog.state["cfg"]))
        B1 = B
        move(B2, *cut)
        slot_gid = slot_gid[:B2]
        counted("bucket_downshifts")
        if recorder is not None:
            recorder.event("bucket_downshift", bucket=B1, live=n_live)
        return True

    def upshift_now(status_np):
        nonlocal slot_gid
        n_live = int((status_np == RUNNING).sum())
        backlog = N - next_gid
        B2 = upshift_bucket(n_live + backlog, buckets, B, cap=upshift_cap)
        if B2 is None:
            return False
        grow = B2 - B
        seg, cfg = _grow_tail((prog.state["seg"], prog.state["cfg"]), grow)
        # the grown tail is parked (a terminal status and t = t1) so the
        # compaction reads it as freed slots
        seg["ctrl"]["final_status"][B:] = MAX_STEPS_REACHED
        seg["t"][B:] = t1
        move(B2, seg, cfg)
        slot_gid = np.concatenate([slot_gid,
                                   np.full((grow,), -1, dtype=np.int64)])
        status_ext = np.concatenate(
            [status_np, np.full((grow,), MAX_STEPS_REACHED,
                                dtype=status_np.dtype)])
        counted("bucket_upshifts")
        if recorder is not None:
            recorder.event("bucket_upshift", bucket=B, live=n_live,
                           backlog=backlog)
        compact(status_ext, min(B2 - n_live, backlog))
        return True

    def feed_more(n_space, idle):
        """Ask the feed for up to ``n_space`` lanes and append them to the
        backlog and the outputs; the count appended, or None once the feed
        has closed (a ``None`` answer, or an empty one while idle)."""
        nonlocal N, out_t, out_status, out_y, out_h, out_acc, out_rej
        nonlocal out_obs, out_stats
        got = feed(int(n_space), bool(idle))
        if got is None:
            return None
        y_new, cfg_new = got
        y_new = np.asarray(y_new, dtype=out_y.dtype).reshape((-1, n))
        k = int(y_new.shape[0])
        if k == 0:
            # an idle stream cannot wait on an open, empty feed: it would
            # relaunch all-parked segments for ever
            return None if idle else 0
        backlog_rows.append(y_new, cfg_new)
        out_t = np.concatenate([out_t, np.full((k,), np.nan)])
        out_status = np.concatenate(
            [out_status, np.full((k,), RUNNING, dtype=np.int32)])
        out_y = np.concatenate([out_y, y_new])
        out_h = np.concatenate([out_h, np.full((k,), -1.0)])
        out_acc = np.concatenate([out_acc, np.zeros((k,), dtype=np.int64)])
        out_rej = np.concatenate([out_rej, np.zeros((k,), dtype=np.int64)])
        if out_obs is not None:
            out_obs = {key: np.concatenate(
                [v, np.full((k,), float(observer_init[key]))])
                for key, v in out_obs.items()}
        if out_stats is not None:
            out_stats = {key: np.concatenate(
                [v, np.zeros((k,) + v.shape[1:], dtype=v.dtype)])
                for key, v in out_stats.items()}
        if recorder is not None:
            recorder.counter("fed_lanes", k)
        N += k
        return k

    def emit_progress(seg_i, status_np, acc_np):
        if progress is None:
            return
        live_rows = slot_gid >= 0
        progress({"segment": seg_i,
                  "lanes_done": counts["harvested_lanes"] + int(
                      ((status_np != RUNNING) & live_rows).sum()),
                  "n_lanes": N,
                  "accepted_total": int(out_acc.sum()
                                        + acc_np[live_rows].sum()),
                  "admitted_total": n_seed + counts["admitted_lanes"]})

    gauge_tag = ("" if live_source == "sweep"
                 else "_" + live_source.rpartition("-")[2])

    def publish(seg_i, status_np, acc_np, rej_np):
        """The queue's state at a poll point, from the polled vectors (the
        epoch tag keeps concurrent epochs' gauges apart; counters sum
        across sources)."""
        live_rows = slot_gid >= 0
        lanes_done = counts["harvested_lanes"] + int(
            ((status_np != RUNNING) & live_rows).sum())
        live.publish(
            live_source,
            counters={"lane_attempts": int(out_acc.sum() + out_rej.sum()
                                           + acc_np[live_rows].sum()
                                           + rej_np[live_rows].sum()),
                      "lane_capacity": (int(capacity_lane_segs)
                                        * int(segment_steps))},
            gauges={f"{k}{gauge_tag}": v for k, v in (
                ("segment", int(seg_i)), ("lanes_done", lanes_done),
                ("lanes_total", int(N)),
                ("lanes_running", int(N) - lanes_done),
                ("backlog_depth", int(N - next_gid)),
                ("harvested_lanes", counts["harvested_lanes"]),
                ("admitted_lanes", n_seed + counts["admitted_lanes"]),
                ("resident_bucket", int(B)))})

    done = False
    launched = 0
    try:
        for seg_i in range(max_segments):
            _run_segment(prog, flags, watch, recorder, seg_i)
            launched += 1
            capacity_lane_segs += B
            # the status vector is copied without a wait after every segment
            # and read at poll points: every poll_every segments, and as soon
            # as every resident lane has parked (rather than run all-parked
            # segments until the stride comes round)
            flags.poll(rejected=live is not None)
            if launched % poll_every and launched != max_segments:
                running_any = flags.read()
                polled = flags.take_poll()
                if running_any:
                    continue
            else:
                running_any, polled = _poll_read(flags, recorder, seg_i,
                                                 True)
            status_np, acc_np = polled[:2]
            if live is not None:
                publish(seg_i, *polled)
            emit_progress(seg_i, status_np, acc_np)
            running = status_np == RUNNING
            n_parked = int(B - running.sum())
            if shift_cooldown:
                shift_cooldown -= 1
            if feed is not None and next_gid >= N and n_parked:
                # the live backlog: harvest first (the callbacks fire at
                # this poll), then ask for more, blocking only when nothing
                # runs; with the up-shift armed the ask overshoots the free
                # slots by the climb left, so the backlog can qualify the
                # next rung
                harvest(status_np)
                ask = n_parked
                if upshift_cap is not None and B < upshift_cap:
                    ask += upshift_cap - B
                if feed_more(ask, idle=not running.any()) is None:
                    feed = None
            if upshift_cap is not None:
                backlog = N - next_gid
                B_up = (upshift_bucket(int(running.sum()) + backlog,
                                       buckets, B, cap=upshift_cap)
                        if backlog else None)
                up_streak = (up_streak + 1 if B_up is not None
                             and backlog >= B_up - B else 0)
                if up_streak >= upshift_patience and not shift_cooldown:
                    harvest(status_np)
                    if upshift_now(status_np):
                        up_streak = down_streak = 0
                        shift_cooldown = upshift_patience
                        continue
            if next_gid < N:
                down_streak = 0
                if n_parked >= refill_n or not running.any():
                    harvest(status_np)
                    compact(status_np, min(n_parked, N - next_gid))
            elif not running.any():
                harvest(status_np)
                done = True
                break
            elif (buckets is not None and n_parked and upshift_cap is None
                  and feed is None):
                # the drain tail: the backlog can never refill (an open feed
                # could, and a shrunken program would serialise its lanes)
                harvest(status_np)
                downshift(status_np)
            elif upshift_cap is not None and n_parked:
                down_streak += 1
                if down_streak >= upshift_patience and not shift_cooldown:
                    harvest(status_np)
                    if downshift(status_np):
                        shift_cooldown = upshift_patience
                    down_streak = 0
    except BaseException:
        # a fault mid-window leaves the rung's program state in flight
        graphs.discard(prog)
        _retire_live(live, recorder, None, live_source)
        raise
    if not done:
        # max_segments exhausted: still-running lanes are MaxSteps at their
        # current t; backlog lanes never admitted did no work at all
        status_np, = graphs.fetch(prog.state["seg"]["ctrl"]["final_status"])
        harvest(status_np, force=True)
        never = out_status == RUNNING
        if never.any():
            warnings.warn(
                f"streamed sweep exhausted max_segments with "
                f"{int(never.sum())}/{N} backlog lanes never admitted; "
                f"they report MAX_STEPS_REACHED at t0 having done NO work "
                f"— scale max_segments by the generation count "
                f"(~ceil(N/resident) x per-lane segments)",
                RuntimeWarning, stacklevel=3)
            if recorder is not None:
                recorder.event("fault", kind="admission_starved",
                               lanes=int(never.sum()), n_lanes=N)
        out_status[never] = MAX_STEPS_REACHED
        out_t[never] = t0
    counts["lane_attempts"] = int(out_acc.sum() + out_rej.sum())
    counts["lane_capacity"] = capacity_lane_segs * int(segment_steps)
    with _STREAM_LOCK:
        for k, v in counts.items():
            STREAM_COUNTS[k] += v
    _retire_live(live, recorder, {k: counts[k] for k in (
        "lane_attempts", "lane_capacity")} if recorder is not None
        and launched else None, live_source)
    return SolveResult(
        t=torch.as_tensor(out_t, dtype=dtype),
        y=torch.as_tensor(out_y, dtype=dtype),
        status=torch.as_tensor(out_status),
        n_accepted=torch.as_tensor(out_acc),
        n_rejected=torch.as_tensor(out_rej),
        # n_save=0 placeholders, the solvers' (1,)-row convention
        ts=torch.full((N, 1), float("inf"), dtype=dtype),
        ys=torch.zeros((N, 1, n), dtype=dtype),
        n_saved=torch.zeros((N,), dtype=torch.int64),
        h=torch.as_tensor(out_h, dtype=dtype),
        observed=(None if observer is None else
                  {k: torch.as_tensor(v, dtype=dtype)
                   for k, v in out_obs.items()}),
        stats=(None if out_stats is None else
               {k: torch.as_tensor(v) for k, v in out_stats.items()}))


def sweep_report(res, cfgs=None):
    """Failure-detection summary for an ensemble SolveResult: per-status
    lane counts, indices of failed lanes, the accepted and rejected steps
    per lane (min, max, mean) and, with ``cfgs``, the offending parameter
    values per failed lane."""
    status = res.status.cpu().numpy()
    names = {SUCCESS: "success", MAX_STEPS_REACHED: "max_steps",
             DT_UNDERFLOW: "dt_underflow", RUNNING: "running"}
    counts = {names.get(int(s), str(int(s))): int((status == s).sum())
              for s in np.unique(status)}
    failed = np.nonzero(status != SUCCESS)[0]
    n_acc = res.n_accepted.cpu().numpy()
    n_rej = res.n_rejected.cpu().numpy()
    report = {
        "n_lanes": int(status.shape[0]),
        "counts": counts,
        "failed_lanes": failed.tolist(),
        "n_accepted": {"min": int(np.min(n_acc)), "max": int(np.max(n_acc)),
                       "mean": float(np.mean(n_acc))},
        "n_rejected": {"min": int(np.min(n_rej)), "max": int(np.max(n_rej)),
                       "mean": float(np.mean(n_rej))},
    }
    if cfgs is not None and failed.size:
        report["failed_conditions"] = {
            k: v.cpu().numpy()[failed].tolist() for k, v in cfgs.items()}
    return report


def ignition_observer(marker, mode="half", frac=0.5):
    """(observer, init) pair extracting ignition delay during the solve.

    ``mode="half"`` records the first accepted time the marker species
    drops below ``frac`` x its first-seen value, linearly interpolated
    between the bracketing accepted steps (fuel-consumption marker);
    ``mode="peak"`` records the time of the running maximum.  The fold is
    lane-batched: ``observer(t (B,), y (B, S), acc) -> acc``; ``init``
    holds Python floats (the sweep driver broadcasts them to lanes).  Read
    ``observed["tau"]`` (NaN where never crossed)."""
    if mode == "half":
        nan = float("nan")
        init = {"m0": nan, "tau": nan, "t_prev": nan, "m_prev": nan}

        def observer(t, y, acc):
            m = y[:, marker]
            m0 = torch.where(torch.isnan(acc["m0"]), m, acc["m0"])
            thr = frac * m0
            crossed = torch.isnan(acc["tau"]) & (m < thr)
            denom = acc["m_prev"] - m
            w = torch.where(denom != 0, (acc["m_prev"] - thr) / denom, 1.0)
            w = torch.clamp(w, 0.0, 1.0)
            t_x = torch.where(torch.isnan(acc["t_prev"]), t,
                              acc["t_prev"] + w * (t - acc["t_prev"]))
            return {"m0": m0, "tau": torch.where(crossed, t_x, acc["tau"]),
                    "t_prev": t, "m_prev": m}

    elif mode == "peak":
        init = {"m_max": -float("inf"), "tau": float("nan")}

        def observer(t, y, acc):
            m = y[:, marker]
            higher = m > acc["m_max"]
            return {"m_max": torch.maximum(m, acc["m_max"]),
                    "tau": torch.where(higher, t, acc["tau"])}

    else:
        raise ValueError(f"unknown ignition observer mode {mode!r}")
    return observer, init


def ignition_delay(ts, ys, marker, mode="peak"):
    """Per-lane ignition delay from saved trajectories, (B,):
    ``mode="peak"`` gives the time of the marker species' maximum (e.g.
    OH), ``"half"`` the first time it drops below half its initial value
    (fuel consumption), or the last valid time where it never does.
    ``ts`` (B, n_save) +inf-padded, ``ys`` (B, n_save, S), ``marker`` a
    species index.  Energy-mode sweeps get the physical detector in-loop
    instead (``energy/ignition.py``, ``out["ignition_delay"]``)."""
    c = ys[..., marker]
    valid = torch.isfinite(ts)
    if mode == "peak":
        idx = torch.argmax(torch.where(valid, c, -torch.inf), dim=-1)
    elif mode == "half":
        below = valid & (c < 0.5 * c[..., :1])
        idx = torch.argmax(below.to(torch.uint8), dim=-1)
        last = torch.sum(valid, dim=-1) - 1
        idx = torch.where(torch.any(below, dim=-1), idx, last)
    else:
        raise ValueError(f"unknown ignition-delay mode {mode!r}")
    return torch.gather(ts, -1, idx[..., None])[..., 0]
