"""SolverSession: the warm, device-resident half of the serving daemon.

Port of ``batchreactor_tpu/serving/session.py``.  A session owns what must
exist before the first request can be answered fast: the mechanism
(parsed once, on the session's device), the exact sweep callables
``batch_reactor_sweep`` builds (``api._sweep_fns``: the same callables,
kept for the session's life, so the streaming driver replays the graphs it
captured for them), the bucket ladder and solver settings, and the obs
plane (recorder, live registry and a session-wide ``CompileWatch``).

:meth:`SolverSession.warmup` takes the place of the reference's AOT
warmup: it runs one short stream per ladder rung, per energy mode and per
resident epoch, so every rung's ``begin``/``window``/``end``/``compact``
graphs are captured (on the CPU: built) before the first request, and pins
those programs (``solver.graphs.pinned``) so the program cache's LRU cap
never evicts them while the session serves.  The warm contract:
after :meth:`warmup`, a served stream captures and builds nothing
(:meth:`program_compiles` all zero).

Sessions are keyed by :attr:`fingerprint`, a content hash of the sweep
callables (their code and the mechanism tensors they capture, read
through the host) and the observer's initial values: equal in two
processes, which the fleet's upload replication relies on.  It is not the
JAX package's value (that one hashes XLA-side objects).

The session spec (``serve.json``) is the reference's file, read
unchanged by :func:`load_spec`, so one spec drives either package.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np

from .schema import Request  # noqa: F401  (re-exported for callers)

#: spec keys, per section — unknown keys are loud errors (the schema.py
#: convention: a typo'd knob must not be silently ignored)
_MECH_KEYS = ("mech", "therm")
_SOLVER_KEYS = ("method", "rtol", "atol", "jac_window", "linsolve",
                "setup_economy", "stale_tol", "segment_steps",
                "max_attempts", "stats", "ignition_marker",
                "ignition_mode", "mech_operands", "species_buckets",
                "reaction_buckets", "energy_modes")
_SERVE_KEYS = ("resident", "refill", "buckets", "poll_every",
               "max_queue_lanes", "idle_timeout_s", "request_timeout_s",
               "max_lanes_per_request", "coalesce_s",
               "coalesce_adaptive", "max_mechanisms",
               "slow_request_s", "resident_epochs", "mesh_resident",
               "upshift", "upshift_patience")

#: the horizon of a warmup stream [s]: the windows are fixed-trip, so a
#: short one captures the same graphs as a long one
WARMUP_T1 = 1e-7


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """A validated serving session spec (``serve.json``).  ``mech`` /
    ``therm`` are resolved absolute paths; everything else is the
    solver/serve config with defaults applied (the reference's fields
    and defaults)."""

    mech: str
    therm: str
    # solver config (the sweep flag set — part of every program key)
    method: str = "bdf"
    rtol: float = 1e-6
    atol: float = 1e-10
    jac_window: object = None        # None = the device rule
    linsolve: str = "auto"
    setup_economy: bool = False
    stale_tol: float = 0.3
    segment_steps: int = 64
    max_attempts: int = 200_000
    stats: bool = True
    ignition_marker: object = None
    ignition_mode: str = "half"
    #: mechanism-shape padding: ``mech_operands=True`` pads the mechanism
    #: onto the ``species_buckets`` x ``reaction_buckets`` (S, R) rung
    #: (pow2 ladders by default) and passes the padded bundle to the
    #: driver as ``rhs_bundle=``, so a second mechanism of the same rung
    #: replays the first one's graphs wherever the bundles' signatures
    #: agree
    mech_operands: bool = False
    species_buckets: object = None
    reaction_buckets: object = None
    #: non-isothermal serving: the energy modes this session warms and
    #: serves (each its own program family, the state one row wider)
    energy_modes: tuple = ()
    # serve config (scheduler/capacity — NOT part of the program keys)
    resident: int = 8
    refill: object = 1
    buckets: object = "pow2"
    poll_every: int = 1
    max_queue_lanes: int = 256
    idle_timeout_s: float = 0.25
    request_timeout_s: float = 300.0
    max_lanes_per_request: object = None
    #: batching window: a fresh epoch waits up to this long for the
    #: queue to fill one resident program before seeding
    coalesce_s: float = 0.0
    #: scale the coalesce window by the queue's fill fraction
    coalesce_adaptive: bool = False
    #: multi-mechanism store capacity (SessionStore)
    max_mechanisms: int = 8
    #: slow-request alarm threshold [s] (0 = off)
    slow_request_s: float = 0.0
    #: resident streaming epochs run at once (``"auto"`` = one per
    #: CUDA device)
    resident_epochs: object = 1
    #: one stream per device over this many devices (``True`` = all)
    mesh_resident: object = None
    #: the lane ceiling the resident program may climb to
    upshift: object = None
    #: consecutive qualifying polls before a shift fires
    upshift_patience: int = 2


def load_spec(source):
    """``serve.json`` -> :class:`SessionSpec`.  ``source`` is a path, a
    JSON string, or an already-parsed dict; relative mechanism paths
    resolve against the spec file's directory.  Unknown keys at any level
    are loud ``ValueError``s (the reference's grammar, checks and
    messages)."""
    base = os.getcwd()
    if isinstance(source, dict):
        obj = source
    else:
        text = str(source)
        if text.lstrip().startswith("{"):
            obj = json.loads(text)
        else:
            base = os.path.dirname(os.path.abspath(text))
            with open(text) as f:
                obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"session spec must be a JSON object; got "
                         f"{type(obj).__name__}")
    unknown = sorted(set(obj) - {"mechanism", "solver", "serve"})
    if unknown:
        raise ValueError(f"unknown session-spec section(s) {unknown}; "
                         f"known: ['mechanism', 'solver', 'serve']")
    mech_sec = obj.get("mechanism")
    if not isinstance(mech_sec, dict):
        raise ValueError("session spec needs a 'mechanism' section "
                         "{'mech': ..., 'therm': ...}")

    def _section(sec, known, name):
        unknown = sorted(set(sec) - set(known))
        if unknown:
            raise ValueError(f"unknown {name} key(s) {unknown}; known: "
                             f"{list(known)}")
        return dict(sec)

    mech_sec = _section(mech_sec, _MECH_KEYS, "mechanism")
    for key in _MECH_KEYS:
        if key not in mech_sec:
            raise ValueError(f"session spec mechanism section needs "
                             f"{key!r}")
    kw = {}
    kw.update(_section(obj.get("solver") or {}, _SOLVER_KEYS, "solver"))
    kw.update(_section(obj.get("serve") or {}, _SERVE_KEYS, "serve"))
    if isinstance(kw.get("buckets"), list):
        kw["buckets"] = tuple(int(b) for b in kw["buckets"])
    if kw.get("energy_modes") is not None:
        from .schema import ENERGY_MODES

        modes = tuple(kw["energy_modes"])
        bad = [m for m in modes if m not in ENERGY_MODES]
        if bad:
            raise ValueError(
                f"session spec: unknown energy mode(s) {bad}; "
                f"accepted: {list(ENERGY_MODES)}")
        kw["energy_modes"] = modes
    resolve = (lambda p: p if os.path.isabs(p)
               else os.path.normpath(os.path.join(base, p)))
    spec = SessionSpec(mech=resolve(mech_sec["mech"]),
                       therm=resolve(mech_sec["therm"]), **kw)
    if spec.method not in ("bdf", "sdirk"):
        raise ValueError(f"session spec: unknown method {spec.method!r}")
    if int(spec.resident) < 1:
        raise ValueError(f"session spec: resident must be >= 1, got "
                         f"{spec.resident!r}")
    if int(spec.segment_steps) < 1:
        raise ValueError(f"session spec: segment_steps must be >= 1, "
                         f"got {spec.segment_steps!r}")
    if int(spec.max_queue_lanes) < 1:
        raise ValueError(f"session spec: max_queue_lanes must be >= 1, "
                         f"got {spec.max_queue_lanes!r}")
    re_ = spec.resident_epochs
    if re_ != "auto" and (isinstance(re_, bool)
                          or not isinstance(re_, int) or re_ < 1):
        raise ValueError(f"session spec: resident_epochs must be an "
                         f"int >= 1 or 'auto', got {re_!r}")
    mr = spec.mesh_resident
    if mr is not None and mr is not True and mr is not False and (
            isinstance(mr, bool) or not isinstance(mr, int) or mr < 1):
        raise ValueError(f"session spec: mesh_resident must be null, "
                         f"true (all local devices), or an int >= 1; "
                         f"got {mr!r}")
    up = spec.upshift
    if up is not None and (isinstance(up, bool)
                           or not isinstance(up, int)
                           or up < int(spec.resident)):
        raise ValueError(f"session spec: upshift must be an int >= "
                         f"resident ({spec.resident}) — it is the lane "
                         f"CEILING the resident program may climb to; "
                         f"got {up!r}")
    if int(spec.upshift_patience) < 1:
        raise ValueError(f"session spec: upshift_patience must be >= 1, "
                         f"got {spec.upshift_patience!r}")
    return spec


def session_fingerprint(rhs, jac, observer, observer_init):
    """Content hash of a session's sweep callables and observer: their
    code and what they capture (mechanism tensors through the host), so
    two processes that load one mechanism agree."""
    import hashlib

    from ..parallel.checkpoint import _hash_callable, _hash_value

    h = hashlib.sha256()
    h.update(b"br-torch-session-fingerprint-v1")
    for fn in (rhs, jac, observer):
        if fn is None:
            h.update(b"none")
        else:
            _hash_callable(h, fn)
    _hash_value(h, dict(observer_init or {}))
    return h.hexdigest()


class SolverSession:
    """Module doc.  Build with :meth:`from_spec` (parses the mechanism) or
    directly from ``gm``/``thermo`` objects.  ``device=None`` means
    ``cuda`` and raises without a GPU; the tests pass ``"cpu"``."""

    #: serving epochs are open-ended: the stream lives while its feed
    #: does, so the segment ceiling is a runaway bound, not a budget
    MAX_SEGMENTS = 1 << 30

    def __init__(self, gm, thermo, spec, recorder=None, device=None):
        import torch

        from ..aot.buckets import normalize_buckets, resolve_bucket
        from ..api import (_padded_mech, _segmented_builder, _sweep_fns,
                           resolve_jac_window)
        from ..device import resolve_device
        from ..obs import CompileWatch, LiveRegistry, Recorder

        self.device = resolve_device(device)
        self.spec = spec
        self.gm = gm.to(self.device)
        self.thermo = thermo.to(self.device)
        self.species = tuple(self.thermo.species)
        self._sp_idx = {s.upper(): k for k, s in enumerate(self.species)}
        # the host copy request packing reads (no device from HTTP threads)
        self._molwt = self.thermo.molwt.detach().to(
            "cpu", dtype=torch.float64)
        marker_idx = None
        if spec.ignition_marker is not None:
            key = str(spec.ignition_marker).upper()
            if key not in self._sp_idx:
                raise ValueError(
                    f"session spec: ignition_marker "
                    f"{spec.ignition_marker!r} not in the mechanism")
            marker_idx = self._sp_idx[key]
        # mechanism-shape resolution (api rule: operand mode defaults both
        # ladders to pow2): the padded twins drive the kernels, while
        # self.species/self.thermo stay live for packing and rendering
        sb, rb = spec.species_buckets, spec.reaction_buckets
        if spec.mech_operands:
            sb = "pow2" if sb is None else sb
            rb = "pow2" if rb is None else rb
        sb, rb = normalize_buckets(sb), normalize_buckets(rb)
        self.mech_shape = None
        self.mech_bundle = None
        gm_k, th_k = self.gm, self.thermo
        if sb is not None or rb is not None:
            s_pad = (resolve_bucket(len(self.species), sb)
                     if sb is not None else len(self.species))
            r_pad = (resolve_bucket(self.gm.n_reactions, rb)
                     if rb is not None else self.gm.n_reactions)
            self.mech_shape = (s_pad, r_pad)
            gm_k, th_k = _padded_mech(self.gm, self.thermo, s_pad, r_pad,
                                      canonical=bool(spec.mech_operands))

        def fns(energy):
            return _sweep_fns("gas", None, gm_k, None, th_k, False, True,
                              False, marker_idx, spec.ignition_mode,
                              "analytic", energy)

        # the exact callables batch_reactor_sweep builds, kept for the
        # session's life: the driver keys its graphs by their identity
        self.rhs, self.jac, self.observer, self.observer_init = fns(None)
        # content-based even in operand mode, where the execution
        # callable is the shared builder: two mechanisms sharing graphs
        # are still two sessions
        self.fingerprint = session_fingerprint(
            self.rhs, self.jac, self.observer, self.observer_init)
        if spec.mech_operands:
            self.mech_bundle = (gm_k, None, th_k)
            self.rhs = _segmented_builder("gas", None, False, True, False)
            self.jac = None
        self._mode_fns = {None: (self.rhs, self.jac, self.observer,
                                 self.observer_init)}
        for m in tuple(spec.energy_modes or ()):
            rhs_m, jac_m, obs_m, obs0_m = fns(m)
            if spec.mech_operands:
                rhs_m = _segmented_builder("gas", None, False, True, False,
                                           m)
                jac_m = None
            self._mode_fns[m] = (rhs_m, jac_m, obs_m, obs0_m)
        self.jac_window = resolve_jac_window(spec.jac_window, spec.method,
                                             self.device)
        self.buckets = normalize_buckets(spec.buckets)
        # capacity plane: "auto"/True count the CUDA devices
        n_dev = (max(1, torch.cuda.device_count())
                 if self.device.type == "cuda" else 1)
        mr = spec.mesh_resident
        self.mesh_resident = (n_dev if mr is True else int(mr) if mr
                              else None)
        self._mesh_size = self.mesh_resident or 1
        self.resident_epochs = (n_dev if spec.resident_epochs == "auto"
                                else max(1, int(spec.resident_epochs)))
        #: the largest resident program shape the session will run
        self.bucket_cap = resolve_bucket(int(spec.resident), self.buckets,
                                         mesh_size=self._mesh_size)
        self.recorder = recorder if recorder is not None else Recorder()
        self.registry = LiveRegistry(
            recorder=self.recorder,
            meta={"entry": "serving", "fingerprint": self.fingerprint,
                  "mech": os.path.basename(spec.mech),
                  "bucket_cap": self.bucket_cap})
        self._watch = CompileWatch(recorder=self.recorder,
                                   default_label="serve-host")
        self._watch_entered = False
        self.warmed = None      # list of warmed programs after warmup()
        self.warmup_summary = None
        #: the first CUDA error an epoch raised (ROADMAP C6: not retried
        #: in-process; the daemon drains and exits non-zero)
        self.fatal = None
        # the owner token pinning this session's warmed programs
        self._pin = ("serving-session", id(self), self.fingerprint)
        self._streams = {}
        self._streams_lock = threading.Lock()
        self._t0 = time.time()

    @classmethod
    def from_spec(cls, source, recorder=None, device=None):
        from ..device import resolve_device
        from ..models.gas import compile_gaschemistry
        from ..models.thermo import create_thermo

        spec = load_spec(source)
        dev = resolve_device(device)
        gm = compile_gaschemistry(spec.mech, device=dev)
        th = create_thermo(list(gm.species), spec.therm, device=dev)
        return cls(gm, th, spec, recorder=recorder, device=dev)

    # ---- lifecycle --------------------------------------------------------
    def __enter__(self):
        if not self._watch_entered:
            self._watch.__enter__()
            self._watch_entered = True
        return self

    def __exit__(self, *exc):
        if self._watch_entered:
            self._watch_entered = False
            self._watch.__exit__(*exc)

    def release(self):
        """Unpin and drop the programs this session warmed
        (``solver.graphs.release``): the store's eviction path."""
        from ..solver import graphs

        graphs.release(self._pin)

    def compile_summary(self):
        """The session watch's summary (``obs.CompileWatch``: graph
        captures as ``compiles``, programs built as ``traces``)."""
        return self._watch.summary()

    def program_compiles(self):
        """Graph captures plus programs built per armed single-program
        label (``sweep-segment`` / ``sweep-compact``) while the session
        was entered — the warm contract: all zeros after :meth:`warmup`
        (on the card captures, on the CPU builds; host-side work rides
        the unarmed ``serve-host`` label)."""
        w = self._watch.summary()
        return {label: e["compiles"] + e["traces"]
                for label, e in (w.get("by_label") or {}).items()
                if e.get("single_program")}

    # ---- the per-mode callables and the sweep flag set --------------------
    def _energy_fns(self, energy):
        """The per-mode ``(rhs, jac, observer, observer_init)`` set; loud
        on a mode the session never built."""
        try:
            return self._mode_fns[energy]
        except KeyError:
            raise ValueError(
                f"energy mode {energy!r} is not enabled on this "
                f"session (warmed modes: "
                f"{list(self.spec.energy_modes)}); add it to the "
                f"session spec's solver.energy_modes") from None

    def _stream_flags(self, rtol, atol, energy=None):
        """The sweep flag set shared by :meth:`stream` and
        :meth:`warmup`, so the warmed program keys cannot drift from the
        served ones."""
        s = self.spec
        _rhs, jac_m, obs_m, obs0_m = self._energy_fns(energy)
        flags = dict(method=s.method, rtol=float(rtol), atol=float(atol),
                     jac=jac_m, observer=obs_m, observer_init=obs0_m,
                     jac_window=self.jac_window, linsolve=s.linsolve,
                     setup_economy=bool(s.setup_economy),
                     stale_tol=float(s.stale_tol), stats=bool(s.stats),
                     segment_steps=int(s.segment_steps),
                     max_attempts=int(s.max_attempts))
        if self.mech_bundle is not None:
            flags["rhs_bundle"] = self.mech_bundle
        return flags

    def epoch_sources(self):
        """The live sources (and program owners) of the session's
        resident epochs, as the scheduler names them."""
        if self.resident_epochs <= 1:
            return ("sweep",)
        return tuple(f"sweep-e{k}" for k in range(self.resident_epochs))

    def _cuda_stream(self, source):
        """The CUDA stream of one epoch (its own, so two epochs on one
        card overlap), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        import torch

        with self._streams_lock:
            st = self._streams.get(source)
            if st is None:
                st = self._streams[source] = torch.cuda.Stream(self.device)
            return st

    # ---- warmup -------------------------------------------------------------
    def warmup_rungs(self):
        """The ``(rung, linsolve)`` pairs :meth:`warmup` runs per energy
        mode and epoch: every ladder rung up to the resident cap (or the
        up-shift ceiling) with every linear algebra a stream of the
        session can carry — ``"auto"`` resolves with a stream's first
        rung and keeps it on every rung the stream shifts to."""
        from ..aot.buckets import resolve_bucket
        from ..solver.linalg import resolve_linsolve

        top = self.bucket_cap
        if self.spec.upshift is not None:
            top = max(top, resolve_bucket(int(self.spec.upshift),
                                          self.buckets,
                                          mesh_size=self._mesh_size))
        if self.buckets is None:
            rungs = (top,)
        else:
            rungs = tuple(sorted({
                resolve_bucket(b, self.buckets, mesh_size=self._mesh_size)
                for b in range(1, top + 1)}))
            rungs = tuple(b for b in rungs if b <= top)
        out = []
        for mode in (None,) + tuple(self.spec.energy_modes or ()):
            n = len(self.species) if self.mech_shape is None \
                else self.mech_shape[0]
            n += 0 if mode is None else 1
            solvers = []
            for r in rungs:
                ls = resolve_linsolve(self.spec.linsolve,
                                      method=self.spec.method,
                                      device=self.device,
                                      batch=r // self._mesh_size, n=n)
                if ls not in solvers:
                    solvers.append(ls)
            out.extend((mode, r, ls) for r in sorted(rungs, reverse=True)
                       for ls in solvers)
        return out

    def _exemplar(self, k, energy=None):
        """``k`` exemplar lanes: the first species alone at 1500 K, packed
        by :meth:`request_lanes` (so their keys and shapes are the served
        ones)."""
        req = Request(id="warmup", T=np.full((k,), 1500.0),
                      p=np.full((k,), 1e5), Asv=np.ones((k,)),
                      X={self.species[0]: np.ones((k,))}, t1=WARMUP_T1,
                      rtol=self.spec.rtol, atol=self.spec.atol,
                      energy=energy)
        return self.request_lanes(req)

    def warmup(self, log=None):
        """Capture (on the CPU: build) every program the session can serve
        from — one short stream per :meth:`warmup_rungs` entry and per
        resident epoch, seeded with one lane more than the rung so the
        ``compact`` step runs too — and pin the programs to the session.
        Returns the list of warmed ``{"energy", "rung", "linsolve",
        "source"}`` entries; :attr:`warmup_summary` holds the captures and
        the wall."""
        from ..obs import CompileWatch
        from ..solver import graphs

        t0 = time.perf_counter()
        # the warmup's captures are its own, not the served window's
        entered = self._watch_entered
        if entered:
            self.__exit__(None, None, None)
        watch = CompileWatch(default_label="serve-warmup")
        warmed = []
        try:
            with watch, graphs.pinned(self._pin):
                for mode, rung, ls in self.warmup_rungs():
                    y0s, cfgs = self._exemplar(rung + 1, energy=mode)
                    for src in self.epoch_sources():
                        self._run(y0s, cfgs, t1=WARMUP_T1,
                                  rtol=self.spec.rtol, atol=self.spec.atol,
                                  energy=mode, live_source=src,
                                  admission=rung, linsolve=ls)
                        warmed.append({"energy": mode, "rung": rung,
                                       "linsolve": ls, "source": src})
                        if log is not None:
                            log(f"[warmup] rung={rung} energy={mode} "
                                f"linsolve={ls} epoch={src}")
        finally:
            if entered:
                self.__enter__()
        wall = time.perf_counter() - t0
        w = watch.summary()
        self.warmup_summary = {"captures": w["compiles"],
                               "programs": w["traces"],
                               "pinned": graphs.pinned_programs(self._pin),
                               "wall_s": wall}
        self.warmed = warmed
        if self.recorder is not None:
            self.recorder.counter("serve_warmup_s", wall)
        return warmed

    # ---- request -> lanes -------------------------------------------------
    def _solution_vectors(self, X, T, p):
        """y0 = rho Y_k per lane, float64 on the host (the sweep's
        construction: ``parallel.grid.sweep_solution_vectors``)."""
        import torch

        from ..parallel.grid import sweep_solution_vectors

        return sweep_solution_vectors(
            torch.as_tensor(X, dtype=torch.float64), self._molwt,
            torch.as_tensor(np.asarray(T, dtype=np.float64)),
            torch.as_tensor(np.asarray(p, dtype=np.float64))).numpy()

    def _pad_lanes(self, y0, cfg):
        """Dead-species padding of packed lane blocks: zero mass columns
        and the live-count norm operand (``models/padding.py``)."""
        from ..solver.common import NLIVE_KEY

        k, s_live = y0.shape[0], y0.shape[1]
        s_pad = self.mech_shape[0]
        if s_live < s_pad:
            y0 = np.concatenate(
                [y0, np.zeros((k, s_pad - s_live), dtype=y0.dtype)],
                axis=1)
        cfg = dict(cfg)
        cfg[NLIVE_KEY] = np.full((k,), float(len(self.species)))
        return y0, cfg

    def _energy_lanes(self, y0, cfg, T, atol):
        """Energy-mode lanes: the trailing T state row (after the species
        padding), the live count bumped for it, and the T-row atol weight
        — ``batch_reactor_sweep``'s ``energy/eqns.py`` construction."""
        from ..energy.eqns import energy_atol_scale
        from ..solver.common import ATOL_SCALE_KEY, NLIVE_KEY

        k = y0.shape[0]
        y0 = np.concatenate(
            [y0, np.asarray(T, dtype=np.float64)[:, None]], axis=1)
        cfg = dict(cfg)
        if NLIVE_KEY in cfg:
            cfg[NLIVE_KEY] = np.asarray(cfg[NLIVE_KEY]) + 1.0
        cfg[ATOL_SCALE_KEY] = energy_atol_scale(
            k, y0.shape[1], atol, device="cpu").numpy()
        return y0, cfg

    def request_lanes(self, req):
        """Pack one validated :class:`~.schema.Request` into host lane
        blocks, float64: ``(y0 (k, n), {"T": (k,), "Asv": (k,), ...})`` —
        the state ``batch_reactor_sweep`` builds.  Touches no device (it
        runs on the HTTP threads)."""
        k = req.n_lanes
        X = np.zeros((k, len(self.species)))
        for name, vals in req.X.items():
            X[:, self._sp_idx[name.upper()]] = vals
        y0 = self._solution_vectors(X, req.T, req.p)
        cfg = {"T": np.asarray(req.T, dtype=np.float64),
               "Asv": np.asarray(req.Asv, dtype=np.float64)}
        if self.mech_shape is not None:
            y0, cfg = self._pad_lanes(y0, cfg)
        if getattr(req, "energy", None) is not None:
            self._energy_fns(req.energy)   # loud before anything queues
            y0, cfg = self._energy_lanes(y0, cfg, req.T, req.atol)
        return y0, cfg

    # ---- the resident stream ------------------------------------------------
    def _run(self, y0s, cfgs, *, t1, rtol, atol, energy, live_source,
             admission, linsolve=None, on_harvest=None, feed=None,
             recorder=None, live=None, watch=None):
        """One streaming sweep on the session's device and on the epoch's
        own CUDA stream; ``linsolve`` overrides the spec's (warmup)."""
        import contextlib

        import torch

        from ..parallel.sweep import ensemble_solve_segmented

        s = self.spec
        flags = self._stream_flags(rtol, atol, energy)
        if linsolve is not None:
            flags["linsolve"] = linsolve
        cs = self._cuda_stream(live_source)
        with contextlib.ExitStack() as stack:
            if cs is not None:
                stack.enter_context(torch.cuda.device(self.device))
                stack.enter_context(torch.cuda.stream(cs))
            y0 = torch.as_tensor(np.asarray(y0s, dtype=np.float64)).to(
                self.device)
            cfg = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                   for k, v in cfgs.items()}
            return ensemble_solve_segmented(
                self._energy_fns(energy)[0], y0, 0.0, float(t1), cfg,
                max_segments=self.MAX_SEGMENTS, admission=int(admission),
                refill=s.refill, buckets=self.buckets,
                poll_every=int(s.poll_every),
                mesh_resident=self.mesh_resident,
                upshift=(None if s.upshift is None or feed is None
                         else int(s.upshift)),
                upshift_patience=int(s.upshift_patience),
                recorder=recorder, watch=watch, live=live,
                _on_harvest=on_harvest,
                _feed=feed, _live_source=str(live_source), **flags)

    def stream(self, y0s, cfgs, *, t1, rtol, atol, energy=None,
               on_harvest=None, feed=None, live_source="sweep"):
        """Run one resident streaming epoch over the given backlog (host
        blocks, moved to the session's device) with the scheduler's
        harvest/feed hooks attached (``parallel.ensemble_solve_segmented``
        ``_on_harvest``/``_feed``).  ``energy`` selects the per-mode
        program family; ``live_source`` names the epoch (its live gauges,
        its CUDA stream and its programs).  Blocks until the feed closes
        and every admitted lane harvests.  A CUDA error is recorded in
        :attr:`fatal` and re-raised (never retried in-process)."""
        from ..resilience.policy import cuda_error

        try:
            return self._run(
                y0s, cfgs, t1=t1, rtol=rtol, atol=atol, energy=energy,
                live_source=live_source, admission=int(self.spec.resident),
                on_harvest=on_harvest, feed=feed, recorder=self.recorder,
                live=self.registry,
                watch=self._watch if self._watch_entered else None)
        except BaseException as e:
            if cuda_error(e) and self.fatal is None:
                self.fatal = e
            raise

    # ---- results -> response payload ----------------------------------------
    def fractions(self, y_rows):
        """Final mole fractions per lane from final-state rows."""
        y = np.asarray(y_rows)
        ng = len(self.species)
        moles = y[:, :ng] / self._molwt.numpy()
        return moles / moles.sum(axis=1, keepdims=True)

    def render_result(self, result):
        """A scheduler :class:`~.scheduler.RequestResult` -> the ``ok``
        response payload (the reference's keys)."""
        from ..api import _status_str

        x = self.fractions(result.y)
        payload = {
            "lanes": int(result.t.shape[0]),
            "t": [float(v) for v in result.t],
            "solver_status": [_status_str(c) for c in result.status],
            "provenance": list(result.provenance),
            "x": {s: [float(v) for v in x[:, k]]
                  for k, s in enumerate(self.species)},
            "n_accepted": [int(v) for v in result.n_accepted],
            "n_rejected": [int(v) for v in result.n_rejected],
            "elapsed_ms": round(1e3 * result.elapsed_s, 3),
        }
        if result.observed is not None and "tau" in result.observed:
            payload["tau"] = [float(v) for v in result.observed["tau"]]
        if getattr(result.request, "energy", None) is not None:
            from ..energy.ignition import extract_delay

            payload["energy"] = result.request.energy
            payload["T"] = [float(v) for v in np.asarray(result.y)[:, -1]]
            if (result.observed is not None
                    and "ign_tau_dT" in result.observed):
                delay = np.asarray(extract_delay(result.observed))
                payload["ignition_delay"] = [
                    None if np.isnan(v) else float(v) for v in delay]
        if result.stats is not None:
            from ..obs import counters as C

            payload["stats"] = {
                k: np.asarray(v).tolist() for k, v in result.stats.items()
                if k not in C.AUDIT_KEYS and k not in C.TIMELINE_KEYS}
        if getattr(result.request, "trace", False) \
                and result.trace is not None:
            payload["trace"] = result.trace.to_payload()
        return payload

    def obs_report(self, meta=None):
        """The session's ``br-obs-v1`` report (spans, counters, the
        ``serve_stage_seconds`` histograms, the ``request_trace``
        events)."""
        from ..obs import build_report

        base = {"entry": "serving", "fingerprint": self.fingerprint,
                "mech": os.path.basename(self.spec.mech)}
        return build_report(recorder=self.recorder, watch=self._watch,
                            meta={**base, **(meta or {})})

    def healthz_extra(self):
        """Serving fields the daemon folds into ``/healthz``."""
        w = self.compile_summary()
        return {"fingerprint": self.fingerprint,
                "species": len(self.species),
                "device": str(self.device),
                "bucket_cap": self.bucket_cap,
                "resident_epochs": self.resident_epochs,
                "mesh_resident": self.mesh_resident,
                "upshift": (None if self.spec.upshift is None
                            else int(self.spec.upshift)),
                "mech_shape": self.mech_shape,
                "mech_operands": self.mech_bundle is not None,
                "energy_modes": list(self.spec.energy_modes or ()),
                "warmed": (None if self.warmed is None
                           else len(self.warmed)),
                "compiles": w.get("compiles"),
                "program_compiles": sum(self.program_compiles()
                                        .values()),
                "uptime_s": round(time.time() - self._t0, 3)}


class UnknownMechanism(KeyError):
    """A solve request's ``mech`` routing key matched no resident
    session (schema error code ``unknown_mechanism``)."""


class SessionStore:
    """The ``{fingerprint: SolverSession}`` multi-mechanism store (the
    reference's, without its AOT manifest): every resident mechanism owns
    a session and scheduler pair, keyed by the session's fingerprint and
    aliased by upload id, with the base spec's solver/serve sections as
    the shared template.

    At most ``spec.max_mechanisms`` resident sessions; beyond that the
    least recently requested unpinned session is drained, closed and its
    programs dropped (``graphs.release``; the ``mech_evicted`` counter).
    The default session (the daemon's spec mechanism) is pinned.  Every
    mutation of the session map holds ``_lock``."""

    def __init__(self, session, scheduler=None, *, upload_dir=None,
                 scheduler_factory=None):
        import tempfile

        from .scheduler import Scheduler

        self._lock = threading.RLock()
        self._factory = scheduler_factory or (lambda s: Scheduler(s))
        self.recorder = session.recorder
        self.base_spec = session.spec
        self.device = session.device
        self.max_mechanisms = max(1, int(
            getattr(session.spec, "max_mechanisms", 8)))
        self._entries = {}      # fingerprint -> entry dict
        self._aliases = {}      # upload/mech id -> fingerprint
        self._owns_dir = upload_dir is None
        self._dir = upload_dir or tempfile.mkdtemp(prefix="br-mechs-")
        self._seq = 0
        if scheduler is None:
            scheduler = self._factory(session)
        self.default_fingerprint = session.fingerprint
        self._admit(session, scheduler, mech_id="default", pinned=True)

    # ---- admission ---------------------------------------------------------
    def _admit(self, session, scheduler, mech_id, pinned=False):
        redundant = None
        with self._lock:
            fp = session.fingerprint
            entry = self._entries.get(fp)
            if entry is None:
                self._seq += 1
                entry = {"session": session, "scheduler": scheduler,
                         "ids": set(), "pinned": pinned,
                         "last_used": self._seq}
                self._entries[fp] = entry
                if self.recorder is not None:
                    self.recorder.counter("mech_admitted")
            elif entry["session"] is not session:
                # two concurrent uploads of one mechanism: first admit
                # wins, the loser's freshly-started pair shuts down
                redundant = scheduler
            entry["pinned"] = entry["pinned"] or pinned
            if mech_id is not None:
                entry["ids"].add(str(mech_id))
                self._aliases[str(mech_id)] = fp
            evicted = self._pop_over_capacity_locked(keep=fp)
        # teardown outside the lock: a victim drain joins a worker that
        # may still be finishing device solves
        for victim in evicted:
            self._teardown(victim)
        if redundant is not None:
            try:
                redundant.drain(timeout=5.0)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            session.__exit__(None, None, None)
            session.release()
        return fp

    def _pop_over_capacity_locked(self, keep=None):
        """Pop LRU unpinned entries beyond capacity (map surgery only);
        returns them for the caller to tear down outside the lock."""
        popped = []
        while len(self._entries) > self.max_mechanisms:
            victims = sorted(
                (fp for fp, e in self._entries.items()
                 if not e["pinned"] and fp != keep),
                key=lambda fp: self._entries[fp]["last_used"])
            if not victims:
                break
            fp = victims[0]
            entry = self._entries.pop(fp)
            for mid in entry["ids"]:
                self._aliases.pop(mid, None)
            if self.recorder is not None:
                self.recorder.counter("mech_evicted")
            popped.append(entry)
        return popped

    @staticmethod
    def _teardown(entry):
        """Drain an evicted entry's scheduler, close its session and drop
        its pinned programs."""
        try:
            entry["scheduler"].drain(timeout=30.0)
        except Exception:  # noqa: BLE001 — eviction must not wedge
            pass
        entry["session"].__exit__(None, None, None)
        entry["session"].release()

    def add_session(self, session, mech_id=None, warm=True):
        """Admit a pre-built session; warms it, starts its scheduler,
        returns the fingerprint."""
        with self._lock:
            existing = self._entries.get(session.fingerprint)
            if existing is not None:
                if mech_id is not None:
                    existing["ids"].add(str(mech_id))
                    self._aliases[str(mech_id)] = session.fingerprint
                return session.fingerprint
        if warm:
            session.warmup()
        session.__enter__()
        scheduler = self._factory(session).start()
        return self._admit(session, scheduler, mech_id)

    def add_mechanism(self, mech_path, therm_path, mech_id=None,
                      warm=True):
        """Build and admit a session for a mechanism file pair under the
        base spec's solver/serve template, on the store's device."""
        from ..models.gas import compile_gaschemistry
        from ..models.thermo import create_thermo

        spec = dataclasses.replace(
            self.base_spec, mech=os.path.abspath(str(mech_path)),
            therm=os.path.abspath(str(therm_path)))
        gm = compile_gaschemistry(spec.mech, device=self.device)
        th = create_thermo(list(gm.species), spec.therm, device=self.device)
        session = SolverSession(gm, th, spec, recorder=self.recorder,
                                device=self.device)
        return self.add_session(session, mech_id=mech_id, warm=warm)

    def add_upload(self, upload):
        """One validated upload (``schema.validate_upload``) ->
        ``(fingerprint, info)``.  The inline texts land under the store
        dir; a parse failure raises ``ValueError`` (an ``invalid``
        response)."""
        uid = upload["id"]
        mech_path = os.path.join(self._dir, f"{_safe_name(uid)}.dat")
        therm_path = os.path.join(self._dir, f"{_safe_name(uid)}.therm")
        for path, text in ((mech_path, upload["mech"]),
                           (therm_path, upload["therm"])):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        try:
            fp = self.add_mechanism(mech_path, therm_path, mech_id=uid,
                                    warm=upload.get("warm", True))
        except (KeyError, ValueError, NotImplementedError) as e:
            raise ValueError(f"mechanism upload {uid!r} rejected: "
                             f"{e}") from e
        with self._lock:
            session = self._entries[fp]["session"]
        return fp, {"fingerprint": fp, "id": uid,
                    "species": list(session.species),
                    "mech_shape": session.mech_shape,
                    "warmed": (None if session.warmed is None
                               else len(session.warmed)),
                    "program_compiles": session.program_compiles()}

    # ---- routing -----------------------------------------------------------
    def resolve(self, mech=None):
        """Route a request's ``mech`` key (upload id, full fingerprint, or
        unambiguous fingerprint prefix; None = default) to its
        ``(session, scheduler)`` pair, advancing the LRU clock."""
        with self._lock:
            if mech is None:
                fp = self.default_fingerprint
            else:
                fp = self._aliases.get(str(mech))
                if fp is None:
                    hits = [f for f in self._entries
                            if f.startswith(str(mech))]
                    if len(hits) != 1:
                        raise UnknownMechanism(
                            f"unknown mechanism {mech!r} "
                            f"({len(self._entries)} resident; upload it "
                            f"via POST /mechanism or use a resident id)")
                    fp = hits[0]
            entry = self._entries.get(fp)
            if entry is None:
                raise UnknownMechanism(f"mechanism {mech!r} is no longer "
                                       f"resident (evicted)")
            self._seq += 1
            entry["last_used"] = self._seq
            return entry["session"], entry["scheduler"]

    def mechanisms(self):
        """Healthz-facing census: one row per resident session."""
        with self._lock:
            return [{"fingerprint": fp,
                     "ids": sorted(e["ids"]),
                     "pinned": e["pinned"],
                     "species": len(e["session"].species),
                     "mech_shape": e["session"].mech_shape,
                     "program_compiles": sum(
                         e["session"].program_compiles().values())}
                    for fp, e in self._entries.items()]

    def healthz(self):
        return {"mechanisms": self.mechanisms(),
                "max_mechanisms": self.max_mechanisms}

    # ---- lifecycle ---------------------------------------------------------
    def drain(self, timeout=None):
        """Drain every resident scheduler and close the sessions the store
        admitted (the default session's context stays caller-owned); the
        store's upload dir is removed when the store created it."""
        import shutil

        with self._lock:
            entries = list(self._entries.values())
        ok = True
        for e in entries:
            try:
                ok = e["scheduler"].drain(timeout) and ok
            except Exception:  # noqa: BLE001 — drain-all must finish
                ok = False
            if e["session"].fingerprint != self.default_fingerprint:
                e["session"].__exit__(None, None, None)
                e["session"].release()
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)
        return ok


def _safe_name(name):
    return "".join(c if c.isalnum() or c in "-_." else "-" for c in name)
