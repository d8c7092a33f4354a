"""brlint tier C (a): the step-program contract registry of the port.

The JAX package's contracts (``batchreactor_tpu/analysis/contracts.py``)
check traced jaxprs.  The port traces none: its unit of device work is a
step of a :class:`~..solver.graphs.Program`, run eagerly on the CPU and
captured as a CUDA graph on the card.  So the contracts here check **step
programs**:

* every captured program has a declarative :class:`ProgramContract`,
  registered via :func:`program_contract` in :mod:`.census` (one module
  for the whole census, grouped by the module that owns the programs);
* a contract's ``build(harness)`` records programs through the package's
  own builders (``parallel.sweep._build_segment_program``,
  ``solver.bdf.make_stepper``, the ``ops/rhs.py`` factories) on the h2o2
  fixture at B = 8, and yields **obligations** — the JAX package's three
  invariance classes:

  - :class:`Pure` — the recorded step makes no host read of a device value
    (no ``aten._local_scalar_dense``: ``.item()``, ``bool(t)``, a Python
    branch on a tensor), copies nothing between devices, runs no op whose
    output shape follows the data (``nonzero``, ``masked_select``,
    ``unique``, boolean-mask indexing) and — ``check_dtype``, for RHS
    programs — makes no float tensor narrower than float64; on the card
    the capture must also succeed;
  - :class:`Identical` — two configurations record the same op log on the
    CPU and the same kernel nodes on the card (the no-op-fork class);
  - :class:`Contains` — a kernel is present (``kernel-missing``: on the
    CPU the op log names ``brtorch::lu32p_factor``; on the card the
    captured graph's kernel nodes name the ``lu32p`` kernel and the
    capture tally (``linalg_cuda.captured_by_path``) counted it);

* :func:`run_contracts` is the ONE engine: it imports :mod:`.census`
  (populating the registry), builds a shared fixture :class:`Harness`,
  evaluates every obligation, and appends the **completeness check**:
  every ``graphs.Program(`` construction site and every armed
  single-program compile-watch label in the package must be covered by a
  registered contract.

How a step is recorded (:class:`Recording`): on the CPU each step runs
once under a ``TorchDispatchMode`` that logs every aten op with its
dtypes, shapes and devices.  On ``device="cuda"`` each step is captured
through ``Program``'s own capture path, in debug mode: the graph's DOT
dump gives its nodes by kind and its kernel nodes (function and launch
configuration, in capture order), and the op recorder runs during the
capture too.

Two repo-level registry audits ride the same tier:
:func:`fingerprint_registry_findings` (every schema-changing knob of
``parallel/checkpoint.py``'s ``SCHEMA_KNOBS`` pins the resume fingerprint)
and :func:`counter_registry_findings` (``obs/counters.py``'s ``FAMILIES``
is complete and honest).

Stdlib-only at module scope (tier A must never pay a torch import); torch and the solver stack load lazily
inside :class:`Harness` / :func:`run_contracts`.
"""

import ast
import dataclasses
import os
import re
import tempfile
import time
import traceback
import warnings

from .core import Finding
from .reachability import _Aliases, is_program_ctor

#: ops whose output shape follows the data: a graph cannot capture them
_DATA_SHAPED_OPS = ("aten.nonzero", "aten.masked_select", "aten.unique",
                    "aten._unique", "aten.unique_dim",
                    "aten.unique_consecutive", "aten.argwhere")
_INDEX_OPS = ("aten.index.", "aten.index_put", "aten._index_put_impl")
_COPY_OPS = ("aten.copy_", "aten._to_copy", "aten.to.")
_NARROW_FLOATS = ("torch.float32", "torch.float16", "torch.bfloat16")


# --------------------------------------------------------------------------
# recordings
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Recording:
    """What one program's steps did, as the engine recorded them.

    ``ops`` holds one ``(op, in_dtypes, in_shapes, in_devices, out_dtypes,
    out_shapes, out_devices, bool_index)`` row per aten op dispatched
    (on the card, during the warm-up and the capture);
    ``captured`` says whether the steps were captured as CUDA graphs,
    ``error`` the capture's exception if it failed; ``nodes`` the captured
    graphs' nodes by kind; ``dump_kernels`` their kernel nodes (function
    and launch configuration) in capture order; ``launches`` the
    ``lu32p`` launches the captures counted, by path."""

    tag: str
    device: str
    steps: tuple
    ops: list = dataclasses.field(default_factory=list)
    captured: bool = False
    error: str = None
    nodes: dict = dataclasses.field(default_factory=dict)
    dump_kernels: tuple = ()
    launches: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def signature(self):
        """What :class:`Identical` compares: the op log on the CPU (or an
        uncaptured program); for a captured one, its graphs' kernel nodes
        in capture order (function and launch configuration) and its
        nodes by kind."""
        if self.captured:
            return self.dump_kernels + tuple(sorted(self.nodes.items()))
        return tuple(row[:3] + row[4:6] for row in self.ops)

    def census(self):
        return {"tag": self.tag, "steps": list(self.steps),
                "captured": self.captured, "ops": len(self.ops),
                "kernels": len(self.dump_kernels),
                "nodes": dict(self.nodes),
                "lu32p_launches": dict(self.launches),
                "seconds": self.seconds}


def _op_log():
    """A ``TorchDispatchMode`` that appends one row per aten op to its
    ``rows`` (:class:`Recording` ``ops``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def desc(x):
        ts = [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]
        return (tuple(str(t.dtype) for t in ts),
                tuple(tuple(t.shape) for t in ts),
                tuple(t.device.type for t in ts))

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            bool_index = name.startswith(_INDEX_OPS) and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for t in tree_leaves(args[1:]))
            self.rows.append((name,) + desc((args, kwargs)) + desc(out)
                             + (bool_index,))
            return out

    return OpLog()


_NODE_START = re.compile(r'(?<!-> )"(graph_\d+_node_\d+)"\s*\[')
_NODE_KINDS = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "EMPTY", "GRAPH",
               "EVENT_RECORD", "WAIT_EVENT", "MEM_ALLOC", "MEM_FREE",
               "BATCH_MEM_OP", "CONDITIONAL", "EXT_SEMAS_SIGNAL",
               "EXT_SEMAS_WAIT")
_NODE_KIND = re.compile(r"\b(" + "|".join(_NODE_KINDS) + r")\b")
# a kernel node's function and launch configuration:
# ``| {ID | 2 (topoId: 2175) | _ZN2at6native...\<\<\<1,128,0\>\>\>}``
_KERNEL_FIELD = re.compile(
    r"\{\s*ID\s*\|[^|]*\|\s*(\S+?)\\?<\\?<\\?<(.*?)\\?>\\?>\\?>")


def _parse_dump(text):
    """(nodes by kind, kernel nodes' text) of a captured graph's DOT dump
    (``cudaGraphDebugDotPrint``): a node runs from its ``"graph_G_node_N"
    [`` to the next; its kind is the first node-type word of its label
    (``KERNEL``, ``MEMCPY``, ``MEMSET``, ...), or ``KERNEL`` for a label
    that carries a launch configuration (``<<<grid,block,smem>>>``).  A
    kernel node's text (its name among the fields, addresses dropped)
    is kept whole, whitespace collapsed."""
    kinds, names = {}, []
    starts = [m.start() for m in _NODE_START.finditer(text)] + [len(text)]
    for lo, hi in zip(starts, starts[1:]):
        node = text[lo:hi]
        m = _NODE_KIND.search(node)
        kind = m.group(1) if m else ("KERNEL" if "<<<" in node.replace(
            "\\", "") else "OTHER")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "KERNEL":
            m = _KERNEL_FIELD.search(node)
            names.append(
                f"{m.group(1)}<<<{m.group(2).replace(chr(92), '')}>>>" if m
                else " ".join(re.sub(r'0x[0-9a-fA-F]+|topoId: \d+|^"\w+"',
                                     "", node).split())[:400])
    return kinds, tuple(names)


# --------------------------------------------------------------------------
# obligations
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Pure:
    """The recorded program makes no host read, no cross-device copy and
    no data-shaped op, captures on the card, and (``check_dtype``, RHS
    programs only: solver programs narrow to float32 by design in the
    ``inv32*``/``lu32p`` modes) makes no float tensor narrower than
    float64."""

    tag: str
    recording: Recording
    check_dtype: bool = False


@dataclasses.dataclass
class Identical:
    """Two recordings must agree (:meth:`Recording.signature`; plain
    values compare as they are) — the no-op-fork / bucket-fork invariance
    class.  ``rule`` is the finding name (``economy-noop-fork``, ...)."""

    rule: str
    tag: str
    a: object
    b: object
    message: str


@dataclasses.dataclass
class Contains:
    """The recorded program must contain the kernel named by ``fragment``
    — the kernel-presence class (a silent fallback must fail loudly)."""

    rule: str
    tag: str
    recording: Recording
    fragment: str
    message: str


def _pure_findings(ob):
    rec, path, out = ob.recording, f"<step:{ob.tag}>", []

    def add(rule, msg):
        out.append(Finding(rule, path, 0, 0, msg))

    if rec.error is not None:
        add("step-capture-failed",
            f"the step program did not capture as a CUDA graph on "
            f"{rec.device}: {rec.error}")
    seen = set()
    for op, in_dt, _in_sh, in_dev, out_dt, _out_sh, out_dev, bool_ix in \
            rec.ops:
        hit = None
        if op.startswith("aten._local_scalar_dense"):
            hit = ("step-host-sync",
                   f"{op}: the step reads a device value on the host "
                   f"(.item(), bool()/float() of a tensor, a Python branch "
                   f"on one); a CUDA graph cannot capture it")
        elif ("cpu" in out_dev and "cuda" in in_dev) or (
                op.startswith(_COPY_OPS)
                and {"cpu", "cuda"} <= set(in_dev + out_dev)):
            hit = ("step-host-copy",
                   f"{op} copies between the host and the card inside the "
                   f"step (a copy to the host is a sync; a host copy in is "
                   f"baked into the graph)")
        elif op.startswith(_DATA_SHAPED_OPS) or bool_ix:
            hit = ("step-dynamic-shape",
                   f"{op}{' with a boolean index' if bool_ix else ''} "
                   f"sizes its output by the data: a host sync, and no "
                   f"fixed shape to capture")
        elif ob.check_dtype and any(d in _NARROW_FLOATS for d in out_dt):
            hit = ("step-dtype-leak",
                   f"{op} makes a {sorted(set(out_dt) & set(_NARROW_FLOATS))}"
                   f" tensor (from {list(in_dt)}) in an RHS program that "
                   f"should be float64 throughout, as the reference's")
        if hit is not None and hit not in seen:
            seen.add(hit)
            add(*hit)
    return out


def _check_obligation(ob):
    if isinstance(ob, Pure):
        return _pure_findings(ob)
    if isinstance(ob, Identical):
        sa, sb = (x.signature() if isinstance(x, Recording) else x
                  for x in (ob.a, ob.b))
        if sa != sb:
            k = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y),
                     min(len(sa), len(sb)))
            at = (f"; first difference at entry {k} of {len(sa)} vs "
                  f"{len(sb)}: {sa[k] if k < len(sa) else None!r} vs "
                  f"{sb[k] if k < len(sb) else None!r}")
            return [Finding(ob.rule, f"<step:{ob.tag}>", 0, 0,
                            ob.message + at)]
        return []
    if isinstance(ob, Contains):
        rec = ob.recording
        missing = []
        if not any(ob.fragment in row[0] for row in rec.ops):
            missing.append("the op log")
        if rec.captured:
            if not any(ob.fragment in k for k in rec.dump_kernels):
                missing.append("the captured graph's kernel nodes")
            if sum(rec.launches.values()) <= 0:
                missing.append("the capture tally (captured_by_path)")
        if missing:
            return [Finding(ob.rule, f"<step:{ob.tag}>", 0, 0,
                            ob.message + f" (absent from "
                            f"{', '.join(missing)})")]
        return []
    raise TypeError(f"unknown contract obligation {type(ob).__name__}")


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ProgramContract:
    name: str          # registry key (kebab-case, the program's name)
    build: object      # build(harness) -> iterable of obligations
    labels: tuple      # armed compile-watch labels this covers
    sites: tuple       # graphs.Program construction sites this covers
    doc: str
    module: str        # the module that registered it, for reports


_REGISTRY = {}


def program_contract(name, *, labels=(), sites=(), doc=""):
    """Decorator registering a captured program's contract (the census
    lives in :mod:`.census`):

    >>> @program_contract("bdf-step", doc="BDF step program: pure")
    ... def _contract_bdf_step(h):
    ...     yield Pure("bdf-step", h.segment("bdf-step"))

    ``labels`` lists the armed single-program compile-watch labels the
    program runs under, ``sites`` its ``graphs.Program(`` construction
    sites as ``"<path in the package>::<enclosing function>"`` (the
    completeness check matches both); the builder receives the shared
    :class:`Harness` and yields obligations.  Re-registration under the
    same name replaces (module reload in tests)."""

    def deco(fn):
        _REGISTRY[name] = ProgramContract(
            name=name, build=fn, labels=tuple(labels), sites=tuple(sites),
            doc=doc or (fn.__doc__ or "").strip().split("\n")[0],
            module=fn.__module__)
        return fn

    return deco


def all_contracts():
    """The registry as ``{name: ProgramContract}`` (after
    :func:`load_census` — :func:`run_contracts` calls it)."""
    return dict(_REGISTRY)


def load_census():
    """Import :mod:`.census`, which registers every contract in its
    file's order (so which contract first memoizes the harness's shared
    baselines is deterministic); it loads torch and the solver stack."""
    from . import census  # noqa: F401


# --------------------------------------------------------------------------
# the shared fixture harness
# --------------------------------------------------------------------------
def _fixture_dir(fixtures_dir=None):
    if fixtures_dir:
        return fixtures_dir
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "tests", "fixtures")


class Harness:
    """Everything a contract builder needs, built once per engine run on
    the tiny vendored fixtures (tests/fixtures: h2o2.dat + therm.dat +
    h2oni.xml) at :attr:`B` = 8 lanes on :attr:`device`:

    * ``modes`` — the four chemistry modes as ``(tag, rhs, jac, y0, cfg)``
      (``y0`` (B, n), ``cfg`` per-lane (B,)); ``rhs``/``jac``/``y0``/
      ``cfg`` alias the gas mode;
    * :meth:`record_fn` — one callable as a one-step program;
      :meth:`segment` — a segment program (``begin``/``window``/``end``,
      and ``compact``) built by ``parallel.sweep._build_segment_program``;
      :meth:`record` — the steps of any program;
    * :meth:`memo` — cross-contract memoization (the no-op-fork contracts
      share one baseline recording, taken before any machinery ran).
    """

    B = 8

    def __init__(self, fixtures_dir=None, device="cpu"):
        import torch

        self.torch = torch
        self.fixtures = _fixture_dir(fixtures_dir)
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("the contract tier on --device cuda needs "
                                   "a CUDA device; none is available")
            dev = torch.device("cuda", torch.cuda.current_device())
            from ..solver import linalg_cuda

            linalg_cuda.load_library()   # no nvcc: raises here
        elif dev.type != "cpu":
            raise ValueError(f"the contract tier runs on cpu or cuda, not "
                             f"{device!r}")
        self.device = dev
        self.on_cuda = dev.type == "cuda"
        self.check_dtype = True
        self._memo = {}
        self.recordings = []
        self.modes, self.gm, self.th, self.sm = self._build_modes()
        _tag, self.rhs, self.jac, self.y0, self.cfg = self.modes[0]
        #: the step time handed to the RHS closures, per lane
        self.t = torch.zeros(self.B, dtype=torch.float64, device=dev)

    def _build_modes(self):
        torch = self.torch
        from ..models.gas import compile_gaschemistry
        from ..models.surface import compile_mech
        from ..models.thermo import create_thermo
        from ..ops.rhs import (make_gas_jac, make_gas_rhs, make_surface_jac,
                               make_surface_rhs, make_udf_rhs)
        from ..utils.composition import density, mole_to_mass

        dev, B = self.device, self.B
        gm = compile_gaschemistry(os.path.join(self.fixtures, "h2o2.dat"),
                                  device=dev)
        th = create_thermo(list(gm.species),
                           os.path.join(self.fixtures, "therm.dat"),
                           device=dev)
        sm = compile_mech(os.path.join(self.fixtures, "h2oni.xml"), th,
                          list(gm.species), device=dev)
        T, p = 1100.0, 1e5
        sp = list(gm.species)
        x = torch.zeros(len(sp), dtype=torch.float64, device=dev)
        x[sp.index("H2")], x[sp.index("O2")], x[sp.index("N2")] = \
            0.3, 0.2, 0.5
        y_gas = density(x, th.molwt, T, p) * mole_to_mass(x, th.molwt)
        y_cov = torch.as_tensor(sm.ini_covg, dtype=torch.float64,
                                device=dev)
        y_gas = y_gas.expand(B, -1).clone()
        y_coupled = torch.cat([y_gas, y_cov.expand(B, -1)], dim=1)
        cfg = {"T": torch.full((B,), T, dtype=torch.float64, device=dev),
               "Asv": torch.ones(B, dtype=torch.float64, device=dev)}

        def udf(t, state):
            # first-order decay toward equal mole fractions: exercises the
            # full UDF state plumbing
            return (1.0 / len(state["molwt"]) - state["mole_frac"]) * 1e-3

        modes = [
            ("gas-rhs", make_gas_rhs(gm, th), make_gas_jac(gm, th), y_gas,
             cfg),
            ("surf-rhs", make_surface_rhs(sm, th), make_surface_jac(sm, th),
             y_coupled, cfg),
            ("coupled-rhs", make_surface_rhs(sm, th, gm=gm),
             make_surface_jac(sm, th, gm=gm), y_coupled, cfg),
            ("udf-rhs", make_udf_rhs(udf, th.molwt, species=th.species),
             None, y_gas, cfg),
        ]
        return modes, gm, th, sm

    # ---- recording --------------------------------------------------------
    def memo(self, key, thunk):
        """Memoize an expensive artifact (a baseline recording) across
        contracts — the first builder to ask computes it."""
        if key not in self._memo:
            self._memo[key] = thunk()
        return self._memo[key]

    def record(self, tag, prog, steps, capture=True):
        """Run ``steps`` of ``prog`` (a ``graphs.Program`` on the harness's
        device, its state loaded) once each, in order, and return their
        :class:`Recording`.  Each step's function is called once first,
        unrecorded, as ``Program``'s capture path warms a step up before
        it captures it.  On the card, ``capture`` captures each step (in
        debug mode, its graph kept for the DOT dump); ``capture=False``
        runs the steps' functions eagerly, as the port runs such a
        program."""
        from ..solver import graphs

        torch = self.torch
        rec = Recording(tag, self.device.type, tuple(steps))
        t0 = time.perf_counter()
        log = _op_log()
        cuda = self.on_cuda and capture
        try:
            for name in steps:
                # the warm-up the capture path runs first (its output
                # discarded): lazy initialisation, the kinetics' cached
                # index tensors, a kernel library's load happen there,
                # outside the capture and outside the record
                prog.steps[name](prog.state)
                with log, graphs.debug_capture():
                    if prog.on_cuda and not capture:
                        prog.state.update(prog.steps[name](prog.state))
                    else:
                        prog.run(name)
            if cuda:
                torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001 — a capture that fails is
            #                     the finding Pure reports
            if not cuda:
                raise
            rec.error = f"{type(e).__name__}: {e}"
        rec.ops = log.rows
        if cuda and rec.error is None:
            rec.captured = True
            self._read_graphs(rec, prog, steps)
        rec.seconds = time.perf_counter() - t0
        self.recordings.append(rec)
        return rec

    def _read_graphs(self, rec, prog, steps):
        """Fill a captured recording: each graph's DOT dump (nodes by
        kind, kernel nodes in capture order) and the launches counted at
        capture."""
        dump_names = []
        with tempfile.TemporaryDirectory(prefix="brlint_graph_") as tmp:
            for name in steps:
                graph, _tally, launches = prog.captured(name)
                for k, v in launches.items():
                    rec.launches[k] = rec.launches.get(k, 0) + v
                path = os.path.join(tmp, f"{name}.dot")
                with warnings.catch_warnings():
                    # debug_dump announces itself with a UserWarning
                    warnings.simplefilter("ignore", UserWarning)
                    graph.debug_dump(path)
                with open(path) as f:
                    text = f.read()
                dump_head = text[:1500]
                kinds, names = _parse_dump(text)
                for k, v in kinds.items():
                    rec.nodes[k] = rec.nodes.get(k, 0) + v
                dump_names.extend(names)
            if not rec.nodes.get("KERNEL"):
                raise RuntimeError(
                    f"{rec.tag}: the captured graphs' DOT dumps name no "
                    f"kernel node (nodes {rec.nodes}); the dump format is "
                    f"not the one this parser reads: {dump_head!r}")
            rec.dump_kernels = tuple(dump_names)

    def record_steps(self, tag, steps, state, capture=True):
        """Record the ``steps`` (``{name: fn(state) -> updates}``, run in
        order) of a program over ``state``."""
        from ..solver import graphs

        # the harness builds one throwaway program per recording on
        # purpose: each is captured once, read, and dropped
        prog = graphs.Program(self.device, steps)  # brlint: disable=recapture-hazard
        prog.set(**state)
        return self.record(tag, prog, tuple(steps), capture=capture)

    def record_fn(self, tag, fn, *args, capture=True):
        """Record ``fn(*args)`` as a one-step program: the shape every
        RHS/Jacobian closure takes inside a captured step."""
        return self.record_steps(
            tag, {"step": lambda s: {"out": fn(*s["args"])}},
            {"args": tuple(args)}, capture=capture)

    def gas_rhs_baseline(self):
        """The gas RHS's recording, shared by every no-op fork of it."""
        return self.memo("gas-rhs", lambda: self.record_fn(
            "gas-rhs", self.rhs, self.t, self.y0, self.cfg))

    def gas_jac_baseline(self):
        """The gas Jacobian's recording, shared likewise."""
        return self.memo("gas-jac", lambda: self.record_fn(
            "gas-jac", self.jac, self.t, self.y0, self.cfg))

    def segment_program(self, *, method="bdf", linsolve="lu", jac_window=1,
                        setup_economy=False, stats=False, timeline=None,
                        seg_save=0, n_save=0, rhs=None, jac=None, y0=None,
                        cfg=None, t1=1e-7, segment_steps=4):
        """A loaded segment program over the gas fixture (or the given
        ``rhs``/``jac``/``y0``/``cfg``), built exactly as the pipelined
        driver builds it (``parallel.sweep._build_segment_program``,
        ``_init_segment_carry``, ``_segment_inputs``), never cached."""
        from ..parallel import sweep

        rhs = self.rhs if rhs is None else rhs
        jac = self.jac if jac is None and rhs is self.rhs else jac
        y0 = self.y0 if y0 is None else y0
        cfg = self.cfg if cfg is None else cfg
        B, n = y0.shape
        economy = sweep._economy(method, setup_economy, jac_window)
        prog = sweep._build_segment_program(
            rhs, jac, None, None, B, n, y0.dtype, self.device,
            method=method, rtol=1e-6, atol=1e-10,
            segment_steps=segment_steps, dt_min_factor=1e-22,
            linsolve=linsolve, jac_window=jac_window, newton_tol=0.03,
            setup_economy=setup_economy, stale_tol=0.3, seg_save=seg_save,
            n_save=n_save, has_budget=False, stats=stats, timeline=timeline)
        seg = sweep._init_segment_carry(y0, 0.0, method, None, n_save,
                                        economy, linsolve, stats, timeline)
        sweep._segment_inputs(prog, seg, cfg, t1, None, None)
        return prog

    def segment(self, tag, **kw):
        """Record a segment program's ``begin``, ``window`` and ``end``
        (:meth:`segment_program`'s options)."""
        return self.record(tag, self.segment_program(**kw),
                           ("begin", "window", "end"))

    def segment_baseline(self):
        """The plain segment program every no-op-fork contract compares
        against — memoized, so the FIRST requester (before any machinery
        ran) pins the baseline all later contracts share."""
        return self.memo("segment-plain",
                         lambda: self.segment("segment-plain"))

    def segment_stats(self):
        """The stats-instrumented segment program, memoized likewise."""
        return self.memo("segment-stats", lambda: self.segment(
            "segment-stats", stats=True))

    def sens_fixture(self):
        """(spec, theta, rhs_theta) over two reactions of the gas fixture
        (memoized)."""

        def build():
            from ..ops.rhs import make_gas_rhs
            from ..sensitivity import params as sp

            spec = sp.select(self.gm, reactions=(0, 1))
            theta = sp.extract(self.gm, spec)
            rhs_theta = sp.make_rhs_theta(
                self.gm, spec, lambda m: make_gas_rhs(m, self.th))
            return spec, theta, rhs_theta

        return self.memo("sens-fixture", build)


# --------------------------------------------------------------------------
# completeness: every Program site and armed label has a contract
# --------------------------------------------------------------------------
def _package_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package_sources(root):
    """(path relative to ``root``, parsed tree) of every module of the
    package, the analysis package itself excluded: its harness builds
    throwaway programs to check the others."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if rel.startswith("analysis/"):
                continue
            try:
                with open(path, encoding="utf-8") as fh:
                    yield rel, ast.parse(fh.read(), filename=path)
            except (OSError, SyntaxError):
                continue


def _armed(call):
    """Is a ``.region(...)`` call armed (``single_program=True``)?"""
    return any(kw.arg == "single_program"
               and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords) or (
        len(call.args) > 1 and isinstance(call.args[1], ast.Constant)
        and call.args[1].value is True)


def armed_region_labels(root=None):
    """``{label: [path:line, ...]}`` of every armed single-program
    compile-watch label in the package: a literal-label
    ``*.region("<label>", ..., single_program=True)`` call, or a literal
    passed to a module-local helper that forwards its parameter as such a
    label (``sweep._region(watch, "sweep-segment", B)``)."""
    root = root or _package_root()
    out = {}
    for rel, tree in _package_sources(root):
        forwarders = {}
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "region" and node.args
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in params and _armed(node)):
                    forwarders[fn.name] = params.index(node.args[0].id)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            label = None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "region" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and _armed(node)):
                label = node.args[0].value
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in forwarders):
                i = forwarders[node.func.id]
                if (i < len(node.args)
                        and isinstance(node.args[i], ast.Constant)):
                    label = node.args[i].value
            if isinstance(label, str):
                out.setdefault(label, []).append(f"{rel}:{node.lineno}")
    return out


def program_sites(root=None):
    """``{"<path>::<function>": [path:line, ...]}`` of every
    ``graphs.Program(`` construction in the package (analysis/ excluded:
    :func:`_package_sources`)."""
    root = root or _package_root()
    out = {}
    for rel, tree in _package_sources(root):
        aliases = _Aliases(tree)

        def visit(node, scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = f"{scope}.{node.name}" if scope else node.name
            if isinstance(node, ast.Call):
                resolved = aliases.resolve(node.func) or ""
                if is_program_ctor(resolved) or (
                        rel.endswith("solver/graphs.py")
                        and resolved == "Program"):
                    out.setdefault(f"{rel}::{scope or '<module>'}",
                                   []).append(f"{rel}:{node.lineno}")
            for child in ast.iter_child_nodes(node):
                visit(child, scope)

        visit(tree, "")
    return out


def completeness_findings(root=None):
    """Every armed label and every ``graphs.Program(`` site in the source
    must be covered by a registered contract, and every label and site a
    contract declares must still exist (stale contracts shrink the
    registry as stale baselines shrink the debt file)."""
    findings = []
    armed = armed_region_labels(root)
    sites = program_sites(root)
    covered_l = {lbl for c in _REGISTRY.values() for lbl in c.labels}
    covered_s = {s for c in _REGISTRY.values() for s in c.sites}
    for label, where in sorted(armed.items()):
        if label not in covered_l:
            findings.append(Finding(
                "contract-missing", f"<contracts:{label}>", 0, 0,
                f"captured program label {label!r} (armed single_program "
                f"region at {', '.join(where)}) has no registered program "
                f"contract; add @program_contract(..., labels=({label!r},)) "
                f"in analysis/census.py"))
    for site, where in sorted(sites.items()):
        if site not in covered_s:
            findings.append(Finding(
                "contract-missing", f"<contracts:{site}>", 0, 0,
                f"graphs.Program construction site {site} "
                f"({', '.join(where)}) has no registered program contract; "
                f"add @program_contract(..., sites=({site!r},)) in "
                f"analysis/census.py"))
    for name, c in sorted(_REGISTRY.items()):
        for label in c.labels:
            if label not in armed:
                findings.append(Finding(
                    "contract-stale", f"<contracts:{name}>", 0, 0,
                    f"contract {name!r} ({c.module}) declares label "
                    f"{label!r} but no armed single_program region with "
                    f"that label exists in the source"))
        for site in c.sites:
            if site not in sites:
                findings.append(Finding(
                    "contract-stale", f"<contracts:{name}>", 0, 0,
                    f"contract {name!r} ({c.module}) declares the "
                    f"graphs.Program site {site} but no such construction "
                    f"exists in the source"))
    return findings


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def run_contracts(fixtures_dir=None, select=None, registry_audits=True,
                  device="cpu", census=None):
    """Tier C (a): load the census (populating the registry),
    build the shared harness on ``device``, evaluate every contract's
    obligations, and append the completeness check plus —
    ``registry_audits`` — the fingerprint-completeness and
    counter-registry audits.  ``census`` (a list) receives one entry per
    contract run: its programs, obligations, findings and wall.  Returns a
    list of :class:`~.core.Finding` (empty = every contract holds).
    Raises where the tier cannot run (``device="cuda"`` without a card or
    ``nvcc``)."""
    load_census()
    findings = []
    harness = Harness(fixtures_dir, device=device)
    for name, contract in _REGISTRY.items():
        if select is not None and name not in select:
            continue
        n_obligations, n_found = 0, len(findings)
        first = len(harness.recordings)
        t0 = time.perf_counter()
        try:
            for ob in contract.build(harness):
                n_obligations += 1
                findings.extend(_check_obligation(ob))
        except Exception as e:  # noqa: BLE001 — one broken contract
            #                     must not silence the rest of the run
            tb = traceback.format_exc(limit=3)
            findings.append(Finding(
                "contract-error", f"<contracts:{name}>", 0, 0,
                f"contract {name!r} ({contract.module}) raised "
                f"{type(e).__name__}: {e}\n{tb}"))
        else:
            if n_obligations == 0:
                findings.append(Finding(
                    "contract-empty", f"<contracts:{name}>", 0, 0,
                    f"contract {name!r} ({contract.module}) yielded no "
                    f"obligations: it verifies nothing"))
        if census is not None:
            census.append({
                "name": name, "module": contract.module,
                "device": harness.device.type,
                "obligations": n_obligations,
                "findings": len(findings) - n_found,
                "seconds": time.perf_counter() - t0,
                "programs": [r.census() for r in
                             harness.recordings[first:]]})
    if select is None:
        findings.extend(completeness_findings())
        if registry_audits:
            findings.extend(fingerprint_registry_findings())
            findings.extend(counter_registry_findings())
    return findings


# --------------------------------------------------------------------------
# repo-level registry audits (tier C satellites)
# --------------------------------------------------------------------------
#: on-values used to toggle each schema knob when behaviorally checking
#: that it moves the resume fingerprint
_SCHEMA_KNOB_VALUES = {"stats": True, "timeline": 8,
                       "energy": "adiabatic_v"}


def fingerprint_registry_findings():
    """Fingerprint-completeness audit: every knob that changes a chunk's
    npz/stats schema (``parallel/checkpoint.py`` ``SCHEMA_KNOBS``) must
    not be exempted from the resume fingerprint, and toggling it must move
    the hash; every exempt gear knob must leave the hash alone."""
    import torch

    from ..parallel import checkpoint as ck

    findings = []
    schema = tuple(getattr(ck, "SCHEMA_KNOBS", ()))
    exempt = tuple(getattr(ck, "_FP_EXEMPT_KEYS", ()))
    if not schema:
        findings.append(Finding(
            "fingerprint-registry", "<audit:fingerprint>", 0, 0,
            "parallel/checkpoint.py declares no SCHEMA_KNOBS registry: "
            "the fingerprint-completeness audit has nothing to pin"))
        return findings
    leaked = sorted(set(schema) & set(exempt))
    if leaked:
        findings.append(Finding(
            "fingerprint-registry", "<audit:fingerprint>", 0, 0,
            f"schema-changing knob(s) {leaked} are exempted from the "
            f"resume fingerprint (_FP_EXEMPT_KEYS): a resume under a "
            f"different value would silently serve chunks with a "
            f"different npz/stats schema"))

    def rhs(t, y, cfg):
        return -y

    y0s = torch.ones((2, 2), dtype=torch.float64)
    cfgs = {"k": torch.ones((2,), dtype=torch.float64)}
    base = ck._sweep_fingerprint(rhs, y0s, cfgs, {})
    for knob in schema:
        if knob in leaked:
            continue   # already reported structurally
        on = {knob: _SCHEMA_KNOB_VALUES.get(knob, True)}
        if ck._sweep_fingerprint(rhs, y0s, cfgs, on) == base:
            findings.append(Finding(
                "fingerprint-registry", "<audit:fingerprint>", 0, 0,
                f"schema knob {knob!r} does not change the resume "
                f"fingerprint when toggled: the hash recipe skips it "
                f"(register it or fix _sweep_fingerprint)"))
    gear_values = {"pipeline": False, "poll_every": 2,
                   "fetch_deadline": 30.0, "admission": 2, "refill": 1}
    for knob in exempt:
        on = {knob: gear_values.get(knob, 1)}
        if ck._sweep_fingerprint(rhs, y0s, cfgs, on) != base:
            findings.append(Finding(
                "fingerprint-registry", "<audit:fingerprint>", 0, 0,
                f"gear knob {knob!r} is listed fingerprint-exempt but "
                f"still changes the hash: the exemption list and the "
                f"recipe disagree"))
    return findings


def counter_registry_findings():
    """Counter-registry audit: the ``obs/counters.py`` family registry
    must be complete and honest (the JAX package's audit, against the
    port's registry and its ``obs.report.diff``)."""
    import numpy as np

    from ..obs import counters as C
    from ..obs import report as R

    findings = []
    fams = getattr(C, "FAMILIES", None)
    if not isinstance(fams, dict) or not fams:
        findings.append(Finding(
            "counter-registry", "<audit:counters>", 0, 0,
            "obs/counters.py declares no FAMILIES registry: key-family "
            "semantics are undeclared"))
        return findings

    # 1. reflection: every *_KEYS tuple in the module is a registered
    #    family (GAUGE_KEYS is a semantic marker, not a family)
    marker_attrs = {"GAUGE_KEYS"}
    declared = {}
    for fam, meta in fams.items():
        for k in meta.get("keys", ()):
            declared.setdefault(k, []).append(fam)
    for attr in sorted(dir(C)):
        if not attr.endswith("_KEYS") or attr in marker_attrs:
            continue
        keys = getattr(C, attr)
        if not isinstance(keys, tuple):
            continue
        if not any(tuple(meta.get("keys", ())) == keys
                   for meta in fams.values()):
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"key family obs.counters.{attr} is not registered in "
                f"FAMILIES: its additive-vs-gauge and missing->0 "
                f"semantics are undeclared, so obs.diff / prometheus "
                f"consumers cannot treat it correctly"))

    # 2. no key in two families; semantics values sane
    for k, where in sorted(declared.items()):
        if len(where) > 1:
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"counter key {k!r} is declared by multiple families "
                f"{sorted(where)}: reductions would double-apply"))
    for fam, meta in sorted(fams.items()):
        if meta.get("semantics") not in ("additive", "gauge", "sample",
                                         "histogram"):
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"family {fam!r} declares unknown semantics "
                f"{meta.get('semantics')!r} "
                f"(additive|gauge|sample|histogram)"))
        if meta.get("kind") == "host" and not meta.get("missing_zero"):
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"host counter family {fam!r} does not declare "
                f"missing_zero: a report that never ran the surface "
                f"would diff as 'None -> n' instead of '0 -> n'"))

    # 3. GAUGE_KEYS == the union of declared per-family gauges
    declared_gauges = {k for meta in fams.values()
                       for k in meta.get("gauges", ())}
    if declared_gauges != set(C.GAUGE_KEYS):
        findings.append(Finding(
            "counter-registry", "<audit:counters>", 0, 0,
            f"GAUGE_KEYS {sorted(C.GAUGE_KEYS)} and the FAMILIES gauge "
            f"declarations {sorted(declared_gauges)} disagree: max-vs-"
            f"sum reduction would differ by code path"))

    # 4. every missing_zero key diffs as 0 -> n through the REAL renderer
    for k in sorted(C.missing_zero_keys()):
        out = R.diff({"counters": {}}, {"counters": {k: 1}})
        if f"counter {k}: 0 -> 1" not in out:
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"missing_zero key {k!r} does not follow the obs.diff "
                f"missing->0 convention (got: "
                f"{[ln for ln in out.splitlines() if k in ln]!r})"))

    # 5. sample families never enter counter totals
    for fam, meta in sorted(fams.items()):
        if meta.get("semantics") != "sample":
            continue
        probe = {k: np.zeros((1, 2)) for k in meta.get("keys", ())}
        tot = C.totals(probe)
        bad = sorted(set(tot or {}) & set(meta.get("keys", ())))
        if bad:
            findings.append(Finding(
                "counter-registry", "<audit:counters>", 0, 0,
                f"sample key(s) {bad} of family {fam!r} leak into "
                f"counters.totals(): summing ring slots reports a "
                f"number with no meaning"))

    # 6. histogram families follow the missing->EMPTY diff convention
    for fam, meta in sorted(fams.items()):
        if meta.get("semantics") != "histogram":
            continue
        for k in meta.get("keys", ()):
            ser = C.hist_observe(C.hist_new(), 0.01)
            out = R.diff(
                {"counters": {}},
                {"counters": {},
                 "histograms": {k: [{"labels": {"stage": "probe"},
                                     **ser}]}})
            if f'hist {k}{{stage="probe"}}: n 0 -> 1' not in out:
                findings.append(Finding(
                    "counter-registry", "<audit:counters>", 0, 0,
                    f"histogram key {k!r} does not follow the obs.diff "
                    f"missing->empty convention (got: "
                    f"{[ln for ln in out.splitlines() if k in ln]!r})"))
    return findings
