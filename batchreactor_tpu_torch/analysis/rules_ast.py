"""brlint tier-A rules of the port: the hazards of a captured step.

Each rule documents (a) the failure it prevents and (b) the
device-reachability scope it runs at (:mod:`.reachability`).  The rules
act only on *locally provable* tensor values: the parameters of strict
functions and ``torch.*``-derived locals anywhere device-reachable.

Carried over from the JAX package's ``analysis/rules_ast.py`` with their
names (users suppress by name): ``host-sync-call`` (which takes in the
JAX package's ``traced-control-flow``: a Python branch on a tensor is an
implicit sync in a captured step), ``env-read-in-trace``,
``env-var-unregistered`` and ``implicit-dtype``.  ``recompile-hazard``
becomes ``recapture-hazard``.  ``bucket-shape-branch`` is not ported: a
graph is captured per shape key anyway (ROADMAP "Not ported, with
reason").  ``tests/test_torch_analysis.py`` seeds one violation per rule.
"""

import ast
import os as _os

from .core import Finding, register
from .reachability import (STRICT, _is_factory_name, is_program_cache,
                           is_program_ctor)

# attribute reads and methods whose results are host values even on a
# tensor: shape math must never count as a device value
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "size", "dim", "numel", "stride",
                 "element_size", "data_ptr", "is_contiguous",
                 "untyped_storage", "get_device", "is_floating_point",
                 "is_complex", "names", "type"}
# builtins and torch calls whose results are host values
_STATIC_CALLS = {"len", "isinstance", "callable", "hasattr", "type",
                 "getattr", "id", "repr", "str.format", "torch.is_tensor",
                 "torch.device", "torch.finfo", "torch.iinfo", "torch.Size",
                 "torch.get_default_dtype", "torch.is_grad_enabled",
                 "torch.promote_types", "torch.result_type",
                 "torch.is_floating_point", "torch.is_complex",
                 "torch.Generator", "torch.no_grad", "torch.enable_grad"}
# packages whose modules are device code wholesale: every function there
# feeds a captured step (ops kernels, solver loops, mechanism bundles)
_DEVICE_PKGS = ("ops", "solver", "models")

_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# methods and functions whose output shape follows the data
_DATA_SHAPED_METHODS = {"nonzero", "masked_select", "unique", "argwhere",
                        "unique_consecutive"}
_DATA_SHAPED_CALLS = {f"torch.{m}" for m in _DATA_SHAPED_METHODS}
_HOST_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
# the graph layer's blocking host reads (solver/graphs.py)
_GRAPH_SYNCS = {"host_any", "fetch", "block", "wait_event"}
_BOOL_CALLS = {"torch.isnan", "torch.isfinite", "torch.isinf",
               "torch.logical_and", "torch.logical_or", "torch.logical_not",
               "torch.eq", "torch.ne", "torch.lt", "torch.le", "torch.gt",
               "torch.ge"}
# torch factories that make a float tensor of the default dtype (float32)
# when no dtype= is given
_FLOAT_FACTORIES = {"zeros", "ones", "empty", "rand", "randn", "eye",
                    "linspace", "logspace", "scalar_tensor"}
_LITERAL_CTORS = {"tensor", "as_tensor"}


def _in_device_pkg(path):
    parts = _os.path.normpath(path).split(_os.sep)
    return any(p in _DEVICE_PKGS for p in parts[:-1])


def _own_nodes(ctx, info):
    """Walk a function's body without descending into nested defs,
    lambdas or captured ``with`` bodies (those carry their own
    FunctionInfo and their own pass)."""
    body = info.node.body
    stack = list(body) if isinstance(body, list) else [body]
    while stack:
        n = stack.pop()
        if n in ctx.index.by_node:
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _resolve(ctx, node):
    return ctx.index.aliases.resolve(node)


def _graph_sync(ctx, node):
    """The name of a graph-layer blocking read this call makes, or None
    (``graphs.fetch(...)``, or a bare ``host_any(...)`` imported from
    it)."""
    resolved = _resolve(ctx, node.func) or ""
    head, _, last = resolved.rpartition(".")
    if last in _GRAPH_SYNCS and (head.endswith("graphs") or (
            isinstance(node.func, ast.Name)
            and ctx.index.aliases.map.get(last, "").endswith(
                "graphs." + last))):
        return last
    return None


def _expr_tainted(ctx, node, tainted):
    """Does this expression *provably* carry a device value?  Static
    projections (shape/ndim/len/isinstance/...) cut the recursion."""
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return _expr_tainted(ctx, node.value, tainted)
    if isinstance(node, ast.Call):
        resolved = _resolve(ctx, node.func) or ""
        if resolved in _STATIC_CALLS or _graph_sync(ctx, node):
            return False
        if resolved.startswith("torch.cuda."):
            return False
        if resolved.startswith("torch."):
            return True
        # method calls on device values stay device values (y.sum(),
        # x.to(...)); the func recursion hits the _STATIC_ATTRS cutoff
        return any(_expr_tainted(ctx, c, tainted)
                   for c in [node.func] + list(node.args)
                   + [k.value for k in node.keywords])
    if isinstance(node, ast.Name):
        return node.id in tainted
    return any(_expr_tainted(ctx, c, tainted)
               for c in ast.iter_child_nodes(node))


def _tainted_names(ctx, info):
    """Tensor params plus locals assigned from device expressions; two
    sweeps approximate a fixpoint over straight-line reassignment."""
    tainted = set(info.traced_params)
    nodes = list(_own_nodes(ctx, info))
    for _ in range(2):
        for n in nodes:
            value, targets = None, []
            if isinstance(n, ast.Assign):
                value, targets = n.value, n.targets
            elif isinstance(n, ast.AugAssign):
                value, targets = n.value, [n.target]
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                value, targets = n.value, [n.target]
            if value is not None and _expr_tainted(ctx, value, tainted):
                for t in targets:
                    tainted |= _bound_names(t)
    return tainted


def _bound_names(target):
    """The names an assignment target binds: a store into ``out[k]``
    taints ``out``, never the index ``k``."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return {n for e in target.elts for n in _bound_names(e)}
    if isinstance(target, (ast.Starred, ast.Subscript, ast.Attribute)):
        return _bound_names(target.value)
    return set()


def _static_test(ctx, node, tainted):
    """True when a conditional test is host-static by construction:
    is/is-not comparisons, isinstance/callable/hasattr/len, shape
    projections, and boolean algebra over those."""
    if isinstance(node, ast.BoolOp):
        return all(_static_test(ctx, v, tainted) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _static_test(ctx, node.operand, tainted)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return True
        return (_static_test(ctx, node.left, tainted)
                and all(_static_test(ctx, c, tainted)
                        for c in node.comparators))
    if isinstance(node, ast.BinOp):
        return (_static_test(ctx, node.left, tainted)
                and _static_test(ctx, node.right, tainted))
    if isinstance(node, ast.Call):
        resolved = _resolve(ctx, node.func) or ""
        return resolved in _STATIC_CALLS or not _expr_tainted(
            ctx, node, tainted)
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS or not _expr_tainted(
            ctx, node, tainted)
    if isinstance(node, (ast.Constant, ast.Name, ast.Subscript)):
        return not _expr_tainted(ctx, node, tainted)
    return False


def _bool_mask(ctx, node, tainted, masks):
    """Is ``node`` a boolean tensor: a comparison of a device value, its
    ``~``/``&``/``|`` algebra, a ``torch.isnan``-style predicate, or a
    local bound to one of those?"""
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.Compare):
        return not _static_test(ctx, node, tainted)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _bool_mask(ctx, node.operand, tainted, masks)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return (_bool_mask(ctx, node.left, tainted, masks)
                or _bool_mask(ctx, node.right, tainted, masks))
    if isinstance(node, ast.Call):
        return (_resolve(ctx, node.func) or "") in _BOOL_CALLS
    return False


def _mask_names(ctx, info, tainted):
    masks = set()
    for _ in range(2):
        for n in _own_nodes(ctx, info):
            if (isinstance(n, ast.Assign)
                    and _bool_mask(ctx, n.value, tainted, masks)):
                masks |= {t.id for t in n.targets
                          if isinstance(t, ast.Name)}
    return masks


@register("host-sync-call",
          "host sync in device code (.item()/.cpu()/bool(tensor)/a Python "
          "branch on a tensor/a data-shaped op)")
def host_sync_call(ctx):
    """A host read of a device value inside a captured step fails the
    capture on the card (``operation not permitted when stream is
    capturing``) or bakes the value read at capture into every replay —
    and on the CPU, where steps run eagerly, it passes every test.  Flags
    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")``,
    ``bool/int/float(tensor)``, numpy on device values, the graph layer's
    blocking reads (``host_any``/``fetch``/``block``/``wait_event``),
    ``torch.cuda.synchronize``/``Event.synchronize``, ops whose output
    shape follows the data (``nonzero``, ``masked_select``, ``unique``,
    boolean-mask indexing) and a Python ``if``/``while``/``assert`` on a
    tensor (the JAX package's ``traced-control-flow``).  Static config may
    be tested via ``is None`` / ``isinstance`` / shape projections."""
    for info in ctx.index.functions:
        if not info.device_reachable():
            continue
        tainted = _tainted_names(ctx, info)
        masks = _mask_names(ctx, info, tainted)
        for n in _own_nodes(ctx, info):
            yield from _sync_at(ctx, info, n, tainted, masks)


def _sync_at(ctx, info, n, tainted, masks):
    def finding(msg):
        return Finding("host-sync-call", ctx.path, n.lineno, n.col_offset,
                       msg, symbol=info.qualname)

    if isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
        if (_expr_tainted(ctx, n.test, tainted)
                and not _static_test(ctx, n.test, tainted)):
            kind = type(n).__name__.lower().replace("ifexp",
                                                    "if-expression")
            yield finding(f"Python {kind} on a tensor inside device code "
                          f"is an implicit host sync; use torch.where or "
                          f"a masked update")
        return
    if isinstance(n, ast.Subscript):
        parts = (n.slice.elts if isinstance(n.slice, ast.Tuple)
                 else [n.slice])
        if any(_bool_mask(ctx, p, tainted, masks) for p in parts):
            yield finding("boolean-mask indexing sizes its result by the "
                          "data (a nonzero): a host sync inside device "
                          "code; use torch.where")
        return
    if not isinstance(n, ast.Call):
        return
    resolved = _resolve(ctx, n.func) or ""
    sync = _graph_sync(ctx, n)
    if sync:
        yield finding(f"{sync}() is a host synchronization point and must "
                      f"not live in device code")
        return
    if isinstance(n.func, ast.Attribute) and not resolved.startswith(
            ("torch.", "numpy.")):
        attr = n.func.attr
        on_device = info.kind == STRICT or _expr_tainted(
            ctx, n.func.value, tainted)
        to_cpu = attr == "to" and any(
            isinstance(a, ast.Constant) and a.value == "cpu"
            for a in list(n.args) + [k.value for k in n.keywords
                                     if k.arg == "device"])
        if on_device and (attr in _HOST_SYNC_METHODS or to_cpu):
            yield finding(f".{attr}() forces a host sync inside device "
                          f"code")
        elif on_device and attr in _DATA_SHAPED_METHODS:
            yield finding(f".{attr}() sizes its result by the data: a host "
                          f"sync inside device code")
        return
    args_tainted = any(
        _expr_tainted(ctx, a, tainted)
        for a in list(n.args) + [k.value for k in n.keywords])
    if resolved in _HOST_SYNC_BUILTINS and args_tainted:
        yield finding(f"{resolved}() on a tensor pulls it to the host: a "
                      f"sync that a CUDA graph cannot capture")
    elif resolved.startswith("numpy.") and (args_tainted
                                            or info.kind == STRICT):
        yield finding(f"{resolved}() materializes on the host inside "
                      f"device code; use torch")
    elif resolved in _DATA_SHAPED_CALLS:
        yield finding(f"{resolved}() sizes its result by the data: a host "
                      f"sync inside device code")
    elif resolved in ("torch.cuda.synchronize",
                      "torch.cuda.current_stream.synchronize"):
        yield finding(f"{resolved}() is a host synchronization point and "
                      f"must not live in device code")


@register("env-read-in-trace",
          "os.environ/getenv read inside trace-reachable code")
def env_read_in_trace(ctx):
    """An environment read executed while a step is *captured* is frozen
    into the graph: every replay keeps the value read at capture, and
    later toggles are silently ignored.  Read env at module import (one
    documented freeze) or thread the value through explicit arguments.
    Runs in device-reachable functions, factories, and every function of
    the device packages."""
    device_file = _in_device_pkg(ctx.path)
    for info in ctx.index.functions:
        if not (info.device_reachable() or _is_factory_name(info.name)
                or device_file):
            continue
        seen_lines = set()
        for n in _own_nodes(ctx, info):
            hit = None
            if isinstance(n, ast.Call):
                resolved = _resolve(ctx, n.func) or ""
                if resolved in ("os.getenv", "os.environ.get"):
                    hit = resolved
            elif isinstance(n, ast.Attribute):
                if (n.attr == "environ"
                        and _resolve(ctx, n) == "os.environ"):
                    hit = "os.environ"
            if hit and n.lineno not in seen_lines:
                seen_lines.add(n.lineno)
                yield Finding(
                    "env-read-in-trace", ctx.path, n.lineno, n.col_offset,
                    f"{hit} read inside trace-reachable code is frozen "
                    f"into the trace (BR_JAC_BARRIER bug class); read at "
                    f"module import or pass explicitly",
                    symbol=info.qualname)


def _env_read(ctx, node):
    """``(name_node, form)`` when ``node`` is an environment READ:
    ``os.getenv(...)`` / ``os.environ.get(...)``, a Load-context
    ``os.environ[...]`` subscript, or an ``in os.environ`` membership
    test.  Writes are not reads and return None."""
    if isinstance(node, ast.Call):
        resolved = _resolve(ctx, node.func) or ""
        if resolved in ("os.getenv", "os.environ.get") and node.args:
            return node.args[0], resolved
    elif (isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and _resolve(ctx, node.value) == "os.environ"):
        return node.slice, "os.environ[...]"
    elif (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.In, ast.NotIn))
            and _resolve(ctx, node.comparators[0]) == "os.environ"):
        return node.left, "in os.environ"
    return None


@register("env-var-unregistered",
          "os.environ read of a knob absent from the ENV_KNOBS registry")
def env_var_unregistered(ctx):
    """Every environment read must name a knob declared in the port's
    ``ENV_KNOBS`` registry (batchreactor_tpu_torch/envknobs.py) with its
    read-time class: an unregistered name grows the knob surface silently,
    and a knob registered ``read="import"`` read inside a function turns
    the read-once contract into a read-sometimes bug.  Non-literal names
    are flagged too.  Runs everywhere, module scope included."""
    from ..envknobs import ENV_KNOBS

    def visit(node, in_func):
        hit = _env_read(ctx, node)
        if hit is not None:
            name_node, form = hit
            if (isinstance(name_node, ast.Constant)
                    and isinstance(name_node.value, str)):
                var = name_node.value
                knob = ENV_KNOBS.get(var)
                if knob is None:
                    yield Finding(
                        "env-var-unregistered", ctx.path, node.lineno,
                        node.col_offset,
                        f"environment variable {var!r} (read via {form}) "
                        f"is not declared in ENV_KNOBS "
                        f"(batchreactor_tpu_torch/envknobs.py); register "
                        f"its name, read-time class and owner")
                elif knob.read == "import" and in_func:
                    yield Finding(
                        "env-var-unregistered", ctx.path, node.lineno,
                        node.col_offset,
                        f"{var!r} is registered import-once "
                        f"(ENV_KNOBS read='import', owner "
                        f"{knob.owner}) but is read inside a function: "
                        f"the read-once freeze becomes a read-sometimes "
                        f"bug (BR_JAC_BARRIER class); read it at module "
                        f"scope or re-class it")
            else:
                yield Finding(
                    "env-var-unregistered", ctx.path, node.lineno,
                    node.col_offset,
                    f"non-literal environment variable name read via "
                    f"{form}: the ENV_KNOBS registry can only audit "
                    f"literal names")
        nf = in_func or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            yield from visit(child, nf)

    yield from visit(ctx.tree, False)


def _is_float_literal(node):
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "float"):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_float_literal(e) for e in node.elts)
    return False


@register("implicit-dtype",
          "float tensor created without dtype= in device code")
def implicit_dtype(ctx):
    """A bare ``torch.zeros(n)``, ``torch.tensor(0.5)`` or
    ``torch.full(shape, 1.0)`` is float32 — torch's default dtype — where
    the JAX package under x64 computes in float64.  The CPU parity tests
    find that only where their tolerance happens to be tight enough.
    Device code pins ``dtype=`` (``dtype=y.dtype`` or a ``*_like``
    factory)."""
    device_file = _in_device_pkg(ctx.path)
    for info in ctx.index.functions:
        if not (info.device_reachable() or device_file):
            continue
        for n in _own_nodes(ctx, info):
            if not isinstance(n, ast.Call):
                continue
            resolved = _resolve(ctx, n.func) or ""
            if not resolved.startswith("torch.") or resolved.count(".") != 1:
                continue
            name = resolved.split(".", 1)[1]
            if any(k.arg == "dtype" for k in n.keywords):
                continue
            if name in _FLOAT_FACTORIES:
                bad = True
            elif name == "full":
                fill = (n.args[1] if len(n.args) > 1 else next(
                    (k.value for k in n.keywords if k.arg == "fill_value"),
                    None))
                bad = fill is not None and _is_float_literal(fill)
            elif name in _LITERAL_CTORS:
                bad = (len(n.args) == 1 and _is_float_literal(n.args[0]))
            elif name == "arange":
                bad = any(_is_float_literal(a) for a in n.args)
            else:
                bad = False
            if bad:
                yield Finding(
                    "implicit-dtype", ctx.path, n.lineno, n.col_offset,
                    f"torch.{name} without dtype= makes a float32 tensor "
                    f"(torch's default dtype) where the reference computes "
                    f"in float64; pin dtype", symbol=info.qualname)


@register("recapture-hazard",
          "a CUDA graph built outside graphs.program's cache, or a cache "
          "key from a per-call closure")
def recapture_hazard(ctx):
    """``graphs.program(key, build)`` keeps one :class:`Program` per key,
    and a program captures each step once.  So a capture happens on every
    call when (a) a ``graphs.Program(...)`` is built outside a ``build``
    handed to ``graphs.program`` (no cache holds it), (b) a
    ``torch.cuda.CUDAGraph()`` is made outside ``solver/graphs.py`` (the
    one module that captures and keeps graphs), or (c) a
    ``graphs.program`` key holds ``id()`` of a closure made per call (a
    fresh identity every call: the cache never hits, and the old program
    keeps the closure alive).  The JAX package's ``recompile-hazard``,
    with the CUDA-graph meaning."""
    in_graphs = _os.path.basename(ctx.path) == "graphs.py"
    for info in ctx.index.functions:
        local = _local_closures(ctx, info)
        for n in _own_nodes(ctx, info):
            if not isinstance(n, ast.Call):
                continue
            resolved = _resolve(ctx, n.func) or ""
            if is_program_ctor(resolved) and info not in ctx.index.builders:
                yield Finding(
                    "recapture-hazard", ctx.path, n.lineno, n.col_offset,
                    "graphs.Program built outside a graphs.program build: "
                    "no cache keeps it, so its steps are captured afresh "
                    "on every call; build it in the build callable of "
                    "graphs.program(key, build)", severity="warning",
                    symbol=info.qualname)
            elif resolved == "torch.cuda.CUDAGraph" and not in_graphs:
                yield Finding(
                    "recapture-hazard", ctx.path, n.lineno, n.col_offset,
                    "torch.cuda.CUDAGraph() outside solver/graphs.py: a "
                    "graph no program cache keeps is captured on every "
                    "call; make the step a graphs.Program step",
                    severity="warning", symbol=info.qualname)
            elif is_program_cache(resolved) and n.args:
                key = _key_expr(info, n.args[0])
                for sub in ast.walk(key):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Name)
                            and sub.func.id == "id" and sub.args
                            and isinstance(sub.args[0], ast.Name)
                            and sub.args[0].id in local):
                        yield Finding(
                            "recapture-hazard", ctx.path, n.lineno,
                            n.col_offset,
                            f"graphs.program key holds id() of "
                            f"{sub.args[0].id!r}, a closure made on every "
                            f"call: the key never repeats, so every call "
                            f"builds and captures a new program",
                            symbol=info.qualname)


def _local_closures(ctx, info):
    """Names bound in ``info`` to a nested def or a lambda."""
    names = set(info.children)
    for n in _own_nodes(ctx, info):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Lambda):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    return names


def _key_expr(info, key):
    """The expression a ``graphs.program`` key was built from (a local
    name is followed to its last assignment)."""
    if isinstance(key, ast.Name):
        for n in ast.walk(info.node):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == key.id
                    for t in n.targets):
                key = n.value
    return key
