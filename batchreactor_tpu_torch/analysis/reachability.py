"""Device-reachability classification for the port's tier-A rules.

The rules hinge on one question the AST alone does not answer: *which
functions run inside a captured step?*  On the card every step of a
:class:`~..solver.graphs.Program` is captured once as a CUDA graph and
replayed; on the CPU the same function runs eagerly.  A host read of a
device value there passes every CPU test and fails only at capture (or
bakes one value into the graph).  This module classifies conservatively,
with two device classes per function:

* ``STRICT`` — every parameter is a tensor (or a nest of them) when the
  function runs:

  - a value of the step dict passed to ``graphs.Program(dev, {...})``;
  - a ``build`` passed to ``graphs.program(key, build)``;
  - the body of a ``with torch.cuda.graph(...)`` block (a pseudo-function
    ``<cuda-graph>`` with no parameters);
  - a callable given to ``torch.func.{jvp,vjp,vmap,grad,jacrev,jacfwd,
    hessian}``, ``torch.vmap``, ``torch.autograd.functional.*`` or
    ``torch.utils.checkpoint.checkpoint``;
  - ``forward``/``backward`` of a ``torch.autograd.Function`` subclass;
  - a closure returned by the package's device-closure factories
    (``make_*`` / ``*_rhs`` / ``*_jac`` / ``*observer*``: the ``ops/rhs.py``
    contract; the returned callable runs inside every step), including
    the callables handed to a returned constructor
    (``return Stepper(init, window, result)``).

  A parameter with a literal default (``fixed=False``, ``mode="half"``)
  is host configuration, not a tensor; ``ctx`` of an autograd function
  is the context object.
* ``MIXED`` — reachable by direct call from device code (helpers like the
  kinetics kernels): *some* arguments may be tensors, but the AST cannot
  tell which, so rules only act on locally provable tensor values
  (``torch.*``-derived expressions) inside these.

Everything else is ``HOST``.  Resolution is module-local and name-based,
as in the JAX package's ``analysis/reachability.py``.  Stdlib-only.
"""

import ast

STRICT = "strict"
MIXED = "mixed"
HOST = "host"

# canonical dotted names whose callable arguments run on tensors; values
# are the argument positions that receive functions
_TRACE_CONSUMERS = {
    "torch.func.jvp": (0,),
    "torch.func.vjp": (0,),
    "torch.func.vmap": (0,),
    "torch.func.grad": (0,),
    "torch.func.grad_and_value": (0,),
    "torch.func.jacrev": (0,),
    "torch.func.jacfwd": (0,),
    "torch.func.hessian": (0,),
    "torch.func.linearize": (0,),
    "torch.vmap": (0,),
    "torch.autograd.functional.jacobian": (0,),
    "torch.autograd.functional.jvp": (0,),
    "torch.autograd.functional.vjp": (0,),
    "torch.utils.checkpoint.checkpoint": (0,),
}
_AUTOGRAD_FUNCTION_BASES = ("torch.autograd.Function",
                            "torch.autograd.function.Function")


def _is_factory_name(name):
    return (name.startswith("make_") or name.endswith("_rhs")
            or name.endswith("_jac") or "observer" in name)


def is_program_ctor(resolved):
    """``graphs.Program`` as a call site spells it."""
    return resolved == "graphs.Program" or resolved.endswith(
        ".graphs.Program")


def is_program_cache(resolved):
    """``graphs.program`` (the cache of built programs)."""
    return resolved == "graphs.program" or resolved.endswith(
        ".graphs.program")


class _Aliases:
    """import-table: local name -> canonical dotted path."""

    def __init__(self, tree):
        self.map = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.map[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.map[a.asname or a.name] = f"{node.module}.{a.name}"
        self.map.setdefault("np", "numpy")

    def resolve(self, node):
        """Canonical dotted name of an expression like ``torch.zeros`` /
        ``graphs.Program`` / ``jvp``, or None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.map.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


def _literal_default(node):
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (bool, int, float, str)))


class FunctionInfo:
    def __init__(self, node, qualname, parent, name=None):
        self.node = node
        self.name = name or getattr(node, "name", "<lambda>")
        self.qualname = qualname
        self.parent = parent        # enclosing FunctionInfo or None
        self.kind = HOST
        self.host_params = set()    # literal-default config, ``ctx``
        self.children = {}          # name -> FunctionInfo (nested defs)
        self.calls = set()          # bare names called in the body

    @property
    def params(self):
        a = getattr(self.node, "args", None)
        if a is None:               # a ``with torch.cuda.graph`` body
            return []
        names = [p.arg for p in
                 list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    @property
    def traced_params(self):
        if self.kind == STRICT:
            return set(self.params) - self.host_params
        return set()

    def device_reachable(self):
        return self.kind in (STRICT, MIXED)


class ModuleIndex:
    """Per-file function table with device classification.

    Built once per :class:`~.core.FileContext`; rules iterate
    ``functions`` (FunctionInfo, including lambdas and captured ``with``
    bodies) and use ``aliases.resolve``."""

    def __init__(self, tree, path=""):
        self.tree = tree
        self.path = path
        self.aliases = _Aliases(tree)
        self.functions = []          # all FunctionInfo, outer-first
        self.by_node = {}
        #: functions that build a cached program: a ``build`` handed to
        #: ``graphs.program`` and what it calls by name
        self.builders = set()
        self._collect(tree, None, "")
        self._collect_calls()
        self._classify()

    # -- collection --------------------------------------------------------
    def _collect(self, node, parent, prefix):
        """Register every function node (defs at any nesting depth,
        lambdas, and the bodies of ``with torch.cuda.graph(...)``),
        tracking the enclosing-function parent chain."""
        info = None
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            name = getattr(node, "name", "<lambda>")
            qual = f"{prefix}{name}" if prefix else name
            info = FunctionInfo(node, qual, parent)
            if parent is not None and name != "<lambda>":
                parent.children[name] = info
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and self.aliases.resolve(it.context_expr.func)
                == "torch.cuda.graph" for it in node.items):
            qual = f"{prefix}<cuda-graph>" if prefix else "<cuda-graph>"
            info = FunctionInfo(node, qual, parent, name="<cuda-graph>")
            info.kind = STRICT
        if info is not None:
            self.functions.append(info)
            self.by_node[node] = info
            parent, prefix = info, info.qualname + "."
        for child in ast.iter_child_nodes(node):
            self._collect(child, parent, prefix)

    def _collect_calls(self):
        """Record the bare names each function calls in its OWN body —
        nested defs keep their calls to themselves."""
        for info in self.functions:
            body = info.node.body
            stack = list(body) if isinstance(body, list) else [body]
            while stack:
                n = stack.pop()
                if n in self.by_node and n is not info.node:
                    continue
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                    info.calls.add(n.func.id)
                stack.extend(ast.iter_child_nodes(n))

    # -- classification ----------------------------------------------------
    def _mark_strict(self, func_expr, scope):
        """Mark the function an expression refers to."""
        info = None
        if isinstance(func_expr, ast.Lambda):
            info = self.by_node.get(func_expr)
        elif isinstance(func_expr, ast.Name):
            info = self._resolve_name(func_expr.id, scope)
        if info and info.kind == HOST:
            info.kind = STRICT
        return info

    def _resolve_name(self, name, scope):
        """Resolve a bare name to a FunctionInfo: nested defs of the
        enclosing scopes first, then module-level defs."""
        s = scope
        while s is not None:
            if name in s.children:
                return s.children[name]
            if s.name == name:
                return s
            s = s.parent
        for info in self.functions:
            if info.parent is None and info.name == name:
                return info
        return None

    def _host_params(self, info):
        """Literal-default parameters (host configuration)."""
        a = getattr(info.node, "args", None)
        if a is None:
            return set()
        pos = list(a.posonlyargs) + list(a.args)
        out = {p.arg for p, d in zip(pos[len(pos) - len(a.defaults):],
                                     a.defaults) if _literal_default(d)}
        out |= {p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None and _literal_default(d)}
        return out

    def _classify(self):
        node_scope = {}
        for info in self.functions:
            for n in ast.walk(info.node):
                if isinstance(n, ast.Call):
                    node_scope[n] = info     # innermost wins (outer-first)

        # 1. call sites: Program step dicts, program builds, torch.func
        for n in ast.walk(self.tree):
            if not isinstance(n, ast.Call):
                continue
            resolved = self.aliases.resolve(n.func) or ""
            scope = node_scope.get(n)
            if is_program_ctor(resolved):
                steps = n.args[1] if len(n.args) > 1 else next(
                    (k.value for k in n.keywords if k.arg == "steps"), None)
                if isinstance(steps, ast.Dict):
                    for v in steps.values:
                        self._mark_strict(v, scope)
            elif is_program_cache(resolved):
                build = n.args[1] if len(n.args) > 1 else next(
                    (k.value for k in n.keywords if k.arg == "build"), None)
                info = (self._mark_strict(build, scope)
                        if build is not None else None)
                if info is not None:
                    self.builders.add(info)
                    for name in info.calls:
                        callee = self._resolve_name(name, info)
                        if callee is not None:
                            self.builders.add(callee)
            else:
                spec = _TRACE_CONSUMERS.get(resolved)
                for i in spec or ():
                    if i < len(n.args):
                        self._mark_strict(n.args[i], scope)

        # 2. forward/backward of autograd functions
        for n in ast.walk(self.tree):
            if isinstance(n, ast.ClassDef) and any(
                    (self.aliases.resolve(b) or "") in
                    _AUTOGRAD_FUNCTION_BASES for b in n.bases):
                for item in n.body:
                    info = self.by_node.get(item)
                    if info and info.name in ("forward", "backward",
                                              "setup_context", "jvp",
                                              "vmap"):
                        info.kind = STRICT
                        info.host_params.add("ctx")

        # 3. closures returned by device-closure factories
        for info in self.functions:
            if not _is_factory_name(info.name):
                continue
            for n in ast.walk(info.node):
                if isinstance(n, ast.Return) and n.value is not None:
                    vals = (n.value.elts
                            if isinstance(n.value, ast.Tuple) else [n.value])
                    for v in vals:
                        if isinstance(v, ast.Call):
                            for a in list(v.args) + [k.value for k in
                                                     v.keywords]:
                                self._mark_strict(a, info)
                        else:
                            self._mark_strict(v, info)

        for info in self.functions:
            if info.kind == STRICT:
                info.host_params |= self._host_params(info)

        # 4. propagate by direct call: device code -> MIXED helpers
        changed = True
        while changed:
            changed = False
            for info in self.functions:
                if not info.device_reachable():
                    continue
                for name in info.calls:
                    callee = self._resolve_name(name, info)
                    if callee is not None and callee.kind == HOST:
                        callee.kind = MIXED
                        changed = True
