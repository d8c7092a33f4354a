"""brlint tier C (b): host-concurrency lint for the port's threaded host
stack.

The port runs the same threaded host layer as the JAX package: serving
scheduler worker threads resolving futures (``serving/scheduler.py``), the
HTTP front end (``serving/server.py``), the fleet router
(``fleet/router.py``), the ``obs/live.py`` MetricsServer and LiveRegistry
overlays scraped while drivers publish, the heartbeat and wedge-watchdog
threads, the sweep's trajectory drain and mesh threads, and the lock
around ``solver/graphs.py``'s program cache that the mesh threads share.
Port of ``batchreactor_tpu/analysis/concurrency.py``, with the tier-A
conventions (per-line ``# brlint: disable=RULE`` suppressions, JSON
output, content-fingerprint baselines):

* **shared-mutable-state map** — per class: attributes assigned in
  ``__init__``, lock attributes (``threading.Lock/RLock/Condition``
  constructions), and *thread-entry* methods: ``threading.Thread(
  target=self.x)`` targets, ``do_*`` methods of HTTP handler classes,
  methods named ``tap`` (the Recorder tap-hook convention), plus
  anything the module declares in a ``_BRLINT_THREAD_ENTRIES`` tuple
  (``"Class.method"`` strings — entry points called from *other*
  modules' threads).  An attribute is **shared** when any method
  reachable from an entry (transitively, via ``self.m()`` calls) touches
  it.

* ``unguarded-shared-mutation`` — every mutation site of a shared
  attribute (assignment, aug-assignment, subscript store, or a
  mutating method call: append/pop/update/...) outside ``__init__``
  must be dominated by ``with self.<lock>`` on one of the class's
  locks (or a module lock).  A method whose name ends in ``_locked``
  asserts "my caller holds the lock" — and ``locked-helper-outside-lock``
  then flags any call site of such a method that is NOT inside a lock.
  Module globals get the same treatment when the module owns a
  module-level lock (the ``graphs._PROGRAMS_LOCK`` pattern).

* ``blocking-call-under-lock`` — no blocking device read (the graph
  layer's ``fetch`` / ``block`` / ``host_any`` / ``wait_event``,
  ``torch.cuda.synchronize``, ``.synchronize()``, the watchdog's
  ``block_with_deadline``), no ``future.result()``, no ``thread.join()``,
  no ``time.sleep`` while holding a lock.  ``cond.wait()`` on the *held*
  condition is the one exemption.

* ``lock-order-inversion`` — nested ``with`` acquisitions define a
  lock-order edge; two edges in opposite directions anywhere in one
  module flag a potential ABBA deadlock.

* ``static-buffer-aliasing`` — the CUDA-graph meaning of the JAX
  package's ``donation-aliasing`` (which has no counterpart: torch has no
  ``donate_argnums``).  A captured program writes its results into the
  same static buffers on every replay (``Program.state``), so a value of
  ``<program>.state[...]`` handed to a caller — returned, yielded or
  stored on an object — without a ``.clone()`` (or a host copy) is
  overwritten by the next replay under the caller's feet.  Locals bound
  straight to such a value count as the value.

The analysis is module-local and name-based like the tier-A
reachability pass.  The default scan set is the threaded host surface —
:data:`DEFAULT_MODULES`.
"""

import ast
import os

from .core import FileContext, Finding, iter_python_files

#: the threaded host modules the acceptance gate runs clean on,
#: relative to the package root
DEFAULT_MODULES = (
    "serving",
    "fleet",
    os.path.join("obs", "live.py"),
    os.path.join("resilience", "watchdog.py"),
    os.path.join("resilience", "heartbeat.py"),
    os.path.join("parallel", "sweep.py"),
    os.path.join("solver", "graphs.py"),
)

#: rule catalogue (name -> one-line doc), the --list surface
CONCURRENCY_RULES = {
    "unguarded-shared-mutation":
        "mutation of thread-shared state outside the owning lock",
    "locked-helper-outside-lock":
        "*_locked helper called without holding a lock",
    "blocking-call-under-lock":
        "blocking fetch/.result()/join/sleep while holding a lock",
    "lock-order-inversion":
        "two locks acquired in opposite nesting orders (ABBA hazard)",
    "static-buffer-aliasing":
        "a program's static buffer handed to a caller without a clone",
}

_LOCK_CTORS = {"threading.Lock", "threading.RLock",
               "threading.Condition", "threading.Semaphore",
               "threading.BoundedSemaphore",
               "Lock", "RLock", "Condition"}
_MUTATING_METHODS = {"append", "extend", "add", "update", "setdefault",
                     "pop", "popleft", "appendleft", "remove",
                     "discard", "clear", "insert", "sort", "reverse"}
_BLOCKING_RESOLVED = {"time.sleep", "torch.cuda.synchronize"}
_BLOCKING_NAMES = {"block_with_deadline", "host_any", "fetch", "block",
                   "wait_event"}
# the graph layer's blocking reads, as a call site spells them
_BLOCKING_GRAPH = {"graphs." + n for n in ("fetch", "block", "host_any",
                                            "wait_event")}
_BLOCKING_ATTRS = {"result", "join", "synchronize"}


def default_paths():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(pkg, m) for m in DEFAULT_MODULES]


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------
def _self_attr(node):
    """``self.X`` -> ``"X"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _mutation_target_attr(target):
    """The ``self.X`` attribute a store target mutates (descending
    through subscripts: ``self.X[i] = ...`` mutates X), else None."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    return _self_attr(node)


def _mutation_target_global(target):
    node = target
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _lock_id(expr, class_locks, module_locks):
    """Identify a lock expression: ``self.X`` (X a class lock attr) ->
    ("self", X); bare module-lock name -> ("module", name)."""
    attr = _self_attr(expr)
    if attr is not None and attr in class_locks:
        return ("self", attr)
    if isinstance(expr, ast.Name) and expr.id in module_locks:
        return ("module", expr.id)
    return None


def _lock_name(lock):
    return (f"self.{lock[1]}" if lock[0] == "self" else lock[1])


# --------------------------------------------------------------------------
# per-module model
# --------------------------------------------------------------------------
class _ClassModel:
    def __init__(self, node, ctx, module_locks, declared_entries):
        self.node = node
        self.name = node.name
        self.methods = {n.name: n for n in node.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.init_attrs = {}
        self.lock_attrs = set()
        self._collect_init(ctx)
        self.http_handler = any(
            "RequestHandler" in (ctx.index.aliases.resolve(b) or
                                 getattr(b, "id", "") or
                                 getattr(b, "attr", ""))
            for b in node.bases)
        self.entries = self._find_entries(ctx, declared_entries)
        self.reachable = self._close_over_calls()
        self.module_locks = module_locks
        self.shared = self._shared_attrs()

    def _collect_init(self, ctx):
        init = self.methods.get("__init__")
        if init is None:
            return
        for n in ast.walk(init):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    self.init_attrs[attr] = n.lineno
                    if (isinstance(n.value, ast.Call)
                            and (ctx.index.aliases.resolve(n.value.func)
                                 or "") in _LOCK_CTORS):
                        self.lock_attrs.add(attr)

    def _find_entries(self, ctx, declared):
        entries = set(declared.get(self.name, ()))
        for name, m in self.methods.items():
            if self.http_handler and name.startswith("do_"):
                entries.add(name)
            if name == "tap":
                # the Recorder tap-hook convention (obs/live.py): taps
                # fire from whichever thread completed the span
                entries.add(name)
            for n in ast.walk(m):
                if not (isinstance(n, ast.Call)
                        and (ctx.index.aliases.resolve(n.func) or "")
                        == "threading.Thread"):
                    continue
                for kw in n.keywords:
                    if kw.arg != "target":
                        continue
                    attr = _self_attr(kw.value)
                    if attr is not None and attr in self.methods:
                        entries.add(attr)
        return entries

    def _close_over_calls(self):
        edges = {}
        for name, m in self.methods.items():
            outs = set()
            for n in ast.walk(m):
                if isinstance(n, ast.Call):
                    callee = _self_attr(n.func)
                    if callee in self.methods:
                        outs.add(callee)
            edges[name] = outs
        reach, frontier = set(self.entries), list(self.entries)
        while frontier:
            m = frontier.pop()
            for callee in edges.get(m, ()):
                if callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        return reach

    def _shared_attrs(self):
        """Attributes touched (read OR written) from thread-reachable
        methods — the candidates whose *mutations* must be locked."""
        shared = set()
        for name in self.reachable:
            m = self.methods.get(name)
            if m is None or name == "__init__":
                continue
            for n in ast.walk(m):
                attr = _self_attr(n)
                if attr is not None:
                    shared.add(attr)
        return shared - self.lock_attrs


class _ModuleModel:
    def __init__(self, ctx):
        self.ctx = ctx
        tree = ctx.tree
        self.module_locks = set()
        self.container_globals = set()
        self.declared_entries = {}
        for n in tree.body:
            if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                continue
            t = n.targets[0]
            if not isinstance(t, ast.Name):
                continue
            resolved = ""
            if isinstance(n.value, ast.Call):
                resolved = ctx.index.aliases.resolve(n.value.func) or ""
            if resolved in _LOCK_CTORS:
                self.module_locks.add(t.id)
            elif resolved in ("collections.deque", "deque", "dict",
                              "list", "set", "collections.OrderedDict",
                              "collections.defaultdict"):
                self.container_globals.add(t.id)
            elif isinstance(n.value, (ast.Dict, ast.List, ast.Set)):
                self.container_globals.add(t.id)
            if t.id == "_BRLINT_THREAD_ENTRIES":
                for el in ast.walk(n.value):
                    if (isinstance(el, ast.Constant)
                            and isinstance(el.value, str)
                            and "." in el.value):
                        cls, meth = el.value.rsplit(".", 1)
                        self.declared_entries.setdefault(
                            cls, set()).add(meth)
        self.classes = [
            _ClassModel(n, ctx, self.module_locks, self.declared_entries)
            for n in tree.body if isinstance(n, ast.ClassDef)]


# --------------------------------------------------------------------------
# the body walker (lock stack + site collection)
# --------------------------------------------------------------------------
class _Sites:
    """Everything one function body yields to the rules: mutation
    sites, calls (with the lock stack held at each), lock-order edges,
    and local assignments."""

    def __init__(self):
        self.mutations = []    # (node, attr_or_None, global_or_None, held)
        self.calls = []        # (node, held)
        self.edges = []        # (outer_lock, inner_lock, node)
        self.assigns = []      # (target_names, value_expr, lineno)
        self.globals_decl = set()


def _collect_sites(fn_node, class_locks, module_locks, sites):
    def lock_of(expr):
        return _lock_id(expr, class_locks, module_locks)

    def walk(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested callable: runs later, on an unknown lock stack
            body = node.body if isinstance(node.body, list) else [
                node.body]
            for child in body:
                walk(child, [])
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = list(held)
            for item in node.items:
                walk(item.context_expr, held)
                lock = lock_of(item.context_expr)
                if lock is not None:
                    for outer in new:
                        if outer != lock:
                            sites.edges.append((outer, lock, node))
                    new.append(lock)
            for child in node.body:
                walk(child, new)
            return
        if isinstance(node, ast.Global):
            sites.globals_decl.update(node.names)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                flat = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t])
                for tt in flat:
                    attr = _mutation_target_attr(tt)
                    g = (None if attr is not None
                         else _mutation_target_global(tt))
                    if attr is not None or g is not None:
                        sites.mutations.append((node, attr, g,
                                                list(held)))
            names = []
            for t in targets:
                flat = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t])
                names.extend(tt.id for tt in flat
                             if isinstance(tt, ast.Name))
            value = getattr(node, "value", None)
            if names and value is not None:
                sites.assigns.append((names, value, node.lineno))
        if isinstance(node, ast.Call):
            sites.calls.append((node, list(held)))
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _MUTATING_METHODS:
                    attr = _mutation_target_attr(node.func.value)
                    g = (None if attr is not None
                         else _mutation_target_global(node.func.value))
                    if attr is not None or g is not None:
                        sites.mutations.append((node, attr, g,
                                                list(held)))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in fn_node.body:
        walk(stmt, [])


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------
def _held_any_lock(held):
    return bool(held)


def _class_findings(ctx, cm, findings, edges_out):
    path = ctx.path
    for mname, m in cm.methods.items():
        if mname in ("__init__", "__new__"):
            continue
        sites = _Sites()
        _collect_sites(m, cm.lock_attrs, cm.module_locks, sites)
        edges_out.extend(sites.edges)
        locked_by_name = mname.endswith("_locked")
        have_locks = bool(cm.lock_attrs or cm.module_locks)
        for node, attr, _g, held in sites.mutations:
            if attr is None or attr not in cm.shared:
                continue
            if locked_by_name or _held_any_lock(held):
                continue
            lock_hint = (
                f"with self.{sorted(cm.lock_attrs)[0]}" if cm.lock_attrs
                else "a class lock (none declared in __init__)")
            findings.append(Finding(
                "unguarded-shared-mutation", path, node.lineno,
                node.col_offset,
                f"'{cm.name}.{attr}' is shared with thread-reachable "
                f"code ({', '.join(sorted(cm.entries)) or 'entries'}) "
                f"but mutated here without holding {lock_hint}"
                + ("" if have_locks else
                   "; add a threading.Lock in __init__"),
                symbol=f"{cm.name}.{mname}"))
        for node, held in sites.calls:
            callee = _self_attr(node.func)
            if (callee is not None and callee.endswith("_locked")
                    and callee in cm.methods
                    and not _held_any_lock(held)
                    and not locked_by_name):
                findings.append(Finding(
                    "locked-helper-outside-lock", path, node.lineno,
                    node.col_offset,
                    f"self.{callee}() asserts its caller holds the "
                    f"lock (the *_locked convention) but no lock is "
                    f"held here", symbol=f"{cm.name}.{mname}"))
            _blocking_check(ctx, cm, mname, node, held, findings)


def _blocking_check(ctx, cm, mname, node, held, findings):
    if not held:
        return
    resolved = ctx.index.aliases.resolve(node.func) or ""
    blocking = None
    if resolved in _BLOCKING_RESOLVED:
        blocking = resolved
    elif resolved in _BLOCKING_NAMES or any(
            resolved == g or resolved.endswith("." + g)
            for g in _BLOCKING_GRAPH):
        blocking = resolved
    elif isinstance(node.func, ast.Name) and \
            node.func.id in _BLOCKING_NAMES:
        blocking = node.func.id
    elif isinstance(node.func, ast.Attribute):
        if node.func.attr in ("wait", "wait_for"):
            # cond.wait() on the HELD condition releases it — the one
            # legitimate blocking call under a lock
            lock = _lock_id(node.func.value,
                            cm.lock_attrs if cm else set(),
                            cm.module_locks if cm else set())
            if lock is not None and lock in held:
                return
        if node.func.attr in _BLOCKING_ATTRS:
            blocking = f".{node.func.attr}()"
    if blocking is None:
        return
    locks = ", ".join(_lock_name(x) for x in held)
    findings.append(Finding(
        "blocking-call-under-lock", ctx.path, node.lineno,
        node.col_offset,
        f"{blocking} blocks while holding {locks}: every other "
        f"lock-taker convoys behind it (and a wedged wait here "
        f"deadlocks the paths that would report it); move the wait "
        f"outside the lock",
        symbol=(f"{cm.name}.{mname}" if cm else mname)))


def _module_global_findings(ctx, model, findings, edges_out):
    """Lock discipline for module globals (only when the module owns a
    module-level lock — otherwise there is no discipline to check)."""
    if not model.module_locks:
        return
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef,
                                 ast.AsyncFunctionDef))]:
        in_class = any(fn in c.node.body or any(
            fn in ast.walk(meth) for meth in c.methods.values())
            for c in model.classes)
        if in_class:
            continue    # class methods handled by _class_findings
        sites = _Sites()
        _collect_sites(fn, set(), model.module_locks, sites)
        edges_out.extend(sites.edges)
        locked_by_name = fn.name.endswith("_locked")
        for node, _attr, g, held in sites.mutations:
            if g is None:
                continue
            is_decl_global = g in sites.globals_decl
            is_container = g in model.container_globals
            if not (is_decl_global or is_container):
                continue
            if (g in model.module_locks or _held_any_lock(held)
                    or locked_by_name):
                continue
            findings.append(Finding(
                "unguarded-shared-mutation", ctx.path, node.lineno,
                node.col_offset,
                f"module global '{g}' is mutated without holding a "
                f"module lock ({', '.join(sorted(model.module_locks))}"
                f" exist(s) for exactly this)", symbol=fn.name))
        for node, held in sites.calls:
            if (isinstance(node.func, ast.Name)
                    and node.func.id.endswith("_locked")
                    and not _held_any_lock(held)
                    and not locked_by_name):
                findings.append(Finding(
                    "locked-helper-outside-lock", ctx.path,
                    node.lineno, node.col_offset,
                    f"{node.func.id}() asserts its caller holds the "
                    f"lock (the *_locked convention) but no lock is "
                    f"held here", symbol=fn.name))
            _blocking_check(ctx, None, fn.name, node, held, findings)


def _lock_order_findings(ctx, edges, findings):
    seen = {}
    for outer, inner, node in edges:
        seen.setdefault((outer, inner), node)
    for (a, b), node in sorted(
            seen.items(),
            key=lambda kv: (kv[1].lineno, kv[1].col_offset)):
        if (b, a) in seen and seen[(b, a)].lineno < node.lineno:
            other = seen[(b, a)]
            findings.append(Finding(
                "lock-order-inversion", ctx.path, node.lineno,
                node.col_offset,
                f"{_lock_name(b)} acquired while holding "
                f"{_lock_name(a)}, but line {other.lineno} acquires "
                f"them in the opposite order: ABBA deadlock hazard — "
                f"pick one order and document it"))


def _state_value(expr):
    """Is ``expr`` a value of a program's static buffers: a subscript
    chain rooted at ``<x>.state`` (``prog.state["seg"]["y"]``)?"""
    node = expr
    if not isinstance(node, ast.Subscript):
        return False
    while isinstance(node, ast.Subscript):
        node = node.value
    return isinstance(node, ast.Attribute) and node.attr == "state"


def _handed_out(expr, aliases):
    """The sub-expressions of a returned/stored value that alias a static
    buffer (tuple, list and dict displays are looked into)."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        return [x for e in expr.elts for x in _handed_out(e, aliases)]
    if isinstance(expr, ast.Dict):
        return [x for e in expr.values for x in _handed_out(e, aliases)]
    if _state_value(expr) or (isinstance(expr, ast.Name)
                              and expr.id in aliases):
        return [expr]
    return []


def _static_buffer_findings(ctx, findings):
    """The ``static-buffer-aliasing`` rule (module doc): per function, a
    ``return``/``yield`` of a static-buffer value, or a store of one into
    an attribute of an object, with no copy in between."""
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        sites = _Sites()
        for stmt in fn.body:
            _collect_sites_shallow(stmt, sites)
        aliases = {names[0] for names, value, _ln in sites.assigns
                   if len(names) == 1 and _state_value(value)}
        rebound = {n for names, value, _ln in sites.assigns
                   if not _state_value(value) for n in names}
        aliases -= rebound
        for node in _shallow_walk(fn):
            if isinstance(node, (ast.Return, ast.Yield)) and node.value:
                out, how = node.value, "returned"
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Attribute) for t in node.targets):
                out, how = node.value, "stored on an object"
            else:
                continue
            for e in _handed_out(out, aliases):
                what = (f"'{e.id}'" if isinstance(e, ast.Name)
                        else "a program state value")
                findings.append(Finding(
                    "static-buffer-aliasing", ctx.path, node.lineno,
                    node.col_offset,
                    f"{what} is {how} without a copy, but it is a static "
                    f"buffer of a captured program (Program.state): the "
                    f"next replay overwrites it under the caller; hand "
                    f"out .clone() (or a host copy) instead",
                    symbol=fn.name))


def _shallow_walk(fn):
    """The nodes of one function body, nested defs excluded."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _collect_sites_shallow(stmt, sites):
    """Assignment/call collection that stays inside ONE function scope
    (nested defs run their own sweep)."""

    def walk(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Assign):
            names = []
            for t in node.targets:
                flat = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t])
                names.extend(tt.id for tt in flat
                             if isinstance(tt, ast.Name))
            if names:
                sites.assigns.append((names, node.value, node.lineno))
        if isinstance(node, ast.Call):
            sites.calls.append((node, []))
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(stmt)


# --------------------------------------------------------------------------
# entry points (tier-A-shaped: findings + suppressed + sources)
# --------------------------------------------------------------------------
def lint_concurrency_file(path, select=None):
    """Run the concurrency rules over one file; same return shape as
    :func:`~.core.lint_file` (findings, n_suppressed, source_lines)."""
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    lines = source.splitlines()
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, 0,
                        f"could not parse: {e.msg}")], 0, lines
    model = _ModuleModel(ctx)
    raw, edges = [], []
    for cm in model.classes:
        _class_findings(ctx, cm, raw, edges)
    _module_global_findings(ctx, model, raw, edges)
    _lock_order_findings(ctx, edges, raw)
    _static_buffer_findings(ctx, raw)
    # a nested function is scanned both through its enclosing function
    # (lock stack reset) and standalone — identical findings, once each
    seen, deduped = set(), []
    for f in raw:
        key = (f.rule, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            deduped.append(f)
    raw = deduped
    findings, n_suppressed = [], 0
    for f in raw:
        if select is not None and f.rule not in select:
            continue
        if ctx.suppressed(f):
            n_suppressed += 1
        else:
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, n_suppressed, lines


def lint_concurrency_paths(paths=None, select=None):
    """Scan files/directories (default: :data:`DEFAULT_MODULES` under
    the package root); returns (findings, n_suppressed, sources) in the
    :func:`~.core.lint_paths` shape so baselines and fingerprints
    apply unchanged."""
    paths = list(paths) if paths else default_paths()
    findings, n_suppressed, sources = [], 0, {}
    for path in iter_python_files(paths):
        fs, ns, lines = lint_concurrency_file(path, select)
        findings.extend(fs)
        n_suppressed += ns
        sources[path] = lines
    return findings, n_suppressed, sources
