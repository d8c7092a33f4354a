"""CUDA graphs of the step windows: capture once per shape, replay.

The JAX package compiles one XLA program per segment and per bucket
(``jax.jit`` of the vmapped solver); the port's counterpart is a
``torch.cuda.CUDAGraph`` of each fixed-trip step function (a BDF or SDIRK
window, a segment's opening and closing, the streaming driver's compaction),
captured once over static buffers and replayed.  A :class:`Program` holds
one dict of static buffers and the named steps that update it in place.

* On the CPU a step runs eagerly, the same function on the same buffers,
  with no graph.
* On CUDA the first run of a step warms it up once on a side stream (the
  PyTorch prescription: lazy initialisation, the kinetics' cached index
  tensors, the ``lu32p`` library load happen there), captures it, then
  replays it; every later run replays.  A failure to capture or to replay
  raises.  There is no eager fallback on the card.

The module keeps counters beside ``linalg_cuda.LAUNCHES``: graphs captured
(:data:`CAPTURES`, also by step name), replays, host syncs (each point
where the host reads a device value to decide what to launch next: a
blocking wait on the card) and Newton iterations executed.  A count made
by code inside a captured step (``lu32p`` launches by path, Newton
iterations) is recorded once at capture and added on every replay, so a
count means work the card did.

Every blocking host read of the segmented drivers goes through this module
(:func:`host_any`, :func:`fetch`, :func:`block`, :func:`wait_event`), which
makes it the one choke point of the wedge watchdog: inside
:func:`fetch_deadline` (thread-local) each read waits through
``resilience.watchdog.block_with_deadline`` and raises ``WedgeError`` past
its deadline; outside it a read adds no event, poll or thread.

Inside :func:`recording` (thread-local) every increment of :data:`COUNTS`
also lands on an ``obs.Recorder`` under the names of
:data:`RECORDER_NAMES` (a replayed graph's tally too), so a run's report
carries its own host syncs.  Program builds and graph captures are
reported to the entered ``obs.CompileWatch`` instances
(``obs/retrace.py``).

A fixed-trip loop inside a step (a window's attempts, an attempt's Newton
iterations) calls :func:`loop_pass` at the start of each pass: free unless
a listener is entered (:func:`pass_marks`), which the contract engine's op
log uses to fold a loop's repeated passes into one
(``analysis/costmodel.py``).
"""

import contextlib
import threading
import time

import torch

#: graphs captured, by step name (``begin``, ``window``, ``end``,
#: ``compact``) since the counts were last set to 0
CAPTURES = {}
#: the graph/poll layer's counters since they were last set to 0:
#: ``replays`` (graph replays), ``host_syncs`` (blocking reads of a device
#: value by the host), ``newton_iters`` (Newton iterations executed: a
#: fixed-trip window counts every iteration it runs, masked or not)
COUNTS = {"replays": 0, "host_syncs": 0, "newton_iters": 0}

#: the recorder counter each :data:`COUNTS` key lands on inside
#: :func:`recording` (``host_syncs`` under the JAX package's name)
RECORDER_NAMES = {"host_syncs": "blocking_syncs", "replays": "graph_replays",
                  "newton_iters": "newton_iters_executed"}

# guards COUNTS and CAPTURES: the mesh's host threads replay and count at
# the same time
_COUNTS_LOCK = threading.Lock()
# the tally of the graph being captured (None outside a capture): counts
# made by the captured code, replayed with the graph
_tally = threading.local()
# the recorder of this thread's run (None: off)
_sink = threading.local()
# whether this thread captures its graphs in debug mode
_debug = threading.local()
# the listener of this thread's loop passes (None: off)
_passes = threading.local()


@contextlib.contextmanager
def pass_marks(listener):
    """Call ``listener(loop)`` at each :func:`loop_pass` of this thread for
    the block."""
    prev = getattr(_passes, "value", None)
    _passes.value = listener
    try:
        yield
    finally:
        _passes.value = prev


def loop_pass(loop):
    """Mark the start of one pass of the fixed-trip loop ``loop``
    (``"attempt"``, ``"newton"``) for the entered :func:`pass_marks`
    listener; nothing happens without one."""
    listener = getattr(_passes, "value", None)
    if listener is not None:
        listener(loop)


@contextlib.contextmanager
def debug_capture():
    """Capture this thread's graphs in debug mode, keeping each graph
    beside its executable, for the block, so :meth:`Program.captured`'s
    graph can write itself as a DOT file (``debug_dump``): the contract
    engine reads the kernel nodes."""
    prev = getattr(_debug, "value", False)
    _debug.value = True
    try:
        yield
    finally:
        _debug.value = prev


@contextlib.contextmanager
def recording(recorder):
    """Mirror this thread's :data:`COUNTS` increments onto ``recorder``
    (an ``obs.Recorder``, or None: off) for the block."""
    prev = getattr(_sink, "value", None)
    _sink.value = recorder
    try:
        yield
    finally:
        _sink.value = prev


def add_count(name, k=1):
    """Add ``k`` to :data:`COUNTS` ``[name]`` (and to the recording
    recorder, if any)."""
    with _COUNTS_LOCK:
        COUNTS[name] += k
    rec = getattr(_sink, "value", None)
    if rec is not None:
        rec.counter(RECORDER_NAMES[name], k)


def reset_counts():
    """Set every counter of this module to 0."""
    with _COUNTS_LOCK:
        CAPTURES.clear()
        for k in COUNTS:
            COUNTS[k] = 0


def captures():
    """Graphs captured since the counts were last set to 0."""
    return sum(CAPTURES.values())


def count(name, k=1):
    """Add ``k`` to counter ``name``; inside a capture the count goes to
    the graph's tally instead, and every replay adds it."""
    tally = getattr(_tally, "value", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + k
    else:
        add_count(name, k)


# the watchdog deadline of this thread's host reads (None: off)
_deadline = threading.local()


@contextlib.contextmanager
def fetch_deadline(seconds):
    """Bound every host read of this thread by ``seconds`` for the block
    (``None``: unbounded, the default)."""
    prev = getattr(_deadline, "value", None)
    _deadline.value = seconds
    try:
        yield
    finally:
        _deadline.value = prev


def current_deadline():
    """The deadline :func:`fetch_deadline` set for this thread, or None."""
    return getattr(_deadline, "value", None)


def _guard(x, label):
    seconds = current_deadline()
    if seconds is not None:
        from ..resilience.watchdog import block_with_deadline

        block_with_deadline(x, seconds, getattr(_sink, "value", None),
                            label=label)


def host_any(mask):
    """``bool(mask.any())``, counted as a host sync: the break points of
    the blocking gear's loops."""
    add_count("host_syncs")
    _guard(mask, "host_any")
    return bool(mask.any())


def fetch(*tensors):
    """The tensors as numpy arrays on the host, counted as one host sync
    (the first copy waits for the card; the rest find it idle)."""
    add_count("host_syncs")
    _guard(tensors, "fetch")
    return tuple(t.detach().cpu().numpy() for t in tensors)


def block(tree):
    """Wait until the card has written the tensors of ``tree`` (a tensor
    or a nest of them), counted as one host sync and bounded by this
    thread's deadline; on the CPU there is nothing to wait for."""
    add_count("host_syncs")
    cuda = [x for x in tree_leaves(tree)
            if torch.is_tensor(x) and x.device.type == "cuda"]
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[0].device))
        wait_event(event, "block")


def notify_watches(kind, **info):
    """Report a program build (``kind="trace"``) or a graph capture
    (``"compile"``) to the entered compile watches (``obs/retrace.py``)."""
    from ..obs import retrace

    retrace.dispatch(kind, **info)


def wait_event(event, label="event"):
    """Wait for a recorded CUDA event (not counted: the caller counts the
    read it serves), bounded by this thread's deadline."""
    if current_deadline() is None:
        event.synchronize()
    else:
        _guard(event, label)


def tree_leaves(tree):
    """The tensors of a nest of dicts, tuples and lists, in order (a
    ``None`` entry holds none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of one or more nests of the same structure
    (dict entries matched by key; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _copy_into(dst, src):
    """Copy the nest ``src`` into the buffers ``dst`` in place (same
    structure; a missing entry raises).  A source that shares storage with
    another destination is cloned first, so the order of the copies
    cannot matter."""
    pairs = []
    tree_map(lambda d, s: pairs.append((d, s)), dst, src)
    if len(tree_leaves(src)) != len(pairs):
        raise ValueError("update does not match the buffers' structure")
    ptrs = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s is not d and s.untyped_storage().data_ptr()
              in ptrs else s) for d, s in pairs]
    for d, s in pairs:
        if d is not s:
            d.copy_(s)


class Program:
    """Named steps over one dict of static buffers (``state``).

    A step is ``fn(state) -> updates``: a dict of top-level entries of the
    state and their new values (nests of tensors).  :meth:`run` applies
    one step: on the CPU by calling it and rebinding the entries, on CUDA
    by replaying its graph, which writes the new values into the buffers in
    place (captured at the step's first run).  :meth:`set` loads values
    into the state from outside (host data, a previous program's buffers).
    A step must read device values only through tensor operations: no
    ``.item()``, no Python branch on a tensor, no allocation sized by
    data."""

    def __init__(self, device, steps):
        self.device = torch.device(device)
        self.steps = dict(steps)
        self.state = {}
        self._graphs = {}
        self._tallies = {}
        self._pool = None

    @property
    def on_cuda(self):
        return self.device.type == "cuda"

    def set(self, **parts):
        """Load each named entry: into its buffers on CUDA (allocated, as
        copies, the first time), by rebinding on the CPU."""
        for key, val in parts.items():
            if not self.on_cuda:
                self.state[key] = val
            elif key in self.state:
                _copy_into(self.state[key], val)
            else:
                self.state[key] = tree_map(
                    lambda x: x.detach().clone(), val)

    def run(self, name):
        """Apply step ``name`` to the state."""
        if not self.on_cuda:
            self.state.update(self.steps[name](self.state))
            return
        graph = self._graphs.get(name)
        if graph is None:
            graph = self._capture(name)
        graph.replay()
        add_count("replays")
        tally, launches = self._tallies[name]
        for k, v in tally.items():
            add_count(k, v)
        if launches:
            from . import linalg_cuda

            linalg_cuda.add_launches(launches)

    def captured(self, name):
        """``(graph, tally, lu32p launches by path)`` of step ``name``'s
        capture, or None (not captured: on the CPU, or not run yet)."""
        if name not in self._graphs:
            return None
        return (self._graphs[name],) + self._tallies[name]

    def _capture(self, name):
        """Warm the step up once on a side stream (its output discarded:
        the state does not change), allocate the buffers of entries it
        creates, then capture it writing into the buffers.  Raises if the
        step cannot be captured."""
        from . import linalg_cuda

        t0 = time.perf_counter()
        fn = self.steps[name]
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = fn(self.state)
        torch.cuda.current_stream(dev).wait_stream(side)
        for key, val in warm.items():
            if key not in self.state:
                self.state[key] = tree_map(torch.empty_like, val)
        del warm
        if getattr(_debug, "value", False):
            # keep the cudaGraph_t beside its executable (instantiated at
            # the first replay), so debug_dump can print it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
        else:
            graph = torch.cuda.CUDAGraph()
        tally = {}
        captured = linalg_cuda.captured_by_path()
        captured.update(warp=0, cta=0)
        _tally.value = tally
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = fn(self.state)
                for key, val in out.items():
                    _copy_into(self.state[key], val)
                del out
        finally:
            _tally.value = None
        if self._pool is None:
            self._pool = graph.pool()
        launches = {k: v for k, v in captured.items() if v}
        self._tallies[name] = (tally, launches)
        self._graphs[name] = graph
        with _COUNTS_LOCK:
            CAPTURES[name] = CAPTURES.get(name, 0) + 1
        notify_watches("compile", step=name,
                       seconds=time.perf_counter() - t0)
        return graph


#: the programs kept for reuse, most recently used last
_PROGRAMS = {}
# the mesh runs shards on host threads, one per device, which share the
# cache
_PROGRAMS_LOCK = threading.Lock()
#: how many unpinned programs :func:`program` keeps
MAX_PROGRAMS = 12
#: the owners pinning each cached program (by key): a pinned program
#: stays cached, outside the :data:`MAX_PROGRAMS` count, until every owner
#: has released it
_PINS = {}
# the owner pinning what this thread builds or reuses (None: off)
_pin = threading.local()


@contextlib.contextmanager
def pinned(owner):
    """Pin to ``owner`` every program this thread builds or reuses in the
    block, until :func:`release` (a serving session pins the programs its
    warmup captured, so a ladder of more than :data:`MAX_PROGRAMS` rungs
    serves without a capture)."""
    prev = getattr(_pin, "value", None)
    _pin.value = owner
    try:
        yield
    finally:
        _pin.value = prev


def pinned_programs(owner):
    """How many cached programs ``owner`` pins."""
    with _PROGRAMS_LOCK:
        return sum(1 for owners in _PINS.values() if owner in owners)


def release(owner):
    """Unpin every program ``owner`` pins; a program no owner pins any
    more is discarded (its graphs and buffers go with it)."""
    with _PROGRAMS_LOCK:
        for key in list(_PINS):
            _PINS[key].discard(owner)
            if not _PINS[key]:
                del _PINS[key]
                _PROGRAMS.pop(key, None)


def program(key, build):
    """The cached :class:`Program` for ``key``, or ``build()``'s, kept
    (past :data:`MAX_PROGRAMS` unpinned programs the least recently used
    one is dropped; a pinned one is kept, see :func:`pinned`).  A program
    keeps references to what its steps call, so an identity in ``key``
    (``id(rhs)``) cannot be reused by another object while the program
    lives."""
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.pop(key, None)
        if prog is None:
            prog = build()
            notify_watches("trace", device=prog.device.type)
        _PROGRAMS[key] = prog
        owner = getattr(_pin, "value", None)
        if owner is not None:
            _PINS.setdefault(key, set()).add(owner)
        unpinned = [k for k in _PROGRAMS if k not in _PINS]
        for k in unpinned[:max(0, len(unpinned) - MAX_PROGRAMS)]:
            del _PROGRAMS[k]
        return prog


def discard(prog):
    """Drop ``prog`` from the cache, pinned or not: a run that raised
    mid-window leaves its state in flight, and the next run builds and
    captures afresh instead of replaying it."""
    with _PROGRAMS_LOCK:
        for key in [k for k, v in _PROGRAMS.items() if v is prog]:
            del _PROGRAMS[key]
            _PINS.pop(key, None)


def clear_programs():
    """Drop every cached program (and its graphs), pinned or not."""
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()
        _PINS.clear()
