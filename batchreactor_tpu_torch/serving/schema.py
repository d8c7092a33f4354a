"""Versioned request/response schema of the serving plane.

One request asks the daemon to solve ``k >= 1`` reactor conditions (the
request's *lanes*) to a common horizon under common tolerances — the
programmatic ``batch_reactor_sweep`` tuple ``(T, p, X, t1, rtol/atol)``
as JSON.  Validation follows the ``api.py`` loudness convention: every
malformed field is a specific ``ValueError`` naming the field and the
expected grammar, unknown keys are rejected (a typo'd knob must not be
silently ignored), and the validated form is a frozen :class:`Request`
the scheduler packs from — nothing downstream re-checks.

Request JSON (``POST /solve`` body, or one stdin-JSONL line)::

    {"v": 1,                      # optional; must be 1 when present
     "id": "run-42/7",            # optional; the server assigns one
     "T": 1100.0 | [..k..],       # K       (scalars broadcast over lanes)
     "p": 101325.0 | [..k..],     # Pa      (optional, default 1e5)
     "X": {"H2": 0.3, ...},       # mole fractions, scalar or [..k..]
     "t1": 0.05,                  # s, the integration horizon
     "rtol": 1e-6, "atol": 1e-10, # optional (session defaults); NOTE: a
                                  # non-default pair compiles a new
                                  # program on first use (docs/serving.md)
     "Asv": 1.0,                  # optional surface-coupling parameter
     "n_save": 0,                 # optional; only 0 is accepted — the
                                  # admission gear streams final states,
                                  # not trajectories (loud error)
     "mech": "user-mech-7",       # optional mechanism routing key
                                  # (multi-mechanism store; upload id or
                                  # fingerprint prefix — docs/serving.md)
     "trace": true,               # optional; the ok response gains a
                                  # versioned "trace" section — the
                                  # request-lifecycle stage waterfall
                                  # (obs/trace.py; docs/serving.md).
                                  # Absent/false responses are
                                  # byte-identical to pre-trace ones
     "trace_ctx": {"v": 1,        # optional distributed-trace envelope
                   "trace": "t-7",#   (docs/observability.md "Fleet
                   "span": "r:1", #   tracing"): trace id + parent span
                   "hop": 1},     #   + hop count.  Generated by the
                                  #   client/bench, minted+forwarded by
                                  #   the fleet router; the daemon's
                                  #   RequestTrace adopts it so its
                                  #   stages become child spans of ONE
                                  #   fleet trace.  Telemetry identity
                                  #   only: never routes, packs, or
                                  #   shapes the response — absent-ctx
                                  #   requests stay byte-identical
     "energy": "adiabatic_v"}     # optional non-isothermal mode
                                  # (docs/energy.md: adiabatic_v /
                                  # adiabatic_p; the session spec must
                                  # list it in solver.energy_modes —
                                  # energy lanes answer with per-lane
                                  # "T" and "ignition_delay")

Responses are ``{"v": 1, "id": ..., "status": "ok" | "error", ...}``:
``ok`` carries per-lane ``t`` / ``solver_status`` / ``provenance`` /
final mole fractions ``x`` (+ ``tau`` when the session runs an ignition
observer, solver counter ``stats`` when it runs instrumented, and the
``trace`` stage waterfall when the request asked for it);
``error`` carries ``{"code", "message"}`` with the codes ``invalid``
(schema/species rejection), ``overloaded`` (admission-control
backpressure — the queue bound is a promise, never silent queueing),
``draining`` (SIGTERM received; in-flight work still answers), and
``internal`` (the stream died under the request).  Nothing here imports
torch — the schema is shared by the client, the jsonl front-end, and the
scheduler tests.
"""

import dataclasses

import numpy as np

SCHEMA_VERSION = 1

#: the only keys a request may carry (anything else is a loud error)
_REQUEST_KEYS = ("v", "id", "T", "p", "X", "t1", "rtol", "atol", "Asv",
                 "n_save", "mech", "energy", "trace", "trace_ctx")

#: the versioned distributed-trace envelope (docs/observability.md
#: "Fleet tracing"): bump on any layout change
TRACE_CTX_VERSION = 1

#: the only keys a ``trace_ctx`` envelope may carry
_TRACE_CTX_KEYS = ("v", "trace", "span", "hop")

#: the non-None energy-mode literals (energy/eqns.py ENERGY_MODES,
#: duplicated here because the schema imports no torch-reaching module —
#: tests pin the two tuples equal)
ENERGY_MODES = ("adiabatic_v", "adiabatic_p")

#: error codes a response may carry
ERROR_CODES = ("invalid", "overloaded", "draining", "internal",
               "unknown_mechanism")

#: the only keys a mechanism upload may carry (POST /mechanism body —
#: docs/serving.md "Mechanism upload"); ``mech``/``therm`` are the
#: INLINE file texts (CHEMKIN-II / NASA-7), not paths: the daemon owns
#: no shared filesystem with its clients
_UPLOAD_KEYS = ("v", "id", "mech", "therm", "warm")


@dataclasses.dataclass(frozen=True)
class Request:
    """A validated solve request: per-lane condition arrays (all
    broadcast to ``n_lanes``) plus the scalar pack key ``(t1, rtol,
    atol)`` the scheduler coalesces on."""

    id: str
    T: np.ndarray          # (k,) float64, K
    p: np.ndarray          # (k,) float64, Pa
    Asv: np.ndarray        # (k,) float64
    X: dict                # {species: (k,) float64}
    t1: float
    rtol: float
    atol: float
    #: mechanism routing key (multi-mechanism store — docs/serving.md):
    #: an upload id or fingerprint prefix; None = the session default.
    #: Routing happens BEFORE scheduling (each mechanism owns its own
    #: scheduler), so it is not part of pack_key.
    mech: str | None = None
    #: non-isothermal reactor mode (docs/energy.md): None = isothermal,
    #: else an :data:`ENERGY_MODES` literal.  Part of pack_key — an
    #: energy lane carries the trailing T state row, so it can never
    #: share a resident program with isothermal lanes.
    energy: str | None = None
    #: request-lifecycle trace export (obs/trace.py): True adds the
    #: versioned ``"trace"`` stage-waterfall section to the ok
    #: response.  Pure response shaping — never part of pack_key, and
    #: the server-side capture runs either way (the histograms are
    #: always-on); False/absent responses are byte-identical to
    #: pre-trace ones.
    trace: bool = False
    #: inherited distributed-trace context (docs/observability.md
    #: "Fleet tracing"): the normalized ``(trace_id, parent_span,
    #: hop)`` tuple of the request's ``trace_ctx`` envelope, or None.
    #: Pure telemetry identity — never part of pack_key, never shapes
    #: the response; the scheduler's RequestTrace adopts it so this
    #: daemon's stage marks become child spans of the fleet trace.
    #: Absent-ctx requests stay byte-identical in response.
    trace_ctx: tuple | None = None

    @property
    def n_lanes(self):
        return int(self.T.shape[0])

    def pack_key(self):
        """Requests sharing this key can ride one resident stream: t1
        is a traced operand of the shared program, rtol/atol/energy are
        static (a distinct combination is a distinct compiled
        program — the energy state is one row wider)."""
        return (self.t1, self.rtol, self.atol, self.energy)


def _as_lane_array(name, value, rid):
    """One condition field -> (k,) float64 (k=1 for scalars), loudly."""
    try:
        arr = np.asarray(value, dtype=np.float64)
    except (TypeError, ValueError):
        raise ValueError(
            f"request {rid!r}: {name} must be a number or a flat list "
            f"of numbers; got {value!r}") from None
    if arr.ndim > 1:
        raise ValueError(
            f"request {rid!r}: {name} must be a number or a FLAT list; "
            f"got shape {arr.shape}")
    arr = np.atleast_1d(arr)
    if arr.size == 0:
        raise ValueError(f"request {rid!r}: {name} must not be empty")
    if not np.all(np.isfinite(arr)):
        raise ValueError(
            f"request {rid!r}: {name} must be finite; got {value!r}")
    return arr


def _positive_scalar(name, value, rid):
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"request {rid!r}: {name} must be a number; "
                         f"got {value!r}") from None
    if not np.isfinite(v) or v <= 0:
        raise ValueError(f"request {rid!r}: {name} must be a finite "
                         f"positive number; got {value!r}")
    return v


def validate_trace_ctx(obj, rid=None):
    """Validate one ``trace_ctx`` envelope (module doc grammar) into
    the normalized ``(trace_id, parent_span, hop)`` tuple, or ``None``
    for an absent envelope.  Every rejection is a specific
    ``ValueError`` naming the field — the ``validate_request`` loudness
    convention, shared by the member schema path and the fleet
    router's minting path::

        {"v": 1,              # optional; must be 1 when present
         "trace": "t-run-42", # required: the fleet-wide trace id
         "span": "client",    # optional parent span id (None = root)
         "hop": 0}            # optional forward count, int >= 0
    """
    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise ValueError(
            f"request {rid!r}: trace_ctx must be a JSON object "
            f"{{trace, span, hop}}; got {type(obj).__name__}")
    unknown = sorted(set(obj) - set(_TRACE_CTX_KEYS))
    if unknown:
        raise ValueError(
            f"request {rid!r}: unknown trace_ctx key(s) {unknown}; "
            f"known keys: {list(_TRACE_CTX_KEYS)}")
    v = obj.get("v", TRACE_CTX_VERSION)
    if v != TRACE_CTX_VERSION:
        raise ValueError(
            f"request {rid!r}: unsupported trace_ctx version {v!r} "
            f"(this server speaks v{TRACE_CTX_VERSION})")
    trace = obj.get("trace")
    if not isinstance(trace, str) or not trace:
        raise ValueError(
            f"request {rid!r}: trace_ctx.trace must be a non-empty "
            f"trace-id string; got {trace!r}")
    span = obj.get("span")
    if span is not None and (not isinstance(span, str) or not span):
        raise ValueError(
            f"request {rid!r}: trace_ctx.span must be a non-empty "
            f"parent-span-id string (or absent); got {span!r}")
    hop = obj.get("hop", 0)
    if not isinstance(hop, int) or isinstance(hop, bool) or hop < 0:
        raise ValueError(
            f"request {rid!r}: trace_ctx.hop must be an integer >= 0 "
            f"(forward count); got {hop!r}")
    return (trace, span, hop)


def trace_ctx_payload(trace_id, span=None, hop=0):
    """The wire form of one trace context — the inverse of
    :func:`validate_trace_ctx`, used by the client, the bench, and the
    router's mint/forward path so every producer emits one shape."""
    ctx = {"v": TRACE_CTX_VERSION, "trace": str(trace_id)}
    if span is not None:
        ctx["span"] = str(span)
    if hop:
        ctx["hop"] = int(hop)
    return ctx


def validate_request(obj, *, species=None, rtol_default=1e-6,
                     atol_default=1e-10, default_id=None,
                     max_lanes=None, energy_modes=()):
    """Validate one request JSON object into a :class:`Request` (module
    doc grammar); every rejection is a ``ValueError`` naming the field.

    ``species`` (the session's gas species tuple) makes unknown ``X``
    keys a validation error here instead of a failure deep in lane
    packing; ``max_lanes`` bounds one request's lane count (a request
    larger than the whole admission queue could never be accepted);
    ``energy_modes`` is the tuple of non-isothermal modes THIS session
    warmed (``SessionSpec.energy_modes``) — a request asking for an
    un-warmed mode rejects here, before anything queues.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"request must be a JSON object; got "
                         f"{type(obj).__name__}")
    unknown = sorted(set(obj) - set(_REQUEST_KEYS))
    if unknown:
        raise ValueError(f"unknown request key(s) {unknown}; known keys: "
                         f"{list(_REQUEST_KEYS)}")
    v = obj.get("v", SCHEMA_VERSION)
    if v != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {v!r} (this server "
                         f"speaks v{SCHEMA_VERSION})")
    rid = obj.get("id", default_id)
    if rid is None:
        raise ValueError("request needs an 'id' (or the caller must "
                         "supply default_id)")
    rid = str(rid)

    for key in ("T", "X", "t1"):
        if key not in obj:
            raise ValueError(f"request {rid!r}: missing required key "
                             f"{key!r}")
    T = _as_lane_array("T", obj["T"], rid)
    if np.any(T <= 0):
        raise ValueError(f"request {rid!r}: T must be positive Kelvin")
    p = _as_lane_array("p", obj.get("p", 1e5), rid)
    if np.any(p <= 0):
        raise ValueError(f"request {rid!r}: p must be positive Pa")
    Asv = _as_lane_array("Asv", obj.get("Asv", 1.0), rid)

    X_in = obj["X"]
    if not isinstance(X_in, dict) or not X_in:
        raise ValueError(f"request {rid!r}: X must be a non-empty "
                         f"{{species: fraction}} object")
    X = {}
    for name, val in X_in.items():
        arr = _as_lane_array(f"X[{name}]", val, rid)
        if np.any(arr < 0):
            raise ValueError(f"request {rid!r}: X[{name}] must be "
                             f"non-negative mole fractions")
        X[str(name)] = arr
    if species is not None:
        idx = {s.upper() for s in species}
        missing = sorted(n for n in X if n.upper() not in idx)
        if missing:
            raise ValueError(
                f"request {rid!r}: composition species {missing} not in "
                f"the session mechanism (species: {list(species)[:6]}...)")

    # lanes = broadcast of every per-lane field; mismatched non-1
    # lengths are a packing ambiguity, not a broadcast
    lengths = {int(a.shape[0])
               for a in (T, p, Asv, *X.values()) if a.shape[0] != 1}
    if len(lengths) > 1:
        raise ValueError(
            f"request {rid!r}: per-lane fields disagree on lane count "
            f"{sorted(lengths)}; scalars broadcast, lists must match")
    k = lengths.pop() if lengths else 1
    if max_lanes is not None and k > int(max_lanes):
        raise ValueError(
            f"request {rid!r}: {k} lanes exceeds the per-request bound "
            f"{int(max_lanes)}; split the request")

    t1 = _positive_scalar("t1", obj["t1"], rid)
    rtol = _positive_scalar("rtol", obj.get("rtol", rtol_default), rid)
    atol = _positive_scalar("atol", obj.get("atol", atol_default), rid)
    n_save = obj.get("n_save", 0)
    if n_save not in (0, None):
        raise ValueError(
            f"request {rid!r}: n_save={n_save!r} is not supported — the "
            f"streaming admission gear returns final states only "
            f"(n_save=0); run a trajectory solve through batch_reactor")

    mech = obj.get("mech")
    if mech is not None and (not isinstance(mech, str) or not mech):
        raise ValueError(
            f"request {rid!r}: mech must be a non-empty mechanism id "
            f"string; got {mech!r}")

    trace = obj.get("trace", False)
    if not isinstance(trace, bool):
        raise ValueError(
            f"request {rid!r}: trace must be a JSON boolean; got "
            f"{trace!r} (true = add the stage-waterfall section to "
            f"the response)")

    trace_ctx = validate_trace_ctx(obj.get("trace_ctx"), rid)

    energy = obj.get("energy")
    if energy is not None:
        if energy not in ENERGY_MODES:
            # name the accepted literals (the api.py loudness
            # convention — a typo'd mode must say what IS accepted)
            raise ValueError(
                f"request {rid!r}: unknown energy mode {energy!r}; "
                f"accepted: {list(ENERGY_MODES)} (omit the key for an "
                f"isothermal solve)")
        if tuple(energy_modes or ()) and energy not in energy_modes:
            raise ValueError(
                f"request {rid!r}: energy mode {energy!r} is not "
                f"enabled on this session (warmed modes: "
                f"{list(energy_modes)}); add it to the session spec's "
                f"solver.energy_modes")
        if not energy_modes:
            raise ValueError(
                f"request {rid!r}: energy mode {energy!r} is not "
                f"enabled on this session (no solver.energy_modes in "
                f"the session spec)")
        if "Asv" in obj and np.any(Asv != 1.0):
            # incompatible-knob rejection (the n_save convention below):
            # Asv couples surface chemistry, energy mode is gas-only
            # adiabatic — a silently ignored Asv would report physics
            # that never ran
            raise ValueError(
                f"request {rid!r}: Asv is a surface-coupling parameter; "
                f"energy={energy!r} runs gas-only adiabatic chemistry — "
                f"drop Asv or the energy key")

    bcast = (lambda a: np.broadcast_to(a, (k,)).copy()
             if a.shape[0] == 1 else a)
    X = {n: bcast(a) for n, a in X.items()}
    # every lane needs a positive total: a zero-sum composition would
    # make the initial state 0/0 = NaN (mole_to_mass normalizes by the
    # mixture mass) — the lane would burn its whole device budget and
    # answer NaNs, which bare-JSON serializers reject
    total = sum(X.values())
    if np.any(total <= 0):
        bad = int(np.argmax(total <= 0))
        raise ValueError(
            f"request {rid!r}: lane {bad} composition sums to "
            f"{float(total[bad])!r}; mole fractions must sum > 0 on "
            f"every lane")
    return Request(id=rid, T=bcast(T), p=bcast(p), Asv=bcast(Asv),
                   X=X, t1=t1, rtol=rtol, atol=atol, mech=mech,
                   energy=energy, trace=trace, trace_ctx=trace_ctx)


def validate_upload(obj, *, default_id=None):
    """Validate one mechanism-upload JSON object (``POST /mechanism``;
    grammar: docs/serving.md "Mechanism upload") into a plain dict
    ``{"id", "mech", "therm", "warm"}`` — the ``api.py`` loudness
    convention: unknown keys reject, every malformed field is a specific
    ``ValueError``.  ``mech``/``therm`` are inline CHEMKIN-II / NASA-7
    texts; parsing errors surface later, from the store's compile, as
    ``invalid`` responses naming the parser's complaint."""
    if not isinstance(obj, dict):
        raise ValueError(f"mechanism upload must be a JSON object; got "
                         f"{type(obj).__name__}")
    unknown = sorted(set(obj) - set(_UPLOAD_KEYS))
    if unknown:
        raise ValueError(f"unknown upload key(s) {unknown}; known keys: "
                         f"{list(_UPLOAD_KEYS)}")
    v = obj.get("v", SCHEMA_VERSION)
    if v != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {v!r} (this server "
                         f"speaks v{SCHEMA_VERSION})")
    uid = obj.get("id", default_id)
    if uid is None or not isinstance(uid, str) or not uid:
        raise ValueError("mechanism upload needs a non-empty string 'id' "
                         "(the mech routing key of later solve requests)")
    for key in ("mech", "therm"):
        text = obj.get(key)
        if not isinstance(text, str) or not text.strip():
            raise ValueError(
                f"upload {uid!r}: {key!r} must be the non-empty inline "
                f"file text ({'CHEMKIN-II mechanism' if key == 'mech' else 'NASA-7 thermo database'})")
    warm = obj.get("warm", True)
    if not isinstance(warm, bool):
        raise ValueError(f"upload {uid!r}: warm must be a boolean; got "
                         f"{warm!r}")
    return {"id": uid, "mech": obj["mech"], "therm": obj["therm"],
            "warm": warm}


def error_response(rid, code, message):
    """An ``error`` response object (module doc)."""
    if code not in ERROR_CODES:
        raise ValueError(f"unknown error code {code!r}; known: "
                         f"{ERROR_CODES}")
    return {"v": SCHEMA_VERSION, "id": rid, "status": "error",
            "error": {"code": code, "message": str(message)}}


def ok_response(rid, payload):
    """An ``ok`` response object around a per-lane result payload."""
    return {"v": SCHEMA_VERSION, "id": rid, "status": "ok", **payload}
