"""brcost tier D of the port: the static cost and memory model of the step
programs, and the closed-form rung estimate.

The counterpart of ``batchreactor_tpu/analysis/costmodel.py``.  The JAX
module walks jaxprs; the port's unit of device work is a step program
(``solver/graphs.py``), which the contract engine records as an op log
(:class:`~.contracts.Recording`: one row per aten op, with its dtypes,
shapes and devices, and a residency track beside it).  So:

* :func:`cost_program` walks a recording's op rows with per-op rules, as
  the JAX ``_walk`` does per primitive, and returns a :class:`Cost`:
  FLOPs, transcendentals, bytes moved and peak live-buffer residency per
  program.  Elementwise ops cost one flop per output element (``div``,
  ``sqrt``, ``rsqrt`` and ``reciprocal`` four, ``pow`` with an integer
  exponent three); transcendentals :data:`TRANSCENDENTAL_WEIGHT`, and are
  also counted on their own; reductions one per input element; ``mm``/
  ``bmm`` 2·M·N·K; triangular solves n²·k per lane (``linalg_lu_solve``
  two of them); gathers, copies and fills move bytes only; views and
  ``expand`` cost nothing.  The factor is charged by its work, not by how
  it runs: ``brtorch::lu32p_factor`` and ``aten::linalg_lu_factor_ex`` both
  cost 2/3·n³ flops per lane, M read once and LU and pivots written once.
  So are the gas production rates: ``brtorch::gas_wdot`` (the card's one
  kernel) costs the FLOPs and transcendentals of its plain version's op
  log at the same shapes (:func:`gas_wdot_work`), its operands read once
  and wdot written once.
* :func:`estimate_rung` is the JAX module's stdlib closed form, with its
  formulas and result keys, but for the card: :data:`HBM_BYTES` (the
  H100's 80 GiB) in place of the v5e's 16 GiB, and ``smem_bytes`` (the
  ``lu32p`` kernel's dynamic shared memory per CTA,
  :func:`lu32p_smem_bytes`) in place of ``vmem_bytes``.
* :func:`contract_cost_table` costs every recorded obligation of the
  port's contract registry (:mod:`.census`).

Renamed against the JAX module: ``cost_jaxpr`` is :func:`cost_program`,
``lu32p_vmem_bytes`` is :func:`lu32p_smem_bytes`, ``Cost.vmem_bytes`` is
``Cost.smem_bytes``, ``VMEM_BUDGET_BYTES`` is :data:`SMEM_BUDGET_BYTES`
and ``V5E_HBM_BYTES`` is :data:`HBM_BYTES`.

Conventions, and where the walk differs from the JAX one on purpose:

* **One attempt with one Newton iteration.**  JAX counts every
  ``while`` body once (``while_trip=1``).  A captured ``window`` step runs
  every attempt of its Jacobian window and ``max_newton`` Newton
  iterations per attempt, with no exit.  Each pass of those loops starts
  with ``solver.graphs.loop_pass``, which the op log marks; the walk folds
  a loop's identical passes into one (Newton iterations first, then the
  window's attempts), so a step program costs one attempt with one Newton
  iteration, as in the JAX table.  ``n_while`` counts the loops folded.
  A loop whose passes differ is not folded.
* **One pass on the card.**  There the recorder runs during the capture's
  warm-up and again during the capture; only the captured pass is costed.
  Its copies of the outputs into the program's buffers move bytes and
  cost no flops, so FLOPs and transcendentals equal the CPU walk's.
* **Residency.**  A step's inputs (the program's buffers, the mechanism's
  tensors: every storage the step reads and did not allocate) live for
  the whole step; intermediates are freed at last use and a step's
  outputs live to its end (the JAX convention).  A program's peak is its
  largest step's.  Storages are counted whole, views at zero.
* **Bytes are not a parity quantity.**  Eager aten materialises every
  intermediate that XLA fuses away, so ``bytes_moved`` and ``peak_bytes``
  run above the JAX walk's; FLOPs and transcendentals are comparable.
* ``n_scan`` stays 0 (no step holds a scan); ``n_pallas`` counts the
  ported Pallas kernel's operator, ``brtorch::lu32p_factor``.

The closed form and the constants import nothing but the standard library
(``brcost --ladder`` needs no torch); :func:`lu32p_smem_bytes` reads
``solver/linalg_cuda.py::launch_config`` when it is called.
"""

import dataclasses
import math

#: flops charged per transcendental element (exp/log/pow...), as in the
#: JAX model; also tallied separately in ``Cost.transcendentals``
TRANSCENDENTAL_WEIGHT = 8

#: the dynamic shared memory one block may opt into on the H100 (227 KiB,
#: ``solver/linalg_cuda.py::_SMEM_LIMIT``): the ceiling of the ``lu32p``
#: kernel's per-CTA footprint
SMEM_BUDGET_BYTES = 232_448

#: the H100's device memory (80 GiB): the ladder's go/no-go
HBM_BYTES = 80 * 2 ** 30

# solver/bdf.py history block: MAXORD + 3 rows of state per lane
BDF_MAXORD = 5
BDF_HIST_ROWS = BDF_MAXORD + 3

# the lu32p padding granule (solver/linalg_cuda.py _BLOCK)
LU32P_BLOCK = 8

#: the largest padded order the lu32p kernel takes (linalg_cuda
#: CTA_NPAD_MAX); past it no kernel launches
LU32P_NPAD_MAX = 240

#: the linear-algebra modes whose factor is the lu32p kernel
_KERNEL_MODES = ("lu32p", "inv32", "inv32nr", "inv32f")

_ITEMSIZE = {"torch.float64": 8, "torch.float32": 4, "torch.float16": 2,
             "torch.bfloat16": 2, "torch.int64": 8, "torch.int32": 4,
             "torch.int16": 2, "torch.int8": 1, "torch.uint8": 1,
             "torch.bool": 1, "torch.complex128": 16,
             "torch.complex64": 8}

# views and metadata: no flops, no bytes
_VIEWS = {
    "view", "_unsafe_view", "alias", "expand", "expand_as", "permute",
    "transpose", "t", "unsqueeze", "squeeze", "select", "slice",
    "as_strided", "detach", "lift_fresh", "_has_same_storage_numel",
    "is_same_size", "unbind", "split", "split_with_sizes", "reshape",
    "_reshape_alias", "flatten", "unflatten", "diagonal", "narrow",
    "movedim", "view_as", "sym_size", "sym_stride", "sym_numel",
}
_ELEMWISE = {
    "add", "sub", "rsub", "mul", "neg", "abs", "sign", "sgn", "floor",
    "ceil", "round", "trunc", "clamp", "clamp_min", "clamp_max", "maximum",
    "minimum", "fmax", "fmin", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "isfinite", "isnan", "isinf", "square", "remainder", "fmod",
    "masked_fill", "__and__", "__or__", "__xor__", "__invert__",
}
_ELEMWISE_WEIGHTED = {"div": 4, "sqrt": 4, "rsqrt": 4, "reciprocal": 4}
#: ``pow`` with an integer exponent (JAX's ``integer_pow``)
_INTEGER_POW = 3
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "pow",
    "tanh", "sinh", "cosh", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "sigmoid", "erf", "erfc", "erfinv", "lgamma", "digamma",
    "xlogy",
}
_REDUCTION = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax",
    "argmin", "all", "any", "cumsum", "cumprod", "cummax", "cummin",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "nansum",
    "count_nonzero",
}
# reductions whose two-tensor overload is elementwise (max.other)
_BINARY_OVERLOADS = {"other"}
_MATMUL = {"mm": 0, "bmm": 0, "matmul": 0, "mv": 0, "dot": 0,
           "addmm": 1, "baddbmm": 1, "addmv": 1, "addbmm": 1}
_FACTOR = {"lu32p_factor", "linalg_lu_factor_ex", "linalg_lu_factor",
           "lu_factor", "linalg_lu"}
# (solves per right-hand side, index of the matrix, index of the rhs)
_TRISOLVE = {"linalg_solve_triangular": (1, 0, 1),
             "triangular_solve": (1, 1, 0),
             "linalg_lu_solve": (2, 0, 2), "lu_solve": (2, 0, 2)}
_SCATTER_COMBINE = {"scatter_add", "index_add", "scatter_reduce",
                    "index_reduce"}
# pure data movement: bytes only
_MOVEMENT = {
    "clone", "copy", "_to_copy", "to", "contiguous", "cat", "stack",
    "flip", "roll", "repeat", "zeros", "ones", "full", "empty",
    "empty_like", "empty_strided", "eye", "arange", "linspace",
    "scalar_tensor", "zeros_like", "ones_like", "full_like", "new_zeros",
    "new_ones", "new_full", "new_empty", "_efficientzerotensor", "fill",
    "index_put", "_index_put_impl", "scatter", "gather", "index",
    "index_select", "take", "take_along_dim", "constant_pad_nd", "pad",
    "tril", "triu", "lift_fresh_copy", "_local_scalar_dense",
    "_new_zeros_with_same_feature_meta", "masked_scatter", "bernoulli",
}


@dataclasses.dataclass
class Cost:
    """One program's static cost: floating-point work, memory traffic and
    residency.  ``flops`` includes the weighted transcendentals;
    ``transcendentals`` counts their elements separately.  ``peak_bytes``
    is the live-buffer high-water mark; ``smem_bytes`` the largest
    ``lu32p`` per-CTA shared-memory footprint seen (0 without the
    kernel); ``n_while`` the fixed-trip loops folded to one pass;
    ``n_scan`` stays 0; ``n_pallas`` the ported kernel's launches."""

    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_moved: float = 0.0
    peak_bytes: int = 0
    smem_bytes: int = 0
    n_while: int = 0
    n_scan: int = 0
    n_pallas: int = 0
    by_prim: dict = dataclasses.field(default_factory=dict)

    def _tally(self, prim, flops, count=1):
        c, f = self.by_prim.get(prim, (0, 0.0))
        self.by_prim[prim] = (c + count, f + flops)

    def add_scaled(self, other, k=1):
        """Fold ``other`` in at multiplicity ``k`` (work and traffic
        scale; residency and shared memory take the max)."""
        self.flops += k * other.flops
        self.transcendentals += k * other.transcendentals
        self.bytes_moved += k * other.bytes_moved
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        self.smem_bytes = max(self.smem_bytes, other.smem_bytes)
        self.n_while += other.n_while
        self.n_scan += other.n_scan
        self.n_pallas += other.n_pallas
        for prim, (c, f) in other.by_prim.items():
            self._tally(prim, k * f, k * c)
        return self

    def as_dict(self, top=8):
        """JSON-ready summary; ``by_prim`` keeps the ``top`` heaviest ops
        by flops."""
        heavy = sorted(self.by_prim.items(), key=lambda kv: -kv[1][1])
        return {
            "flops": round(self.flops, 1),
            "transcendentals": round(self.transcendentals, 1),
            "bytes_moved": round(self.bytes_moved, 1),
            "peak_bytes": int(self.peak_bytes),
            "smem_bytes": int(self.smem_bytes),
            "n_while": self.n_while,
            "n_scan": self.n_scan,
            "n_pallas": self.n_pallas,
            "by_prim": {p: {"count": round(c, 1), "flops": round(f, 1)}
                        for p, (c, f) in heavy[:top]},
        }


# --------------------------------------------------------------------------
# the op-log walker
# --------------------------------------------------------------------------
def _op_name(name):
    """``("mul", "Tensor")`` of ``"aten.mul_.Tensor"`` (in-place suffix
    dropped), ``("lu32p_factor", "default")`` of the kernel's operator."""
    parts = name.split(".")
    base = parts[1] if len(parts) > 1 else parts[0]
    if base.endswith("_") and not base.startswith("_"):
        base = base[:-1]
    return base, parts[2] if len(parts) > 2 else "default"


def _elems(shape):
    return int(math.prod(shape))


def _bytes(dtypes, shapes):
    return sum(_elems(s) * _ITEMSIZE.get(d, 8)
               for d, s in zip(dtypes, shapes))


def _lanes_order(shape):
    """(batch, n) of a (..., n, n) matrix operand."""
    n = int(shape[-1]) if shape else 1
    return (_elems(shape[:-2]) if len(shape) > 2 else 1), n


def _op_cost(row, scalars):
    """``(base, flops, transcendentals, bytes)`` of one op row."""
    name, in_dt, in_sh, _dev, out_dt, out_sh = row[:6]
    base, overload = _op_name(name)
    if base in _VIEWS:
        return base, 0.0, 0.0, 0.0
    out_elems = sum(_elems(s) for s in out_sh)
    moved = float(_bytes(in_dt, in_sh) + _bytes(out_dt, out_sh))
    flops = trans = 0.0
    if base in _FACTOR:
        batch, n = _lanes_order(in_sh[0])
        flops = batch * (2.0 / 3.0) * n ** 3
    elif base == "gas_wdot":
        flops, trans = gas_wdot_work(in_sh, scalars)
    elif base in _TRISOLVE:
        k_solves, i_mat, i_rhs = _TRISOLVE[base]
        batch, n = _lanes_order(in_sh[i_mat])
        rhs = in_sh[i_rhs] if i_rhs < len(in_sh) else (n, 1)
        flops = k_solves * batch * float(n * n * (rhs[-1] if rhs else 1))
    elif base in _MATMUL:
        a = in_sh[_MATMUL[base]]
        flops = 2.0 * out_elems * (a[-1] if a else 1)
        if _MATMUL[base]:
            flops += out_elems        # the added term
    elif base == "pow" and overload == "Tensor_Scalar" and any(
            isinstance(x, int) and not isinstance(x, bool)
            for x in scalars):
        flops = float(_INTEGER_POW * out_elems)
    elif base in _TRANSCENDENTAL:
        trans = float(out_elems)
        flops = float(TRANSCENDENTAL_WEIGHT * out_elems)
    elif base in _ELEMWISE_WEIGHTED:
        flops = float(_ELEMWISE_WEIGHTED[base] * out_elems)
    elif base in _ELEMWISE or (base in _REDUCTION
                               and overload in _BINARY_OVERLOADS):
        flops = float(out_elems)
    elif base in _REDUCTION:
        flops = float(_elems(in_sh[0]) if in_sh else out_elems)
    elif base in _SCATTER_COMBINE:
        flops = float(_elems(in_sh[-1]) if in_sh else out_elems)
    elif base in ("index_put", "_index_put_impl") and any(
            x is True for x in scalars):
        flops = float(_elems(in_sh[-1]) if in_sh else out_elems)
    elif base in _MOVEMENT:
        pass
    else:
        # unknown op: an elementwise floor, tallied under its name so a
        # new heavy op cannot hide at zero cost
        flops = float(out_elems)
    return base, flops, trans, moved


# (B, S, R, kf, kr, kc_compat, falloff_compat, exp32) -> (flops, trans)
_GAS_WDOT_WORK = {}


def gas_wdot_work(in_shapes, scalars):
    """(FLOPs, transcendentals) of one ``brtorch::gas_wdot`` row: those of
    the plain version (``ops/gas_kinetics.py::production_rates_plain``) at
    the row's shapes and options, which the CPU walks in its place.  The
    plain version's op log follows its shapes alone: (B,) T and (B, S)
    concentrations, R reactions, the widths kf and kr of the stoichiometry
    lists (the operator's packed ``f_idx``/``r_idx``), and the three
    options; it is recorded once per such key on a zero mechanism."""
    from ..ops import gas_rates_cuda as gr

    n_par = len(gr.MECH_FIELDS) + len(gr.THERMO_FIELDS)
    (B, S), f_idx = in_shapes[1], in_shapes[2 + n_par + 1]
    r_idx = in_shapes[2 + n_par + 3]
    R_, kf, kr = f_idx[0], f_idx[1], r_idx[1]
    kc, fc, x32 = (bool(x) for x in tuple(scalars)[:3])
    key = (B, S, R_, kf, kr, kc, fc, x32)
    if key not in _GAS_WDOT_WORK:
        _GAS_WDOT_WORK[key] = _plain_gas_work(*key)
    return _GAS_WDOT_WORK[key]


def _plain_gas_work(B, S, R_, kf, kr, kc, fc, x32):
    from .contracts import plain_gas_rows

    flops = trans = 0.0
    for row, sc in plain_gas_rows(B, S, R_, kf, kr, kc, fc, x32):
        _, f, t, _ = _op_cost(row, sc)
        flops, trans = flops + f, trans + t
    return flops, trans


def _fold(rows, idx, marks):
    """The row indices ``idx`` (one step's costed pass) with every
    fixed-trip loop's repeated passes dropped, and the number of loops
    folded.  ``marks`` are ``(position in idx, loop)``; a run of marks of
    one loop whose blocks (mark to next mark) are identical op sequences,
    the last pass the same length again, keeps its first pass only."""

    def key(i):
        r = rows[i]
        return r[:3] + r[4:6]

    folded = 0
    for loop in ("newton", "attempt"):
        pos = [p for p, lp in marks if lp == loop]
        drop = set()
        i = 0
        while i < len(pos) - 1:
            step = pos[i + 1] - pos[i]
            block = [key(idx[k]) for k in range(pos[i], pos[i + 1])]

            def same(p):
                return p + step <= len(idx) and all(
                    key(idx[p + k]) == block[k] for k in range(step))

            j = i + 1
            while j + 1 < len(pos) and pos[j + 1] - pos[j] == step \
                    and same(pos[j]):
                j += 1
            if same(pos[j]):
                drop.update(range(pos[i] + step, pos[j] + step))
                folded += 1
                i = j + 1
            else:
                i += 1
        if drop:
            kept = [k for k in range(len(idx)) if k not in drop]
            new_pos = {old: new for new, old in enumerate(kept)}
            idx = [idx[k] for k in kept]
            marks = [(new_pos[p], lp) for p, lp in marks
                     if lp != loop and p in new_pos]
        else:
            marks = [(p, lp) for p, lp in marks if lp != loop]
    return idx, folded


def _step_passes(rec):
    """``[(row indices, pass marks, output storage ids)]`` per step of a
    recording: the rows from the step's mark to its outputs' mark, on the
    card only those recorded inside the capture (when it captured)."""
    track = rec.track
    marks = track.get("marks", ())
    capturing = track.get("capturing", ())
    starts = [m for m in marks if m[1] == "step"]
    ends = [m for m in marks if m[1] == "outputs"]
    if not starts:     # a recording made without marks: one whole step
        return [(list(range(len(rec.ops))), [], ())]
    out = []
    for k, (lo, _kind, _name, _cap, _ids) in enumerate(starts):
        hi = ends[k][0] if k < len(ends) else len(rec.ops)
        idx = list(range(lo, hi))
        if rec.captured and any(capturing[i] for i in idx):
            idx = [i for i in idx if capturing[i]]
            passes = [m for m in marks if m[1] == "pass"
                      and lo <= m[0] <= hi and m[3]]
        else:
            passes = [m for m in marks if m[1] == "pass"
                      and lo <= m[0] <= hi and not m[3]]
        where = {i: p for p, i in enumerate(idx)}
        pmarks = []
        for m in passes:
            # a mark sits before the next row recorded in the same pass
            nxt = next((i for i in idx if i >= m[0]), None)
            if nxt is not None:
                pmarks.append((where[nxt], m[2]))
        out.append((idx, pmarks, ends[k][4] if k < len(ends) else ()))
    return out


def _residency(rec, idx, outputs):
    """Peak live bytes over one step's rows ``idx``: storages read and not
    allocated there live throughout; the others from the op that allocates
    them to their last use (the step's outputs to its end)."""
    ins, outs = rec.track.get("ins", ()), rec.track.get("outs", ())
    if not ins:
        return 0
    made, size, last = {}, {}, {}
    for pos, i in enumerate(idx):
        for sid, b, fresh in outs[i]:
            if fresh and sid not in made:
                made[sid] = pos
            size.setdefault(sid, b)
            last[sid] = pos
        for sid, b in ins[i]:
            size.setdefault(sid, b)
            last[sid] = pos
    end = len(idx)
    for sid in outputs:
        if sid in made:
            last[sid] = end
    cur = sum(b for sid, b in size.items() if sid not in made)
    peak = cur
    born = {}
    for sid, pos in made.items():
        born.setdefault(pos, []).append(sid)
    dies = {}
    for sid in made:
        dies.setdefault(last[sid], []).append(sid)
    for pos in range(end):
        cur += sum(size[s] for s in born.get(pos, ()))
        peak = max(peak, cur)
        cur -= sum(size[s] for s in dies.get(pos, ()))
    return peak


def cost_program(recording):
    """Cost a :class:`~.contracts.Recording` (its steps in order): one
    attempt with one Newton iteration per step, one pass on the card (the
    module docstring's conventions).  Returns a :class:`Cost`."""
    cost = Cost()
    scalars = recording.track.get("scalars", ())
    for idx, pmarks, outputs in _step_passes(recording):
        cost.peak_bytes = max(cost.peak_bytes,
                              _residency(recording, idx, outputs))
        kept, folded = _fold(recording.ops, idx, pmarks)
        cost.n_while += folded
        for i in kept:
            row = recording.ops[i]
            base, flops, trans, moved = _op_cost(
                row, scalars[i] if i < len(scalars) else ())
            cost.flops += flops
            cost.transcendentals += trans
            cost.bytes_moved += moved
            cost._tally(base, flops)
            if base == "lu32p_factor":
                cost.n_pallas += 1
                smem = lu32p_smem_bytes(row[2][0][-1])
                cost.smem_bytes = max(cost.smem_bytes, smem or 0)
    return cost


# --------------------------------------------------------------------------
# stdlib closed-form half: (B, S, R) rung estimates, no torch required
# --------------------------------------------------------------------------
def padded8(n):
    """``solver/linalg_cuda.py::padded_n``: next multiple of 8."""
    return max(int(-(-int(n) // LU32P_BLOCK)) * LU32P_BLOCK, LU32P_BLOCK)


def lu32p_smem_bytes(n):
    """The ``lu32p`` kernel's dynamic shared memory per CTA at state size
    ``n``: ``solver/linalg_cuda.py::launch_config``'s ``smem`` for the
    padded order (the warp kernel's four tiles, or the CTA kernel's tile
    and buffers), or None past :data:`LU32P_NPAD_MAX`, where no kernel
    takes the matrix (the launch raises there)."""
    npad = padded8(n)
    if npad > LU32P_NPAD_MAX:
        return None
    from ..solver.linalg_cuda import launch_config

    return launch_config(1, npad)["smem"]


def fits_smem(est, smem_bytes=SMEM_BUDGET_BYTES):
    """Does the rung's ``lu32p`` footprint fit one block's shared memory?
    A rung without the kernel fits; a state past the kernel's order does
    not."""
    return est["smem_bytes"] is not None and est["smem_bytes"] <= smem_bytes


def estimate_rung(B, S, R=None, *, method="bdf", energy=False,
                  linsolve="lu", jac_window=1, newton_iters=2,
                  itemsize=8):
    """Closed-form dense-Newton rung estimate at batch ``B``, ``S``
    species, ``R`` reactions (``R=None``: the 4*S mechanism-shape
    heuristic, flagged in the result): the JAX module's formulas and keys,
    ``smem_bytes`` in place of ``vmem_bytes`` (:func:`lu32p_smem_bytes`
    for the modes whose factor is the kernel: ``lu32p`` and, in the port,
    the ``inv32*`` modes).  Pure stdlib unless ``smem_bytes`` is needed.

    The per-lane step cost is

        (jac + lu)/jac_window + stages*(1+newton)*(rhs + trisolve)

    with ``rhs ~ R*(10*T + 250) + 12*n``, ``jac ~ 2*rhs + 6*n^2``, ``lu =
    2/3 n^3`` and ``trisolve = 2*n^2``; resident memory per lane is the
    BDF history block (8 rows), the cached dense factor and Jacobian, and
    O(n) of carry temporaries.  The JAX docstring calls the absolute
    numbers a ~3x band and the ratios across rungs the signal.  On the
    H100 the band is wider: the caching allocator's peak over a phase of
    ``chip_smoke.py`` ran 14x to 85x ``hbm_bytes`` (GRI-3.0 gas, coupled,
    energy, padded, the serving warmup, the map's chunks of 512), and its
    growth within the phase 6.7x to 23x (PERF.md §5): eager aten keeps
    every intermediate of a captured window, which XLA fuses, and a phase
    starts with the earlier phases' cached programs.  The formula stays
    the JAX one, so that the two agree."""
    B, S = int(B), int(S)
    n = S + (1 if energy else 0)
    r_assumed = R is None
    R = int(R) if R is not None else 4 * S
    t = TRANSCENDENTAL_WEIGHT
    rhs = R * (10.0 * t + 250.0) + 12.0 * n
    jac = 2.0 * rhs + 6.0 * n * n
    lu_f = (2.0 / 3.0) * n ** 3
    tri = 2.0 * n * n
    stages = 5 if method == "sdirk" else 1
    jw = max(1, int(jac_window))
    per_lane = (jac + lu_f) / jw + stages * (1 + newton_iters) * (rhs + tri)

    factor_item = 4 if str(linsolve) in ("lu32p", "inv32") else itemsize
    lane_bytes = ((BDF_HIST_ROWS + 16) * n * itemsize
                  + n * n * (itemsize + factor_item))
    const_bytes = (16 * R + n * R) * itemsize   # rate coeffs + stoich
    hbm = B * lane_bytes + const_bytes
    bytes_step = B * itemsize * (n * n * (1.0 / jw
                                          + stages * newton_iters)
                                 + 16.0 * n)
    return {
        "B": B, "S": S, "R": R, "n": n, "method": method,
        "energy": bool(energy), "linsolve": str(linsolve),
        "jac_window": jw, "r_assumed": r_assumed,
        "flops_per_lane_step": per_lane,
        "flops_per_step": B * per_lane,
        "bytes_per_step": bytes_step,
        "hbm_bytes": int(hbm),
        "smem_bytes": (lu32p_smem_bytes(n)
                       if str(linsolve) in _KERNEL_MODES else 0),
        "arithmetic_intensity": (B * per_lane / bytes_step
                                 if bytes_step else 0.0),
    }


def fits_hbm(est, hbm_bytes=HBM_BYTES, headroom=0.8):
    """Go/no-go: does the estimated resident footprint fit the card's
    memory at the given headroom fraction (the caching allocator, the
    captured graphs' pools and the model's own error band eat the
    rest)?"""
    return est["hbm_bytes"] <= headroom * hbm_bytes


# --------------------------------------------------------------------------
# the contract-registry bridge: cost every recorded program
# --------------------------------------------------------------------------
def contract_cost_table(fixtures_dir=None, select=None, device="cpu"):
    """Record every registered contract's programs on the vendored
    fixtures (on ``device``: ``"cuda"`` captures them, and raises without
    a card) and cost each recorded obligation.  Returns ``{key: Cost}``
    with ``key = "<contract>/<tag>"`` (the contract's name alone when the
    tag is the name) — the table ``tools/brcost.py`` renders and gates."""
    from .contracts import run_contracts

    table = {}
    run_contracts(fixtures_dir, select=select, registry_audits=False,
                  device=device, table=table)
    return table
