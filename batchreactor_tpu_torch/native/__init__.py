"""The native (C++) runtime of the port (``batchreactor_tpu/native``).

``native/br_native.cpp`` is the JAX package's own host runtime: CHEMKIN
gas and surface RHS kernels and a CVODE-class variable-order BDF, built at
first use with g++ into the checkout's ``build/native/`` and loaded with
ctypes (:mod:`.bindings`).  No GPU is involved.

Uses: ``batch_reactor(backend="cpu")`` (every chemistry mode), the
quarantine's oracle rung (``resilience.quarantine.native_oracle``), the
single-CPU baseline of the north-star ratio, and RHS-against-RHS and
solver-against-solver checks.  A build or load failure raises
:class:`NativeUnavailable`; nothing falls back quietly.
"""

from .bindings import (  # noqa: F401
    NativeUnavailable,
    available,
    gas_rhs,
    load_library,
    solve_bdf,
    solve_gas_bdf,
    solve_surf_bdf,
    surf_rhs,
    surface_rates,
)

__all__ = [
    "NativeUnavailable",
    "available",
    "gas_rhs",
    "load_library",
    "solve_bdf",
    "solve_gas_bdf",
    "solve_surf_bdf",
    "surf_rhs",
    "surface_rates",
]
