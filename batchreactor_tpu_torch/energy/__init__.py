"""Non-isothermal reactors: the energy equation and ignition delay.

Port of ``batchreactor_tpu/energy``: ``eqns`` owns the temperature-row
state extension, the adiabatic constant-volume / constant-pressure RHS and
its analytic Jacobian, and the T-row error-norm operand; ``ignition`` owns
the crossing rule, the in-loop ignition-delay detector and the delay's
gradient passes (``temperature_ignition_qoi``,
``delay_sensitivity_forward``).  The ``energy=`` knob of
``batch_reactor_sweep`` is the entry point.
"""

from .eqns import (ATOL_SCALE_KEY, DEFAULT_ATOL_T, ENERGY_MODES,
                   energy_atol_scale, energy_cfg, extend_states,
                   make_energy_jac, make_energy_rhs, resolve_energy)
from .ignition import (DEFAULT_DT_MIN, DEFAULT_DT_THRESHOLD,
                       delay_sensitivity_forward, energy_ignition_observer,
                       extract_delay, grid_crossing, interp_crossing,
                       merge_observers, temperature_ignition_qoi)

__all__ = [
    "ATOL_SCALE_KEY",
    "DEFAULT_ATOL_T",
    "DEFAULT_DT_MIN",
    "DEFAULT_DT_THRESHOLD",
    "delay_sensitivity_forward",
    "ENERGY_MODES",
    "energy_atol_scale",
    "energy_cfg",
    "energy_ignition_observer",
    "extend_states",
    "extract_delay",
    "grid_crossing",
    "interp_crossing",
    "make_energy_jac",
    "make_energy_rhs",
    "merge_observers",
    "resolve_energy",
    "temperature_ignition_qoi",
]
