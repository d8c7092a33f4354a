"""batchreactor_tpu_torch — the PyTorch/CUDA port of batchreactor_tpu.

The JAX package ``batchreactor_tpu`` stays the reference; this package
mirrors its module names (``models/gas.py``, ``ops/gas_kinetics.py``,
``solver/bdf.py``, ...) with plain functions on lane-batched tensors, float64
state, rates and Jacobians, and an explicit ``device=`` on every entry point
(``None`` = ``cuda``; without a GPU that raises unless ``device="cpu"``).
It runs the reference's four chemistry modes (gas, surface, coupled
gas+surface and user-defined), adiabatic gas chemistry (``energy``), both
solvers (BDF and SDIRK4), the ensemble layer (``parallel``),
mechanism-shape padding (``models/padding.py``), parameter
sensitivities (``sensitivity``: forward tangents, adjoint gradients,
reaction ranking) and fault-tolerant sweeps (``resilience``, with
``parallel.checkpointed_sweep``, device meshes and the multi-process tiers
of ``parallel.multihost``).
The JAX package's one Pallas kernel, the batched float32 LU behind
``linsolve="lu32p"``, is a hand-written CUDA kernel here
(``csrc/lu32p.cu``, built with ``nvcc`` at first use).

Importing the package sets no default dtype and touches no device.
"""

from . import energy, obs, parallel, resilience, sensitivity
from .api import (Chemistry, SensitivityProblem, SensitivitySolution,
                  batch_reactor, batch_reactor_sweep, get_solution_vector,
                  resolve_jac_window)
from .io.config import InputData, input_data
from .models.gas import GasMechanism, compile_gaschemistry
from .models.padding import (mech_shape_class, pad_gas_mechanism, pad_states,
                             pad_thermo)
from .models.surface import SurfaceMechanism, compile_mech
from .models.thermo import ThermoTable, create_thermo
from .parallel import Mesh, checkpointed_sweep

__all__ = [
    "Chemistry",
    "GasMechanism",
    "InputData",
    "Mesh",
    "SensitivityProblem",
    "SensitivitySolution",
    "SurfaceMechanism",
    "ThermoTable",
    "batch_reactor",
    "batch_reactor_sweep",
    "checkpointed_sweep",
    "compile_gaschemistry",
    "compile_mech",
    "create_thermo",
    "energy",
    "get_solution_vector",
    "input_data",
    "mech_shape_class",
    "obs",
    "pad_gas_mechanism",
    "pad_states",
    "pad_thermo",
    "parallel",
    "resilience",
    "resolve_jac_window",
    "sensitivity",
]

__version__ = "0.1.0"
