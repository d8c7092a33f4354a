"""parallel layer of the PyTorch port (mirrors batchreactor_tpu/parallel)."""

from . import multihost
from .checkpoint import checkpointed_sweep, load_result, save_result
from .grid import condition_grid, premixed_mole_fracs, sweep_solution_vectors
from .sweep import (Mesh, ensemble_solve, ensemble_solve_forward,
                    ensemble_solve_segmented, ignition_delay,
                    ignition_observer, make_mesh, pad_batch, pad_to_bucket,
                    pad_to_mesh, resolve_admission, sweep_report,
                    temperature_sweep, unpad_result)

__all__ = [
    "Mesh",
    "checkpointed_sweep",
    "condition_grid",
    "ensemble_solve",
    "ensemble_solve_forward",
    "ensemble_solve_segmented",
    "ignition_delay",
    "ignition_observer",
    "load_result",
    "make_mesh",
    "multihost",
    "pad_batch",
    "pad_to_bucket",
    "pad_to_mesh",
    "premixed_mole_fracs",
    "resolve_admission",
    "save_result",
    "sweep_report",
    "sweep_solution_vectors",
    "temperature_sweep",
    "unpad_result",
]
