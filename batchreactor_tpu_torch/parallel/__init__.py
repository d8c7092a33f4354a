"""parallel layer of the PyTorch port (mirrors batchreactor_tpu/parallel)."""

from .grid import condition_grid, premixed_mole_fracs, sweep_solution_vectors
from .sweep import (ensemble_solve, ensemble_solve_forward,
                    ensemble_solve_segmented, ignition_delay,
                    ignition_observer, sweep_report, temperature_sweep)

__all__ = [
    "condition_grid",
    "ensemble_solve",
    "ensemble_solve_forward",
    "ensemble_solve_segmented",
    "ignition_delay",
    "ignition_observer",
    "premixed_mole_fracs",
    "sweep_report",
    "sweep_solution_vectors",
    "temperature_sweep",
]
