"""Command-line tools of the port, run as ``python -m
batchreactor_tpu_torch.tools.<name>``: measurement scripts and the
counterparts of the JAX package's ``scripts/``.

- the north-star map and its single-core baseline: ``northstar_sweep``,
  ``northstar_baseline``;
- serving and the fleet: ``serve``, ``serve_bench``, ``serve_fleet``;
- reports: ``obs_report``, ``obs_gate``, ``obs_trace``, ``obs_slo``,
  ``obs_fleet``;
- sensitivities: ``sens_rank``;
- checks: ``brlint``, ``fault_smoke``;
- the ``lu32p`` kernel: ``lu32p_ab``, ``lu32p_trace``,
  ``lu32p_coverages``.
"""
