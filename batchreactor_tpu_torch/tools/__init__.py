"""Command-line tools of the port, run as ``python -m
batchreactor_tpu_torch.tools.<name>``: measurement scripts and the
counterparts of the JAX package's ``scripts/``."""
