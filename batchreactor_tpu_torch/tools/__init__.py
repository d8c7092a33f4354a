"""Measurement scripts of the port, run as ``python -m
batchreactor_tpu_torch.tools.<name>``."""
