"""Shape buckets of the PyTorch port (mirrors batchreactor_tpu/aot).

The JAX package's AOT registry (``aot/registry.py``, its warmup and the
persistent compilation cache) is not ported: a CUDA graph does not outlive
its process (ROADMAP "Not ported, with reason")."""

from .buckets import POW2, bucket_ladder, normalize_buckets, resolve_bucket

__all__ = ["POW2", "bucket_ladder", "normalize_buckets", "resolve_bucket"]
