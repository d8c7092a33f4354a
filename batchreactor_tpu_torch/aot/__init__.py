"""Shape buckets of the PyTorch port (mirrors batchreactor_tpu/aot)."""
