"""parallel layer of the PyTorch port (mirrors batchreactor_tpu/parallel)."""
