"""models layer of the PyTorch port (mirrors batchreactor_tpu/models)."""
