"""io layer of the PyTorch port (mirrors batchreactor_tpu/io)."""

from .config import InputData, input_data, parse_composition_text
from .writers import write_profiles

__all__ = ["InputData", "input_data", "parse_composition_text",
           "write_profiles"]
