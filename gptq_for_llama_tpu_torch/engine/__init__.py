"""Quantization engine: sequential layer-by-layer GPTQ, eval, pack/checkpoint I/O."""

from .quantize import (Observer, QuantizeSpec, QuantRecord, quantize_model,
                       get_path, set_path, layer_linears)
from .evaluate import perplexity
from .checkpoint import (pack_model, save_packed, flatten_to_hf,
                         export_quant_table)

__all__ = ["Observer", "QuantizeSpec", "QuantRecord", "quantize_model",
           "get_path", "set_path", "layer_linears", "perplexity", "pack_model",
           "save_packed", "flatten_to_hf", "export_quant_table"]
