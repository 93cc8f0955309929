"""Quantization engine: sequential layer-by-layer GPTQ, eval, pack/checkpoint I/O,
LoRA adapters over the packed model."""

from .quantize import (Observer, QuantizeSpec, QuantRecord, quantize_model,
                       get_path, set_path, layer_linears)
from .evaluate import perplexity
from .checkpoint import (pack_model, save_packed, flatten_to_hf,
                         export_quant_table)
from .lora import LoraLinear, attach_lora, join_lora, split_lora

__all__ = ["Observer", "QuantizeSpec", "QuantRecord", "quantize_model",
           "get_path", "set_path", "layer_linears", "perplexity", "pack_model",
           "save_packed", "flatten_to_hf", "export_quant_table", "attach_lora", "split_lora",
           "join_lora", "LoraLinear"]
