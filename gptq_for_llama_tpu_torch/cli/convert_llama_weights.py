"""Meta LLaMA -> HuggingFace checkpoint conversion.

Counterpart of ``gptq_for_llama_tpu/cli/convert_llama_weights.py``: a thin
wrapper over transformers' converter, as the reference's. Run:

  python -m gptq_for_llama_tpu_torch.cli.convert_llama_weights \\
      --input_dir /path/to/downloaded/llama --model_size 7B \\
      --output_dir /path/to/hf-llama
"""

from __future__ import annotations


def main():
    from transformers.models.llama import convert_llama_weights_to_hf as conv
    conv.main()


if __name__ == "__main__":
    main()
