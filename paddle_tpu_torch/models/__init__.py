from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)
from .scanned import build_scanned_llama

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_7b",
           "llama_13b", "llama_tiny", "build_scanned_llama"]
