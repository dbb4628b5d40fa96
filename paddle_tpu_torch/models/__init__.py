from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_7b",
           "llama_13b", "llama_tiny"]
