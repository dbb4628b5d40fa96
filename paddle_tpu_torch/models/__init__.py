from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt3_1p3b, gpt_tiny
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)
from .scanned import build_scanned_llama

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_7b",
           "llama_13b", "llama_tiny", "build_scanned_llama", "GPTConfig",
           "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt3_1p3b",
           "BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base"]
