from torch.nn import ModuleList as LayerList

from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerList", "LayerNorm", "Linear",
           "RMSNorm"]
