from . import functional, initializer
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "RMSNorm"]
