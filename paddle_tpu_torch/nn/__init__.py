from . import functional, initializer
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "initializer", "Embedding", "Linear", "RMSNorm"]
