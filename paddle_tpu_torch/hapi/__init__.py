from . import callbacks
from .flops import flops
from .model import Model, summary

__all__ = ["Model", "summary", "callbacks", "flops"]
