from .manipulation import concat, flatten, reshape, split, transpose
from .math import bmm, einsum, matmul, mm

__all__ = ["reshape", "flatten", "transpose", "concat", "split", "matmul",
           "mm", "bmm", "einsum"]
