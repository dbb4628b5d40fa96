from .manipulation import concat, flatten, reshape, split, transpose

__all__ = ["reshape", "flatten", "transpose", "concat", "split"]
