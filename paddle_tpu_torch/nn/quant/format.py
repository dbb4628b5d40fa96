"""fp8 grid constants. reference: paddle_tpu/nn/quant/format.py:50-64.

Only `fp8_limits` is ported: the quantized paged-KV block format
(ops/paged_attention.KVBlockFormat) scales against it. The fake-quant
layers of the reference's module are not ported.
"""

from __future__ import annotations

__all__ = ["fp8_limits"]

_FP8 = {
    "e4m3": (448.0, "float8_e4m3fn"),
    "e5m2": (57344.0, "float8_e5m2"),
}


def fp8_limits(type="e4m3"):
    """(finite_max, storage dtype name) of an fp8 format: the grid
    constants every fp8 consumer scales against."""
    if type not in _FP8:
        raise NotImplementedError("only e4m3 / e5m2 fp8 formats exist")
    return _FP8[type]
