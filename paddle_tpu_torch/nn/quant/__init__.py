"""Weight-only and LLM.int8 quantized linear algebra. reference:
paddle_tpu/nn/quant/__init__.py (`weight_quantize` :48,
`weight_dequantize` :77, `weight_only_linear` :97, `llm_int8_linear` :134,
`Stub` :177).

Layouts are the reference's: `weight_quantize` takes a (k, n) weight and
returns its (n, k) int8 transpose with a float32 scale of (n,) per output
channel, or (n, k // group_size) with a group size. int4 is stored as int8
values in [-8, 7]. `arch` is accepted and ignored, as there.

The reference computes every op here as XLA-compiled jnp outside any
Pallas kernel, so the port computes them as plain torch. The one library
call is `llm_int8_linear`'s int8 x int8 -> int32 product, which must be
exact (|sum| reaches 127 * 128 * k, past float32's 2**24): on the card it
is cuBLASLt's `torch._int_mm` on operands zero-padded to its shape rules,
on the CPU an int32 matmul.
"""

from __future__ import annotations

import torch
from torch import nn

from ...framework.dtypes import convert_dtype
from . import format  # noqa: F401  (the QAT -> deployment layers)
from .format import (LinearDequanter, LinearQuanter, LinearQuanterDequanter,
                     div, fake_fp8_dequant, fake_fp8_quant, fp8_limits)
from ..layer.layers import Layer

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear",
           "weight_quantize", "weight_dequantize", "LinearQuanter",
           "LinearDequanter", "LinearQuanterDequanter", "fake_fp8_quant",
           "fake_fp8_dequant", "fp8_limits"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _check(algo, group_size):
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo!r}")
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")


def _qmax(algo):
    return 7.0 if algo == "weight_only_int4" else 127.0


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """(k, n) float weight -> ((n, k) int8 weight, float32 scale): absmax
    over each output channel (or each group of `group_size` inputs of it)
    over qmax, the division in float32 against the scale floored at 1e-10,
    rounded half to even and clipped to [-qmax - 1, qmax]."""
    _check(algo, group_size)
    qmax = _qmax(algo)
    wt = x.float().T                                     # (n, k)
    if group_size == -1:
        scale = div(wt.abs().amax(dim=1), qmax)          # (n,)
        q = torch.round(wt / scale.clamp(min=1e-10)[:, None])
    else:
        n, k = wt.shape
        if k % group_size:
            raise ValueError(f"in-features {k} not divisible by group_size "
                             f"{group_size}")
        g = wt.reshape(n, k // group_size, group_size)
        scale = div(g.abs().amax(dim=2), qmax)           # (n, k / gs)
        q = torch.round(g / scale.clamp(min=1e-10)[:, :, None]).reshape(n, k)
    return q.clamp(-qmax - 1, qmax).to(torch.int8), scale.float()


def _dequant(q, s, group_size, dtype):
    """(n, k) levels times their scales, in `dtype`, still (n, k)."""
    qf = q.to(dtype)
    if group_size == -1:
        return qf * s.to(dtype)[:, None]
    n, k = qf.shape
    g = qf.reshape(n, k // group_size, group_size)
    return (g * s.to(dtype)[:, :, None]).reshape(n, k)


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float16",
                      group_size=-1):
    """(n, k) int8 weight and its scale -> the (k, n) float weight, the
    product in float32, then cast to `out_dtype`."""
    _check(algo, group_size)
    return _dequant(x, scale, group_size, torch.float32).T.to(
        convert_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x @ dequant(weight).T + bias, the weight dequantized in x's dtype
    (as the reference's). weight: (n, k) int8 from weight_quantize."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8/int4, got {weight_dtype}")
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")
    wf = (weight.to(x.dtype) if weight_scale is None
          else _dequant(weight, weight_scale, group_size, x.dtype))
    out = x @ wf.T
    return out if bias is None else out + bias


def _ceil(v, m):
    return -(-v // m) * m


def _int8_matmul(a, w):
    """Exact (m, k) int8 x (n, k) int8 -> (m, n) int32 product. On CUDA,
    cuBLASLt's int8 GEMM (`torch._int_mm`) wants more than 16 rows and k, n
    multiples of 8: zero rows and columns are padded on, which leaves the
    product as it is."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ w.to(torch.int32).T
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(_ceil(m, 8), 24), _ceil(k, 8), _ceil(n, 8)
    ap = a.new_zeros(mp, kp)
    ap[:m, :k] = a
    wp = w.new_zeros(np_, kp)
    wp[:n, :k] = w
    return torch._int_mm(ap, wp.T)[:m, :n]


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8 (Dettmers et al.): the columns of x holding any |value| >
    threshold (over all tokens) run in float32 against the dequantized
    weight; the rest are quantized per token to int8 (absmax / 127) and
    run int8 x int8 -> int32, exactly, with a scale epilogue. weight:
    (n, k) int8. The result is in x's dtype."""
    af = x.float()
    lead = af.shape[:-1]
    a2 = af.reshape(-1, af.shape[-1])
    outlier = (a2.abs() > threshold).any(dim=0)                  # (k,)
    a_in = torch.where(outlier, 0.0, a2)
    a_scale = div(a_in.abs().amax(dim=-1, keepdim=True).clamp(min=1e-10),
                  127.0)
    aq = torch.round(a_in / a_scale).clamp(-128, 127).to(torch.int8)
    acc = _int8_matmul(aq, weight).float()
    w_scale = (weight_scale.float() if weight_scale is not None else
               torch.ones(weight.shape[0], device=x.device))
    out = acc * a_scale * w_scale
    a_out = torch.where(outlier, a2, 0.0)
    out = out + a_out @ (weight.float() * w_scale[:, None]).T
    if bias is not None:
        out = out + bias.float()
    return out.reshape(*lead, -1).to(x.dtype)


class Stub(Layer):
    """Observer placeholder where a quanter should attach; the identity
    until quantization.QAT resolves it."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x
