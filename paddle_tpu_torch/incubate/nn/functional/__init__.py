"""Fused transformer functionals. reference:
paddle_tpu/incubate/nn/functional/__init__.py (`fused_rotary_position_embedding`
:75-140, `swiglu` :143)."""

from __future__ import annotations

import torch

from ....nn.functional import silu

__all__ = ["fused_rotary_position_embedding", "swiglu"]


def _sincos(seq, dim, base, dtype, device):
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                          # (seq, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)              # neox layout
    return emb.sin().to(dtype), emb.cos().to(dtype)


def fused_rotary_position_embedding(q, k=None, v=None, position_ids=None,
                                    rotary_emb_base=10000.0):
    """Neox-style RoPE on q/k/v of layout (batch, seq, heads, head_dim).
    The sin/cos table covers q's sequence; `position_ids` (batch, seq) picks
    rows of it. Returns a (q, k, v) tuple with None where None was given.
    The reference's explicit sin/cos inputs and interleaved style are not
    ported: Llama uses neither."""
    s, c = _sincos(q.shape[1], q.shape[-1], rotary_emb_base, q.dtype,
                   q.device)
    if position_ids is not None:
        s = s[position_ids][:, :, None, :]
        c = c[position_ids][:, :, None, :]
    else:
        s = s[None, :, None, :]
        c = c[None, :, None, :]

    def apply(x):
        if x is None:
            return None
        x1, x2 = x.chunk(2, dim=-1)
        return (x * c + torch.cat([-x2, x1], dim=-1) * s).to(x.dtype)

    return apply(q), apply(k), apply(v)


def swiglu(x, y=None):
    """silu(x) * y; y defaults to the second half of x."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return silu(x) * y
