"""Convolutions. reference: paddle_tpu/nn/functional/conv.py (`_padding`
:26-40, `_conv` :43-76, `conv1d/2d/3d` :79-91).

The reference lowers every convolution to `lax.conv_general_dilated`
(XLA, not Pallas); the port calls torch's `conv1d/2d/3d`, which run
cuDNN on the card. Paddle's padding forms and XLA's "SAME" are resolved
here to (low, high) pads per spatial dim: symmetric pads go to torch's
`padding=`, asymmetric ones through `F.pad` first. The bias is added
after the convolution, in its output's dtype, as the reference adds it.
Transposed convolutions are not ported.
"""

from __future__ import annotations

import torch.nn.functional as TF

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding(padding, n, data_format):
    """The reference's padding forms -> "SAME", "VALID" or [(low, high)] per
    spatial dim: an int, one int per dim, 2n ints (low, high in turn), or
    n + 2 pairs including the batch and channel dims' (the
    [[0,0],[0,0],[h0,h1],[w0,w1]] form, in `data_format`'s order). A list
    holding pairs is read as that form: the reference tries 2n ints first
    and so raises on the 2-D pairs form."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    pairs = any(isinstance(p, (list, tuple)) for p in padding)
    if len(padding) == n and not pairs:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and not pairs:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n + 2:
        sp = padding[2:] if data_format.startswith("NC") else padding[1:-1]
        return [(int(p[0]), int(p[1])) if isinstance(p, (list, tuple))
                else (int(p), int(p)) for p in sp]
    raise ValueError(f"bad padding {padding}")


def same_pads(spatial, kernel, stride, dilation):
    """XLA's "SAME" pads (lax.padtype_to_pads): out = ceil(in / stride),
    the total pad split with the odd element on the high side."""
    pads = []
    for size, k, s, d in zip(spatial, kernel, stride, dilation):
        k_eff = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n):
    sd = _tuple(stride, n)
    dd = _tuple(dilation, n)
    pad = _padding(padding, n, data_format)
    channels_last = not data_format.startswith("NC")
    if channels_last:
        x = x.movedim(-1, 1)
    if pad == "VALID":
        pad = [(0, 0)] * n
    elif pad == "SAME":
        pad = same_pads(x.shape[2:], weight.shape[2:], sd, dd)
    elif isinstance(pad, str):
        raise ValueError(f"padding must be SAME, VALID or ints, got {pad!r}")
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x = TF.pad(x, [p for lo_hi in reversed(pad) for p in lo_hi])
        sym = 0
    out = _CONV[n](x, weight, None, sd, sym, dd, groups)
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * n)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)
