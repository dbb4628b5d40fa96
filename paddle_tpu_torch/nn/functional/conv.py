"""Convolutions. reference: paddle_tpu/nn/functional/conv.py (`_padding`
:26-40, `_conv` :43-76, `conv1d/2d/3d` :79-91, `_conv_transpose`
:94-198, `conv1d/2d/3d_transpose` :201-215).

The reference lowers every convolution to `lax.conv_general_dilated`
(XLA, not Pallas); the port calls torch's `conv1d/2d/3d`, which run
cuDNN on the card. Paddle's padding forms and XLA's "SAME" are resolved
here to (low, high) pads per spatial dim: symmetric pads go to torch's
`padding=`, asymmetric ones through `F.pad` first. The bias is added
after the convolution, in its output's dtype, as the reference adds it.

A transposed convolution is the reference's lhs-dilated convolution with
the flipped kernel over (k_eff - 1 - low, k_eff - 1 - high + extra) pads
per dim, `extra` the output padding or what `output_size` asks for. That
is torch's `conv_transpose*d` with padding `low` and `output_padding`
`extra` where low == high and extra < max(stride, dilation); otherwise the
port takes torch's full output (no padding: (in - 1) * stride + k_eff) and
crops `low` off the low side and `high - extra` off the high side, or pads
zeros there where that is negative (padding="SAME" with a kernel smaller
than the stride: the reference's high pad is then negative).
"""

from __future__ import annotations

import torch.nn.functional as TF

from ...amp import _cast

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


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
    x, weight, bias = _cast(f"conv{n}d", x, weight, bias)
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


def _transpose_pads(padding, n, data_format, k_eff, sd):
    """(low, high) pads of the convolution a transposed one inverts:
    Paddle's forms, "VALID", or "SAME" (out = in * stride: a total of
    k_eff - stride, its odd element and any deficit on the high side)."""
    if isinstance(padding, str):
        up = padding.upper()
        if up == "VALID":
            return [(0, 0)] * n
        if up != "SAME":
            raise ValueError(f"padding must be SAME/VALID or ints, got "
                             f"{padding!r}")
        totals = [k - s for k, s in zip(k_eff, sd)]
        return [(max(t, 0) // 2, t - max(t, 0) // 2) for t in totals]
    return _padding(padding, n, data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n, output_size=None):
    x, weight, bias = _cast(f"conv{n}d_transpose", x, weight, bias)
    sd = _tuple(stride, n)
    dd = _tuple(dilation, n)
    opad = (_tuple(output_padding, n) if output_padding is not None
            else (0,) * n)
    channels_last = not data_format.startswith("NC")
    if channels_last:
        x = x.movedim(-1, 1)
    k_eff = [d * (k - 1) + 1 for d, k in zip(dd, weight.shape[2:])]
    pads = _transpose_pads(padding, n, data_format, k_eff, sd)
    extra = list(opad)
    if output_size is not None:
        if any(o != 0 for o in opad):
            raise ValueError("output_padding must not be set when "
                             "output_size is specified")
        osz = (output_size if isinstance(output_size, (list, tuple))
               else (output_size,) * n)
        for i in range(n):
            cur = (x.shape[2 + i] - 1) * sd[i] + k_eff[i] - sum(pads[i])
            extra[i] = int(osz[i]) - cur
            if not 0 <= extra[i] < max(sd[i], 1):
                raise ValueError(
                    f"output_size[{i}]={osz[i]} not reachable: valid "
                    f"range [{cur}, {cur + max(sd[i], 1)})")
    if all(lo == hi >= 0 and 0 <= e < max(s, d)
           for (lo, hi), e, s, d in zip(pads, extra, sd, dd)):
        out = _CONV_T[n](x, weight, None, sd, tuple(lo for lo, _ in pads),
                         tuple(extra), groups, dd)
    else:
        out = _CONV_T[n](x, weight, None, sd, 0, 0, groups, dd)
        grow = []            # F.pad's (low, high) per dim, last dim first
        for i in reversed(range(n)):
            lo, hi = pads[i]
            grow += [-lo, extra[i] - hi]
        out = TF.pad(out, grow)
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * n)
    return out.movedim(1, -1) if channels_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """The weight is (in, out / groups, k), the reference's layout and
    torch's."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3, output_size)
