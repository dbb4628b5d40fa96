"""Common functionals in Paddle's layouts. reference:
paddle_tpu/nn/functional/common.py (all of it but `flash_attention`,
which attention.py holds) and the re-exports of
nn/functional/__init__.py (`pad`, `one_hot`, `sequence_mask`).

`interpolate` computes what the reference's `jax.image.resize` computes
(common.py:191-240), which torch's F.interpolate does not:
- "nearest" samples input floor((i + 0.5) * in / out), half-pixel
  centres (torch's "nearest-exact", not its "nearest");
- the linear modes (and "area", linear in the reference) and "bicubic"
  weigh the inputs by a triangle or a Keys cubic (a = -0.5; torch's is
  -0.75) widened by in/out when downsampling (an antialiasing filter),
  each output's weights normalised to sum 1, over the in/out ratio of the
  sizes after int(size * scale_factor);
- with `align_corners` every mode but "nearest" is linear between the
  corner-aligned neighbours (`_resize_align_corners`).
Each spatial axis is one product with its (out, in) weight matrix.
"""

from __future__ import annotations

import torch


from ...amp import _cast
from ...framework.dtypes import convert_dtype
from ...framework.random import get_generator
from ...tensor.creation import one_hot
from ...tensor.manipulation import pad

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "cosine_similarity",
    "normalize", "label_smooth", "unfold", "fold", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "bilinear",
    "sequence_mask",
]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W shaped (in, out), Paddle's layout."""
    x, weight, bias = _cast("linear", x, weight, bias)
    out = x @ weight
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability p, drawn from the port's generator
    of x's device (framework.random). `axis` (an int or a list) draws one
    mask over those axes, broadcast over the rest. "upscale_in_train"
    scales the kept elements by 1 / (1 - p); "downscale_in_infer" keeps them
    as they are. Outside training or at p = 0, x itself."""
    if not training or p == 0.0:
        return x
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode={mode!r}; pick upscale_in_train or "
                         f"downscale_in_infer")
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in
                (axis if isinstance(axis, (list, tuple)) else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.empty(shape, dtype=torch.float32, device=x.device)
    keep = keep.bernoulli_(1.0 - p, generator=get_generator(x.device)) > 0
    if mode == "upscale_in_train":
        x = x / (1.0 - p)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` (num_embeddings, dim) at integer ids `x`; rows at
    `padding_idx` are zero. `sparse` asks Paddle for a sparse gradient; the
    reference accepts it and ignores it, and so does the port."""
    out = weight[x]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one draw per (sample, channel)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps SELU's mean and variance: dropped elements take
    -alpha * scale, then an affine map restores the moments."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=get_generator(x.device)) > 0
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    kept = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                           device=x.device))
    return (a * kept + b).to(x.dtype)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    na = torch.linalg.vector_norm(x1, dim=axis)
    nb = torch.linalg.vector_norm(x2, dim=axis)
    return (x1 * x2).sum(axis) / torch.clamp(na * nb, min=eps)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along axis, epsilon)."""
    n = torch.linalg.vector_norm(x, p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=epsilon)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior_dist (uniform over the last
    axis without one)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] . weight[o] . x2[b] (+ bias)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def _two(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _four(p):
    """Paddle's paddings as (top, left, bottom, right): one int, (h, w) or
    the four."""
    if isinstance(p, int):
        return p, p, p, p
    if len(p) == 2:
        return p[0], p[1], p[0], p[1]
    return tuple(p)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (n, c * kh * kw, blocks), channel-major, as Paddle's."""
    pt, pl, pb, pr = _four(paddings)
    x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
    return torch.nn.functional.unfold(x, _two(kernel_sizes),
                                      dilation=_two(dilations),
                                      stride=_two(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, unfold's adjoint: overlapping blocks summed."""
    oh, ow = _two(output_sizes)
    pt, pl, pb, pr = _four(paddings)
    out = torch.nn.functional.fold(x, (oh + pt + pb, ow + pl + pr),
                                   _two(kernel_sizes),
                                   dilation=_two(dilations),
                                   stride=_two(strides))
    return out[:, :, pt:pt + oh, pl:pl + ow]


def _keys_cubic(x):
    """jax.image's Keys cubic kernel (a = -0.5)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _resize_weights(n_in, n_out, kernel, device):
    """jax.image.scale_and_translate's (in, out) weight matrix for scale
    n_out / n_in and no translation, antialiased (float32)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_nearest(a, axis, n_out):
    n_in = a.shape[axis]
    src = ((torch.arange(n_out, dtype=torch.float32, device=a.device) + 0.5)
           * n_in / n_out).floor().long()
    return a.index_select(axis, src)


def _resize_linear_aligned(a, axis, n_out):
    """Linear between corner-aligned neighbours (common.py:220-240)."""
    n_in = a.shape[axis]
    if n_out == 1 or n_in == 1:
        idx = torch.zeros(n_out, dtype=torch.float32, device=a.device)
    else:
        idx = ((torch.arange(n_out, device=a.device) * (n_in - 1)).float()
               / (n_out - 1))
    lo = idx.floor().long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    shape = [1] * a.dim()
    shape[axis] = n_out
    w = (idx - lo).to(a.dtype).reshape(shape)
    return a.index_select(axis, lo) * (1 - w) + a.index_select(axis, hi) * w


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """x resized over its spatial axes to `size`, or to int(in *
    scale_factor) each, as jax.image.resize does (see the module's
    notes). `align_mode` is accepted and ignored, as the reference does."""
    if mode not in ("nearest", "bilinear", "trilinear", "bicubic", "linear",
                    "area"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    first = data_format in ("NCHW", "NCL", "NCDHW")
    axes = list(range(2, x.dim())) if first else list(range(1, x.dim() - 1))
    spatial = [x.shape[a] for a in axes]
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out = [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
               for s in sizes]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(axes))
        out = [int(s * f) for s, f in zip(spatial, sf)]
    if mode == "nearest":
        for a, n in zip(axes, out):
            if x.shape[a] != n:
                x = _resize_nearest(x, a, n)
        return x
    if align_corners:
        for a, n in zip(axes, out):
            if x.shape[a] != n:
                x = _resize_linear_aligned(x, a, n)
        return x
    kernel = _keys_cubic if mode == "bicubic" else _triangle
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(torch.float32)
    for a, n in zip(axes, out):
        if x.shape[a] != n:
            w = _resize_weights(x.shape[a], n, kernel, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([a], [0])), -1, a)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """(n, c r^2, h, w) -> (n, c, h r, w r); in NHWC the channel index is
    (i r + j) c' + k, as the reference's."""
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        y = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return y.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    y = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        y = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return y.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    y = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """mask[..., j] = j < x[...], over maxlen positions (x's largest value
    without one)."""
    if maxlen is None:
        maxlen = int(x.max())
    r = torch.arange(int(maxlen), device=x.device)
    return (r < x[..., None]).to(convert_dtype(dtype))
