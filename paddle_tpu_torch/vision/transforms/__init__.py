"""Vision transforms: host preprocessing on numpy arrays. reference:
paddle_tpu/vision/transforms/__init__.py (all of it).

Every function takes a numpy array or a tensor (read back to the host)
and works in numpy, as the reference does. `to_tensor` returns a host
float32 tensor, as a data loader's worker would hand it on; `normalize`
and `erase` return a tensor when given one.

`resize` is `jax.image.resize` rebuilt in numpy (jax/_src/image/scale.py):
per resized axis a weight matrix over (input, output) positions from the
method's kernel (triangle for bilinear, Keys cubic, Lanczos 3 or 5), the
kernel widened by the downsampling factor (antialiasing), each output's
weights renormalised to sum to 1 (zero where they sum to almost nothing)
and zeroed where its sample point lies outside the input; float32 all
through, each axis contracted in turn. "nearest" takes input index
floor((i + 0.5) * in / out) in float32, as XLA computes it (the
constants folded into one factor), and keeps the input's dtype; the
other methods return float32.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = [
    "BaseTransform", "Compose", "ToTensor", "Normalize", "Resize",
    "RandomHorizontalFlip", "RandomVerticalFlip", "RandomCrop",
    "CenterCrop", "RandomResizedCrop", "Transpose", "Pad", "ColorJitter",
    "BrightnessTransform", "ContrastTransform", "SaturationTransform",
    "HueTransform", "Grayscale", "RandomRotation", "RandomAffine",
    "RandomPerspective", "RandomErasing",
    "to_tensor", "normalize", "resize", "hflip", "vflip", "crop",
    "center_crop", "pad", "adjust_brightness", "adjust_contrast",
    "adjust_saturation", "adjust_hue", "to_grayscale", "rotate", "affine",
    "perspective", "erase",
]


class BaseTransform:
    """The transforms' base class (the reference's `keys` plumbing):
    calling one applies `_apply_image`."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def _to_np(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_tensor(pic, data_format="CHW"):
    """float32, scaled by 1/255 when its largest value is above 1.5; a
    2-D image gains a channel axis, and an HWC one with 1, 3 or 4 channels
    goes to CHW when data_format is "CHW"."""
    arr = _to_np(pic).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[None] if data_format == "CHW" else arr[..., None]
    elif data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
        arr = arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _to_np(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean) / std
    return torch.from_numpy(arr) if isinstance(img, torch.Tensor) else arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def _lanczos(radius):
    def kernel(x):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        den = np.where(x != 0, np.pi ** 2 * x ** 2, np.float32(1))
        out = np.where(x > 1e-3, y / den, np.float32(1))
        return np.where(x > radius, np.float32(0), out).astype(np.float32)
    return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic,
            "tricubic": _keys_cubic, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0)}


def _weight_mat(in_size, out_size, kernel):
    """(in_size, out_size) float32 weights of one axis
    (jax.image's compute_weight_mat, antialiased, no translation)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = kernel(x).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1)),
                       f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def _resize_array(arr, shape, method):
    if method == "nearest":
        f32 = np.float32
        for d, (m, n) in enumerate(zip(arr.shape, shape)):
            if m != n:
                # jax's (i + 0.5) * m / n as XLA compiles it: the constants
                # folded into one factor, m * (1 / n), in float32
                offs = np.floor((np.arange(n, dtype=f32) + f32(0.5))
                                * (f32(m) * f32(1.0 / n))).astype(np.int32)
                arr = np.take(arr, offs, axis=d)
        return arr
    if method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    out = arr.astype(np.float32)
    for d, (m, n) in enumerate(zip(arr.shape, shape)):
        if m != n:
            w = _weight_mat(m, n, _KERNELS[method])
            out = np.moveaxis(np.tensordot(out, w, axes=([d], [0])), -1, d)
    return out


def resize(img, size, interpolation="bilinear"):
    """img (H, W, ...) resized to `size` (h, w), or with an int the shorter
    side to it and the other in proportion (truncated)."""
    arr = _to_np(img)
    if isinstance(size, int):
        h, w = arr.shape[:2]
        if h < w:
            size = (size, int(size * w / h))
        else:
            size = (int(size * h / w), size)
    return _resize_array(arr, tuple(size) + arr.shape[2:], interpolation)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


def hflip(img):
    arr = _to_np(img)
    return arr[:, ::-1] if arr.ndim == 2 else arr[:, ::-1, :]


def vflip(img):
    arr = _to_np(img)
    return arr[::-1]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _to_np(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return _to_np(img)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = _to_np(img)
        if self.padding:
            p = self.padding
            pad = [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pad)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return arr[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = _to_np(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img):
        arr = _to_np(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if cw <= w and ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop = arr[i:i + ch, j:j + cw]
                return resize(crop, self.size, self.interpolation)
        return resize(CenterCrop(min(h, w))(arr), self.size,
                      self.interpolation)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def __call__(self, img):
        arr = _to_np(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        arr = _to_np(img)
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        pad = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad, constant_values=self.fill)


# ---------------------------------------------------------------------------
# functional transforms + the color/geometry transform classes
# (reference: vision/transforms/functional.py + transforms.py)
# ---------------------------------------------------------------------------

def crop(img, top, left, height, width):
    a = _to_np(img)
    return a[..., top:top + height, left:left + width] if a.ndim == 3 \
        and a.shape[0] in (1, 3) else a[top:top + height,
                                        left:left + width]


def center_crop(img, output_size):
    a = _to_np(img)
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    h, w = a.shape[-3:-1] if a.ndim == 3 and a.shape[-1] in (1, 3) \
        else a.shape[-2:]
    if a.ndim == 3 and a.shape[-1] in (1, 3):  # HWC
        top = max((h - oh) // 2, 0)
        left = max((w - ow) // 2, 0)
        return a[top:top + oh, left:left + ow]
    h, w = a.shape[-2:]
    top = max((h - oh) // 2, 0)
    left = max((w - ow) // 2, 0)
    return a[..., top:top + oh, left:left + ow]


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _to_np(img)
    if isinstance(padding, int):
        padding = (padding,) * 4
    l, t, r, b = padding if len(padding) == 4 else \
        (padding[0], padding[1], padding[0], padding[1])
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    if a.ndim == 3 and a.shape[-1] in (1, 3):  # HWC
        return np.pad(a, ((t, b), (l, r), (0, 0)), mode, **kw)
    return np.pad(a, ((0, 0),) * (a.ndim - 2) + ((t, b), (l, r)), mode, **kw)


def adjust_brightness(img, brightness_factor):
    a = _to_np(img).astype(np.float32)
    hi = 255.0 if _to_np(img).dtype == np.uint8 else 1.0
    out = np.clip(a * brightness_factor, 0, hi)
    return out.astype(_to_np(img).dtype)


def adjust_contrast(img, contrast_factor):
    a = _to_np(img).astype(np.float32)
    hi = 255.0 if _to_np(img).dtype == np.uint8 else 1.0
    mean = a.mean()
    out = np.clip(mean + contrast_factor * (a - mean), 0, hi)
    return out.astype(_to_np(img).dtype)


def adjust_saturation(img, saturation_factor):
    a = _to_np(img).astype(np.float32)
    hi = 255.0 if _to_np(img).dtype == np.uint8 else 1.0
    if a.ndim == 3 and a.shape[-1] == 3:
        gray = a @ np.asarray([0.299, 0.587, 0.114], np.float32)
        gray = gray[..., None]
    else:
        gray = a
    out = np.clip(gray + saturation_factor * (a - gray), 0, hi)
    return out.astype(_to_np(img).dtype)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV round-trip."""
    a = _to_np(img)
    dt = a.dtype
    x = a.astype(np.float32) / (255.0 if dt == np.uint8 else 1.0)
    if x.ndim != 3 or x.shape[-1] != 3:
        return a
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.max(-1)
    mn = x.min(-1)
    d = mx - mn + 1e-12
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = ((g - b)[m] / d[m]) % 6
    m = mx == g
    h[m] = (b - r)[m] / d[m] + 2
    m = mx == b
    h[m] = (r - g)[m] / d[m] + 4
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, d / (mx + 1e-12), 0)
    v = mx
    i = np.floor(h * 6).astype(np.int32) % 6
    f = h * 6 - np.floor(h * 6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    out = np.take_along_axis(choices, i[None, ..., None], 0)[0]
    out = out * (255.0 if dt == np.uint8 else 1.0)
    return np.clip(out, 0, 255 if dt == np.uint8 else 1.0).astype(dt)


def to_grayscale(img, num_output_channels=1):
    a = _to_np(img).astype(np.float32)
    if a.ndim == 3 and a.shape[-1] == 3:
        g = a @ np.asarray([0.299, 0.587, 0.114], np.float32)
    else:
        g = a.squeeze()
    out = np.repeat(g[..., None], num_output_channels, -1)
    return out.astype(_to_np(img).dtype)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate around center (nearest-neighbor inverse mapping)."""
    a = _to_np(img)
    hwc = a.ndim == 3 and a.shape[-1] in (1, 3)
    if not hwc and a.ndim == 3:
        a = a.transpose(1, 2, 0)
    h, w = a.shape[:2]
    cy, cx = (center[1], center[0]) if center else ((h - 1) / 2,
                                                    (w - 1) / 2)
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = cos * (xx - cx) + sin * (yy - cy) + cx
    sy = -sin * (xx - cx) + cos * (yy - cy) + cy
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.full_like(a, fill)
    out[valid] = a[syi[valid], sxi[valid]]
    if not hwc and out.ndim == 3:
        out = out.transpose(2, 0, 1)
    return out


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Affine warp via inverse nearest mapping (reference F.affine)."""
    a = _to_np(img)
    hwc = a.ndim == 3 and a.shape[-1] in (1, 3)
    if not hwc and a.ndim == 3:
        a = a.transpose(1, 2, 0)
    h, w = a.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None \
        else (center[1], center[0])
    rad = np.deg2rad(angle)
    sx_sh, sy_sh = [np.deg2rad(s) for s in (shear if isinstance(
        shear, (list, tuple)) else (shear, 0.0))]
    # forward matrix: T(center) R S Sh T(-center) + translate
    m = np.asarray([[np.cos(rad + sy_sh), -np.sin(rad + sx_sh)],
                    [np.sin(rad + sy_sh), np.cos(rad + sx_sh)]]) * scale
    minv = np.linalg.inv(m)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([xx - cx - translate[0], yy - cy - translate[1]])
    src = np.einsum("ij,jhw->ihw", minv, pts.astype(np.float64))
    sxi = np.round(src[0] + cx).astype(np.int64)
    syi = np.round(src[1] + cy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.full_like(a, fill)
    out[valid] = a[syi[valid], sxi[valid]]
    if not hwc and out.ndim == 3:
        out = out.transpose(2, 0, 1)
    return out


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """4-point perspective warp (reference F.perspective)."""
    a = _to_np(img)
    hwc = a.ndim == 3 and a.shape[-1] in (1, 3)
    if not hwc and a.ndim == 3:
        a = a.transpose(1, 2, 0)
    h, w = a.shape[:2]
    # solve homography end -> start (inverse map)
    A, bvec = [], []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        bvec.append(sx)
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        bvec.append(sy)
    hcoef = np.linalg.lstsq(np.asarray(A, np.float64),
                            np.asarray(bvec, np.float64), rcond=None)[0]
    H = np.append(hcoef, 1.0).reshape(3, 3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = H[2, 0] * xx + H[2, 1] * yy + H[2, 2]
    sx = (H[0, 0] * xx + H[0, 1] * yy + H[0, 2]) / den
    sy = (H[1, 0] * xx + H[1, 1] * yy + H[1, 2]) / den
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.full_like(a, fill)
    out[valid] = a[syi[valid], sxi[valid]]
    if not hwc and out.ndim == 3:
        out = out.transpose(2, 0, 1)
    return out


def erase(img, i, j, h, w, v, inplace=False):
    """img with rows i..i+h and columns j..j+w set to v; a tensor in gives
    a tensor out (with `inplace`, img itself, written)."""
    is_tensor = isinstance(img, torch.Tensor)
    a = _to_np(img)
    out = a if inplace and not is_tensor else a.copy()
    v = _to_np(v)
    if a.ndim == 3 and a.shape[-1] in (1, 3):
        out[i:i + h, j:j + w] = v
    else:
        out[..., i:i + h, j:j + w] = v
    if is_tensor:
        res = torch.from_numpy(out)
        if inplace:
            with torch.no_grad():
                img.copy_(res)
            return img
        return res
    return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = float(np.random.uniform(max(0, 1 - self.value), 1 + self.value))
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = float(np.random.uniform(max(0, 1 - self.value), 1 + self.value))
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = float(np.random.uniform(max(0, 1 - self.value), 1 + self.value))
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = float(np.random.uniform(-self.value, self.value))
        return adjust_hue(img, f)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(4)
        for i in order:
            img = self.transforms[i](img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = float(np.random.uniform(*self.degrees))
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a = _to_np(img)
        h, w = (a.shape[:2] if a.ndim == 3 and a.shape[-1] in (1, 3)
                else a.shape[-2:])
        angle = float(np.random.uniform(*self.degrees))
        tr = (0, 0)
        if self.translate:
            tr = (float(np.random.uniform(-self.translate[0],
                                          self.translate[0]) * w),
                  float(np.random.uniform(-self.translate[1],
                                          self.translate[1]) * h))
        sc = float(np.random.uniform(*self.scale)) if self.scale else 1.0
        if self.shear is None:
            sh = (0.0, 0.0)
        elif np.isscalar(self.shear):
            sh = (float(np.random.uniform(-self.shear, self.shear)), 0.0)
        elif len(self.shear) == 2:     # [min_x, max_x]
            sh = (float(np.random.uniform(*self.shear)), 0.0)
        else:                          # [min_x, max_x, min_y, max_y]
            sh = (float(np.random.uniform(self.shear[0], self.shear[1])),
                  float(np.random.uniform(self.shear[2], self.shear[3])))
        return affine(img, angle, tr, sc, sh, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = _to_np(img)
        h, w = (a.shape[:2] if a.ndim == 3 and a.shape[-1] in (1, 3)
                else a.shape[-2:])
        d = self.distortion_scale
        dx = int(d * w / 2)
        dy = int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dx + 1), np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1)),
               (np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1))]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        a = _to_np(img)
        hwc = a.ndim == 3 and a.shape[-1] in (1, 3)
        h, w = (a.shape[:2] if hwc else a.shape[-2:])
        area = h * w * np.random.uniform(*self.scale)
        ar = np.random.uniform(*self.ratio)
        eh = min(int(round(np.sqrt(area * ar))), h)
        ew = min(int(round(np.sqrt(area / ar))), w)
        i = np.random.randint(0, h - eh + 1)
        j = np.random.randint(0, w - ew + 1)
        return erase(img, i, j, eh, ew, self.value)
