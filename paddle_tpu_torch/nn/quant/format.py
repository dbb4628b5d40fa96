"""Quant/dequant format layers, the QAT -> deployment conversion pieces.
reference: paddle_tpu/nn/quant/format.py (`fp8_limits` :50,
`fake_fp8_quant`/`fake_fp8_dequant` :76-113, `_parse_bits` :116,
`_ScaledFormat` :129, `LinearQuanter` :163, `LinearDequanter` :196,
`LinearQuanterDequanter` :229).

`quant_bits` as the reference's:
  int    -> a symmetric integer grid, clipped to [-qmax, qmax] with
            qmax = 2^(b-1) - 1;
  (4, 3) -> float8 e4m3 (finite range +-448);
  (5, 2) -> float8 e5m2 (finite range +-57344).
fp8 values round through torch's float8 storage types, as the reference's
through ml_dtypes'. `LinearDequanter` takes the asymmetric -qmax - 1 level
of reference-written tensors exactly (the map is linear and unclipped);
`LinearQuanter` emits the symmetric grid only. Channels whose scale is 0
(a quanter that never observed) pass through unquantized.

The scales and zero points are non-persistent buffers: they follow the
layer's `.to()`, and the state dict stays empty, as the reference's.
"""

from __future__ import annotations

import torch

from ...framework.device import resolve_device
from ..layer.layers import Layer

__all__ = ["LinearQuanter", "LinearDequanter", "LinearQuanterDequanter",
           "fake_fp8_quant", "fake_fp8_dequant", "fp8_limits"]

_FP8 = {
    "e4m3": (448.0, "float8_e4m3fn"),
    "e5m2": (57344.0, "float8_e5m2"),
}


def fp8_limits(type="e4m3"):
    """(finite_max, storage dtype name) of an fp8 format: the grid
    constants every fp8 consumer scales against (these layers and the
    quantized paged-KV block format, ops/paged_attention.KVBlockFormat)."""
    if type not in _FP8:
        raise NotImplementedError("only e4m3 / e5m2 fp8 formats exist")
    return _FP8[type]


def div(a, v):
    """a / v, v a Python number, as a true division on every device: a
    CUDA tensor divided by a Python scalar is multiplied by its reciprocal,
    which can differ from the quotient in the last bit; a 0-d tensor on a's
    device divides."""
    return a / a.new_tensor(v)


def _axis_shape(scale, ndim, axis):
    if axis is None or axis < 0 or scale.dim() == 0:
        return scale
    shape = [1] * ndim
    shape[axis] = scale.numel()
    return scale.reshape(shape)


def _fp8_scale(scale, axis, ndim):
    if scale.dim() > 1:
        raise NotImplementedError(
            "fp8 formats support tensor-wise or per-channel scales; "
            "group-wise (2-D) scales are int-format only")
    return _axis_shape(scale, ndim, axis)


def fake_fp8_quant(x, scale, axis=-1, type="e4m3"):
    """Scale into the fp8 grid, round through the fp8 storage dtype, and
    return in x's dtype, still scaled (pair with fake_fp8_dequant).
    Zero-scale entries pass through unquantized."""
    fmax, fp8_dtype = fp8_limits(type)
    s = _fp8_scale(scale, axis, x.dim())
    a32 = x.float()
    safe = torch.where(s > 0, s, 1.0)
    scaled = torch.clamp(a32 * fmax / safe, -fmax, fmax)
    q = scaled.to(getattr(torch, fp8_dtype)).float()
    return torch.where(s > 0, q, a32).to(x.dtype)


def fake_fp8_dequant(x, scale, axis=-1, type="e4m3"):
    fmax, _ = fp8_limits(type)
    s = _fp8_scale(scale, axis, x.dim())
    a32 = x.float()
    return torch.where(s > 0, div(a32, fmax) * s, a32).to(x.dtype)


def _parse_bits(bit_length):
    """-> (qmax, fp8 type or None). Integer grids are symmetric."""
    if isinstance(bit_length, (tuple, list)):
        if tuple(bit_length) == (4, 3):
            return 448.0, "e4m3"
        if tuple(bit_length) == (5, 2):
            return 57344.0, "e5m2"
        raise NotImplementedError(
            "only float8 formats (4,3)=e4m3 and (5,2)=e5m2 are supported "
            "as tuple quant_bits")
    return float((1 << (int(bit_length) - 1)) - 1), None


def _as_f32(v, device):
    """A float32 tensor of `v` (tensor, array or number): on `device` when
    given, else on a tensor's own device, else on the package's."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device or v.device, dtype=torch.float32)
    return torch.as_tensor(v, dtype=torch.float32,
                           device=resolve_device(device))


class _ScaledFormat(Layer):
    """Shared scale / zero-point handling of the format layers."""

    def __init__(self, scales, zero_point, quant_axis, bit_length,
                 group_size, device=None):
        super().__init__()
        s = _as_f32(scales, device)
        self.register_buffer("_scales", s, persistent=False)
        z = (_as_f32(zero_point, s.device) if zero_point is not None
             else torch.zeros((), device=s.device))
        self.register_buffer("_zero_point", z, persistent=False)
        self._quant_axis = -1 if quant_axis is None else quant_axis
        self._qmax, self._fp8 = _parse_bits(bit_length)
        self._group_size = group_size
        if self._fp8 is not None and zero_point is not None and \
                bool(torch.any(z != 0)):
            raise NotImplementedError(
                "fp8 formats are symmetric; zero_point must be 0/None")

    def _prep(self, a):
        """(scale, zero point) broadcastable against `a`: along
        quant_axis for 1-D scales, one row of scales per `group_size`
        input rows for 2-D ones."""
        s, z = self._scales, self._zero_point
        if s.dim() > 1:
            s = s.repeat_interleave(self._group_size, 0)[:a.shape[0]]
            if z.dim() > 1:
                z = z.repeat_interleave(self._group_size, 0)[:a.shape[0]]
            return s, z
        return (_axis_shape(s, a.dim(), self._quant_axis),
                _axis_shape(z, a.dim(), self._quant_axis))


class LinearQuanter(_ScaledFormat):
    """x -> its quantized grid (integer levels or fp8), in x's dtype.
    Integer output is symmetric, in [-qmax, qmax]."""

    def __init__(self, scales, zero_point=None, quant_axis=None,
                 bit_length=8, group_size=128, *, device=None):
        super().__init__(scales, zero_point, quant_axis, bit_length,
                         group_size, device)

    def forward(self, x):
        if self._fp8 is not None:
            return fake_fp8_quant(x, self._scales, self._quant_axis,
                                  self._fp8)
        s, z = self._prep(x)
        a32 = x.float()
        safe = torch.where(s > 0, s, 1.0)
        q = torch.clamp(torch.round(a32 / safe * self._qmax) + z,
                        -self._qmax, self._qmax)
        return torch.where(s > 0, q, a32).to(x.dtype)

    @staticmethod
    def from_quanter(quanter):
        return LinearQuanter(quanter.scales(), quant_axis=None,
                             bit_length=quanter.bit_length())


class LinearDequanter(_ScaledFormat):
    """The inverse of LinearQuanter, linear and unclipped."""

    def __init__(self, scales, zero_point=None, quant_axis=None,
                 bit_length=8, group_size=128, *, device=None):
        super().__init__(scales, zero_point, quant_axis, bit_length,
                         group_size, device)

    def forward(self, x):
        if self._fp8 is not None:
            return fake_fp8_dequant(x, self._scales, self._quant_axis,
                                    self._fp8)
        s, z = self._prep(x)
        a32 = x.float()
        return torch.where(s > 0, div((a32 - z) * s, self._qmax),
                           a32).to(x.dtype)

    @staticmethod
    def from_quanter(quanter):
        return LinearDequanter(quanter.scales(), quant_axis=None,
                               bit_length=quanter.bit_length())


class LinearQuanterDequanter(Layer):
    """A quanter then a dequanter: the deployed form of a trained
    fake-quanter."""

    def __init__(self, quanter, dequanter):
        super().__init__()
        self._quanter = quanter
        self._dequanter = dequanter

    def forward(self, x):
        out = x
        if self._quanter is not None:
            out = self._quanter(out)
        if self._dequanter is not None:
            out = self._dequanter(out)
        return out

    @staticmethod
    def from_quanter(quanter):
        return LinearQuanterDequanter(LinearQuanter.from_quanter(quanter),
                                      LinearDequanter.from_quanter(quanter))
