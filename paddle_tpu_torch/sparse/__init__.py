"""Sparse tensors. reference: paddle_tpu/sparse/__init__.py
(`SparseCooTensor` :43, `SparseCsrTensor` :150, `coalesce` :272, the unary
family :308, the elementwise family :457, `matmul` :509, `masked_matmul`
:548, `addmm`, `mask_as`, `pca_lowrank`).

The two formats are the port's own small classes holding torch tensors,
not torch.sparse layouts: a COO tensor is (indices [sparse_ndim, nnz],
values [nnz, *dense_dims]), a CSR matrix (crows, cols, values). The math is
gathers and index-adds on those tensors, as the reference's is gathers and
segment sums: sparse @ dense gathers dense[cols] * values and sums them by
row (`index_add`), dense @ sparse the same by column, SDDMM gathers the
two operands' rows at the pattern. Values are ordinary tensors, so
autograd flows through every value-wise op. A COO tensor's indices keep
the integer dtype they are given (int64 from lists, torch's index dtype;
the reference casts to int32). Index bookkeeping (coalesce, reshape, the
CSR row ids) runs on the indices' device; reading the nnz of a pattern
built by a function (coalesce, nonzero) is one host read.
"""

from __future__ import annotations

import math as _math

import torch

from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype, default_float

__all__ = [
    "SparseCooTensor", "SparseCsrTensor",
    "sparse_coo_tensor", "sparse_csr_tensor",
    "is_same_shape",
    # unary
    "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
    "sqrt", "square", "log1p", "abs", "expm1", "relu", "relu6",
    "leaky_relu", "neg", "pow", "cast", "rad2deg", "deg2rad", "coalesce",
    "sum", "transpose", "reshape", "isnan", "slice",
    # binary / multiary
    "add", "subtract", "multiply", "divide", "matmul", "masked_matmul",
    "mv", "addmm", "mask_as", "pca_lowrank",
]


def _index(t, device=None):
    """An integer index tensor: `t`'s own integer dtype, int64 otherwise."""
    t = torch.as_tensor(t, device=device)
    return t.long() if t.dtype.is_floating_point or t.dtype == torch.bool \
        else t


def _linear(indices, shape):
    """Row-major linear ids (int64) of index columns in `shape`."""
    lin = torch.zeros(indices.shape[1], dtype=torch.int64,
                      device=indices.device)
    for d in range(indices.shape[0]):
        lin = lin * int(shape[d]) + indices[d].long()
    return lin


def _unlinear(lin, shape):
    """The index columns [len(shape), n] of row-major linear ids."""
    out = []
    for s in reversed(shape):
        out.append(lin % int(s))
        lin = lin // int(s)
    return torch.stack(out[::-1]) if out else lin.new_zeros((0, lin.numel()))


class SparseCooTensor:
    """COO sparse tensor: indices [sparse_ndim, nnz] and values
    [nnz, *dense_dims]."""

    def __init__(self, indices, values, shape, coalesced=False):
        self._values = values if isinstance(values, torch.Tensor) else \
            torch.as_tensor(values)
        self._indices = _index(indices, self._values.device)
        self._shape = tuple(int(s) for s in shape)
        self._coalesced = coalesced

    # -- the reference's Tensor-like surface ------------------------------
    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device(self):
        return self._values.device

    @property
    def ndim(self):
        return len(self._shape)

    def nnz(self):
        return int(self._indices.shape[1])

    def indices(self):
        return self._indices

    def values(self):
        return self._values

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def is_sparse(self):
        return True

    @property
    def stop_gradient(self):
        return not self._values.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        self._values.requires_grad_(not v)

    def to_dense(self):
        out = torch.zeros(self._shape, dtype=self._values.dtype,
                          device=self._values.device)
        idx = tuple(self._indices[d].long()
                    for d in range(self._indices.shape[0]))
        return out.index_put(idx, self._values, accumulate=True)

    def to_sparse_csr(self):
        return _coo_to_csr(self)

    def to_sparse_coo(self, sparse_dim=None):
        return self

    def coalesce(self):
        return coalesce(self)

    def astype(self, dtype):
        return SparseCooTensor(self._indices,
                               self._values.to(convert_dtype(dtype)),
                               self._shape, self._coalesced)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def backward(self, *a, **k):
        raise RuntimeError("call backward() on a dense scalar loss")

    def __repr__(self):
        return (f"SparseCooTensor(shape={self._shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __mul__(self, other):
        return multiply(self, other)

    def __truediv__(self, other):
        return divide(self, other)

    def __neg__(self):
        return neg(self)

    def __matmul__(self, other):
        return matmul(self, other)

    def T(self):
        return transpose(self, list(range(self.ndim))[::-1])


class SparseCsrTensor:
    """CSR sparse matrix (2-D, or batched 3-D as a container)."""

    def __init__(self, crows, cols, values, shape):
        self._values = values if isinstance(values, torch.Tensor) else \
            torch.as_tensor(values)
        self._crows = _index(crows, self._values.device)
        self._cols = _index(cols, self._values.device)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device(self):
        return self._values.device

    @property
    def ndim(self):
        return len(self._shape)

    def nnz(self):
        return int(self._cols.shape[-1])

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def values(self):
        return self._values

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def is_sparse(self):
        return True

    def to_sparse_coo(self, sparse_dim=None):
        return _csr_to_coo(self)

    def to_sparse_csr(self):
        return self

    def to_dense(self):
        return _csr_to_coo(self).to_dense()

    def astype(self, dtype):
        return SparseCsrTensor(self._crows, self._cols,
                               self._values.to(convert_dtype(dtype)),
                               self._shape)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self._shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


def _sparse(x):
    return isinstance(x, (SparseCooTensor, SparseCsrTensor))


def _row_ids_from_crows(crows, nnz):
    """rows[k] = the number of crows[1:] entries <= k."""
    pos = torch.arange(nnz, device=crows.device, dtype=crows.dtype)
    return torch.searchsorted(crows[1:].contiguous(), pos, right=True)


def _csr_to_coo(t: SparseCsrTensor) -> SparseCooTensor:
    if len(t._shape) == 2:
        rows = _row_ids_from_crows(t._crows, t.nnz()).to(t._cols.dtype)
        return SparseCooTensor(torch.stack([rows, t._cols]), t._values,
                               t._shape, coalesced=True)
    raise NotImplementedError("batched CSR->COO not implemented")


def _coo_to_csr(t: SparseCooTensor) -> SparseCsrTensor:
    if len(t._shape) != 2 or t._indices.shape[0] != 2:
        raise NotImplementedError("to_sparse_csr: 2D only")
    t = coalesce(t)
    rows, cols = t._indices[0], t._indices[1]
    counts = torch.bincount(rows.long(), minlength=t._shape[0])
    crows = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SparseCsrTensor(crows.to(cols.dtype), cols, t._values, t._shape)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _values_on(values, dtype, place):
    if isinstance(values, torch.Tensor):
        vals = values if place is None else values.to(resolve_device(place))
    else:
        vals = torch.as_tensor(values, device=resolve_device(place))
        if dtype is None and vals.dtype.is_floating_point:
            vals = vals.to(default_float())
    if dtype is not None:
        vals = vals.to(convert_dtype(dtype))
    return vals


def _grad_flag(vals, stop_gradient):
    """The reference sets the values' stop_gradient: True cuts them from
    the graph, False lets gradients reach them."""
    if stop_gradient:
        return vals.detach()
    if vals.is_leaf and (vals.is_floating_point() or vals.is_complex()):
        vals.requires_grad_(True)
    return vals


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A COO tensor of `values` at `indices` (on `place`, else the values'
    device, else the default device). Without `shape`: one past the
    largest index of each sparse dim (a host read), then the values'
    dense dims."""
    vals = _grad_flag(_values_on(values, dtype, place), stop_gradient)
    idx = _index(indices, vals.device)
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.amax(1).tolist()) + \
            tuple(vals.shape[1:])
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    vals = _grad_flag(_values_on(values, dtype, place), stop_gradient)
    return SparseCsrTensor(crows, cols, vals, shape)


def is_same_shape(x, y):
    return list(x.shape) == list(y.shape)


def coalesce(x: SparseCooTensor, name=None):
    """Merge duplicate indices, sorted row-major: the duplicates' values
    summed (index_add over the unique linear ids)."""
    if x._coalesced:
        return x
    sp = x._indices.shape[0]
    lin = _linear(x._indices, x._shape[:sp])
    uniq, inv = torch.unique(lin, sorted=True, return_inverse=True)
    vals = x._values.new_zeros((uniq.numel(),) + tuple(x._values.shape[1:]))
    vals = vals.index_add(0, inv, x._values)
    idx = _unlinear(uniq, x._shape[:sp]).to(x._indices.dtype)
    return SparseCooTensor(idx, vals, x._shape, coalesced=True)


# ---------------------------------------------------------------------------
# unary ops (zero-preserving: they act on the values)
# ---------------------------------------------------------------------------

def _unary(opname, f):
    def op(x, name=None):
        if isinstance(x, SparseCooTensor):
            return SparseCooTensor(x._indices, f(x._values), x._shape,
                                   x._coalesced)
        if isinstance(x, SparseCsrTensor):
            return SparseCsrTensor(x._crows, x._cols, f(x._values), x._shape)
        return f(x)
    op.__name__ = opname
    op.__doc__ = f"{opname} of the stored values (a dense tensor as it is)."
    return op


sin = _unary("sin", torch.sin)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
atanh = _unary("atanh", torch.atanh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
log1p = _unary("log1p", torch.log1p)
abs = _unary("abs", torch.abs)
expm1 = _unary("expm1", torch.expm1)
relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", lambda v: torch.clamp(v, 0, 6))
neg = _unary("neg", torch.neg)
rad2deg = _unary("rad2deg", torch.rad2deg)
deg2rad = _unary("deg2rad", torch.deg2rad)
isnan = _unary("isnan", torch.isnan)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _unary("leaky_relu", lambda v: torch.where(
        v >= 0, v, v * negative_slope))(x)


def pow(x, factor, name=None):
    return _unary("pow", lambda v: torch.pow(v, factor))(x)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    ix = (lambda t: t) if index_dtype is None else \
        (lambda t: t.to(convert_dtype(index_dtype)))
    vals = x._values if value_dtype is None else \
        x._values.to(convert_dtype(value_dtype))
    if isinstance(x, SparseCooTensor):
        return SparseCooTensor(ix(x._indices), vals, x._shape, x._coalesced)
    return SparseCsrTensor(ix(x._crows), ix(x._cols), vals, x._shape)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Sparse in, sparse out over an axis (the surviving coordinates
    merged by coalesce); the dense scalar over all of them."""
    want_csr = isinstance(x, SparseCsrTensor)
    coo = x.to_sparse_coo() if want_csr else x
    if dtype is not None:
        coo = coo.astype(dtype)
    if axis is None:
        return coo._values.sum()
    ndim = len(coo._shape)
    ax = axis + ndim if axis < 0 else axis
    if keepdim:
        new_idx = coo._indices.clone()
        new_idx[ax] = 0
        new_shape = tuple(1 if d == ax else s
                          for d, s in enumerate(coo._shape))
    else:
        keep = [d for d in range(ndim) if d != ax]
        new_idx = coo._indices[keep]
        new_shape = tuple(coo._shape[d] for d in keep)
    out = coalesce(SparseCooTensor(new_idx, coo._values, new_shape))
    return out.to_sparse_csr() if want_csr and len(new_shape) == 2 else out


def transpose(x, perm, name=None):
    coo = x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x
    out = SparseCooTensor(coo._indices[list(perm)], coo._values,
                          tuple(coo._shape[p] for p in perm))
    return out.to_sparse_csr() if isinstance(x, SparseCsrTensor) else out


def reshape(x, shape, name=None):
    """The sparse coordinates linearised in the old shape and unfolded in
    the new one (int64, on the indices' device)."""
    coo = x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x
    shape = list(shape)
    numel = _math.prod(coo._shape)
    if -1 in shape:
        shape[shape.index(-1)] = numel // -_math.prod(shape)
    sp = coo._indices.shape[0]
    lin = _linear(coo._indices, coo._shape[:sp])
    out = SparseCooTensor(_unlinear(lin, shape).to(coo._indices.dtype),
                          coo._values, tuple(shape))
    return out.to_sparse_csr() if isinstance(x, SparseCsrTensor) else out


def slice(x, axes, starts, ends, name=None):
    from ..tensor import manipulation as _man
    return _dense_to_coo(_man.slice(x.to_dense(), axes, starts, ends))


def _dense_to_coo(t, sparse_dim=None):
    """Every nonzero of dense `t` (all dims sparse), row-major."""
    idx = torch.nonzero(t).T
    return SparseCooTensor(idx, t[tuple(idx)], tuple(t.shape),
                           coalesced=True)


# ---------------------------------------------------------------------------
# binary / multiary
# ---------------------------------------------------------------------------

def _ewise(opname, f, x, y):
    xs, ys = _sparse(x), _sparse(y)
    want_csr = isinstance(x, SparseCsrTensor) or (
        not xs and isinstance(y, SparseCsrTensor))
    if xs and ys:
        if tuple(x.shape) != tuple(y.shape):
            raise ValueError(
                f"sparse {opname}: operand shapes must match, got "
                f"{tuple(x.shape)} vs {tuple(y.shape)}")
        a, b = coalesce(x.to_sparse_coo()), coalesce(y.to_sparse_coo())
        if opname in ("add", "subtract"):
            # the union of the patterns: both concatenated, then coalesced
            vb = b._values if opname == "add" else -b._values
            out = coalesce(SparseCooTensor(
                torch.cat([a._indices, b._indices.to(a._indices.dtype)], 1),
                torch.cat([a._values, vb]), a._shape))
        else:
            # multiply and divide need aligned patterns: densified
            out = _dense_to_coo(f(a.to_dense(), b.to_dense()))
        return out.to_sparse_csr() if want_csr else out
    return f(x.to_dense() if xs else x, y.to_dense() if ys else y)


def add(x, y, name=None):
    return _ewise("add", torch.add, x, y)


def subtract(x, y, name=None):
    return _ewise("subtract", torch.subtract, x, y)


def multiply(x, y, name=None):
    return _ewise("multiply", torch.multiply, x, y)


def divide(x, y, name=None):
    return _ewise("divide", torch.divide, x, y)


def matmul(x, y, name=None):
    """sparse @ dense -> dense: dense[cols] * values summed by row
    (index_add); dense @ sparse the same by column; dense @ dense the
    port's matmul. The sums are atomic on CUDA, so their order (and a
    float result's last bits) varies between runs."""
    if _sparse(x):
        coo = coalesce(x.to_sparse_coo())
        if len(coo._shape) != 2:
            raise NotImplementedError("sparse matmul: 2D only")
        rows, cols = coo._indices[0].long(), coo._indices[1].long()
        gathered = y[cols] * coo._values[:, None]            # [nnz, N]
        out = gathered.new_zeros((coo._shape[0],) + tuple(y.shape[1:]))
        return out.index_add(0, rows, gathered)
    if _sparse(y):
        coo = coalesce(y.to_sparse_coo())
        rows, cols = coo._indices[0].long(), coo._indices[1].long()
        gathered = x[:, rows] * coo._values[None, :]         # [M, nnz]
        out = gathered.new_zeros((coo._shape[1], x.shape[0]))
        return out.index_add(0, cols, gathered.T).T
    from ..tensor.math import matmul as _dense
    return _dense(x, y)


def mv(x, vec, name=None):
    coo = coalesce(x.to_sparse_coo())
    rows, cols = coo._indices[0].long(), coo._indices[1].long()
    prod = coo._values * vec[cols]
    return prod.new_zeros(coo._shape[0]).index_add(0, rows, prod)


def masked_matmul(x, y, mask, name=None):
    """(x @ y) at `mask`'s pattern only (SDDMM): each stored value is
    x[row] . y[:, col]."""
    coo = coalesce(mask.to_sparse_coo())
    rows, cols = coo._indices[0].long(), coo._indices[1].long()
    vals = (x[rows, :] * y.T[cols, :]).sum(-1)
    out = SparseCooTensor(coo._indices, vals, coo._shape, coalesced=True)
    return out.to_sparse_csr() if isinstance(mask, SparseCsrTensor) else out


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    prod = matmul(x, y)
    dense_in = input.to_dense() if _sparse(input) else input
    return beta * dense_in + alpha * prod


def mask_as(x, mask, name=None):
    """Dense `x`'s values at `mask`'s pattern, in `mask`'s format."""
    coo = mask.to_sparse_coo() if isinstance(mask, SparseCsrTensor) else mask
    idx = tuple(coo._indices[d].long() for d in range(coo._indices.shape[0]))
    out = SparseCooTensor(coo._indices, x[idx], coo._shape,
                          coalesced=coo._coalesced)
    return out.to_sparse_csr() if isinstance(mask, SparseCsrTensor) else out


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The dense pca_lowrank of the densified input."""
    from ..tensor.linalg import pca_lowrank as _dense_pca
    dense = x.to_dense() if hasattr(x, "to_dense") else x
    return _dense_pca(dense, q=q, center=center, niter=niter)


from . import nn  # noqa: E402,F401
