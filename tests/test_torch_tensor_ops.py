"""The port's tensor functions (tensor/{attribute,creation,logic,search,
manipulation}.py) against the reference's, one parametrised case per
function (more where an argument changes the path). Inputs come from a
numpy seed; the same arrays go to both. Floats are held at rtol 1e-6,
atol 1e-6; integers and bools exactly. Integer dtypes are compared by
kind: the reference's are int32 where JAX runs without 64-bit types, the
port's int64 as Paddle's."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
R = np.random.default_rng(0)
X = R.standard_normal((3, 4)).astype(np.float32)
Y = R.standard_normal((3, 4)).astype(np.float32)
V = R.standard_normal(4).astype(np.float32)
M = R.standard_normal((4, 4)).astype(np.float32)
X3 = R.standard_normal((2, 3, 4)).astype(np.float32)
X4 = R.standard_normal((2, 2, 3, 3)).astype(np.float32)
I = R.integers(0, 5, (3, 4)).astype(np.int64)
J = R.integers(0, 5, (3, 4)).astype(np.int64)
B = X > 0
C = (X + 1j * Y).astype(np.complex64)
IDX = np.array([2, 0], np.int64)
SEQ = np.sort(R.standard_normal(6).astype(np.float32))
PERM = np.argsort(R.standard_normal((3, 4)), axis=1).astype(np.int64)


class Arr:
    """Marks an argument that goes in as each package's tensor."""

    def __init__(self, a):
        self.a = a


def A(a):
    return Arr(a)


def _conv(v, port):
    if isinstance(v, Arr):
        return torch.tensor(v.a) if port else paddle.to_tensor(v.a)
    if isinstance(v, list) and v and isinstance(v[0], Arr):
        return [_conv(e, port) for e in v]
    return v


def _np(out):
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    if hasattr(out, "_data"):
        return np.asarray(out._data)
    if isinstance(out, (tuple, list)):
        return [_np(o) for o in out]
    return out


def _same(p, r, where="out"):
    if isinstance(r, list):
        assert isinstance(p, list) and len(p) == len(r), where
        for i, (a, b) in enumerate(zip(p, r)):
            _same(a, b, f"{where}[{i}]")
        return
    if not isinstance(r, np.ndarray):
        assert p == r, where
        return
    assert isinstance(p, np.ndarray), where
    assert p.shape == r.shape, (where, p.shape, r.shape)
    assert p.dtype.kind == r.dtype.kind, (where, p.dtype, r.dtype)
    if r.dtype.kind in "fc":
        np.testing.assert_allclose(p, r, err_msg=where, **TOL)
    else:
        np.testing.assert_array_equal(p, r, err_msg=where)


# (id, function, args, kwargs, port-only kwargs)
CASES = [
    # attribute
    ("rank", "rank", [A(X3)], {}),
    ("shape", "shape", [A(X3)], {}),
    ("is_complex", "is_complex", [A(C)], {}),
    ("is_floating_point", "is_floating_point", [A(X)], {}),
    ("is_integer", "is_integer", [A(I)], {}),
    ("real", "real", [A(C)], {}),
    ("imag", "imag", [A(C)], {}),
    ("is_tensor", "is_tensor", [A(X)], {}),
    # creation
    ("to_tensor", "to_tensor", [[[1.0, 2.0], [3.0, 4.0]]],
     {"place": "cpu"}),
    ("to_tensor_dtype", "to_tensor", [[1, 2, 3]],
     {"dtype": "float32", "place": "cpu"}),
    ("zeros", "zeros", [[2, 3]], {}, {"device": "cpu"}),
    ("zeros_like", "zeros_like", [A(X)], {}),
    ("ones", "ones", [[2, 3], "int64"], {}, {"device": "cpu"}),
    ("ones_like", "ones_like", [A(I)], {}),
    ("full", "full", [[2, 2], 3.5], {}, {"device": "cpu"}),
    ("full_bool", "full", [[2], True], {}, {"device": "cpu"}),
    ("full_like", "full_like", [A(X), 2.0], {}),
    ("arange_float", "arange", [0, 5, 0.5], {}, {"device": "cpu"}),
    ("arange_int", "arange", [7], {}, {"device": "cpu"}),
    ("linspace", "linspace", [0.0, 1.0, 5], {}, {"device": "cpu"}),
    ("logspace", "logspace", [0.0, 2.0, 4], {}, {"device": "cpu"}),
    ("eye", "eye", [3, 4], {}, {"device": "cpu"}),
    ("empty", "empty", [[2, 2]], {}, {"device": "cpu"}),
    ("empty_like", "empty_like", [A(X)], {}),
    ("tril", "tril", [A(M), 1], {}),
    ("triu", "triu", [A(M), -1], {}),
    ("diag_vector", "diag", [A(V), 1, 9.0], {}),
    ("diag_matrix", "diag", [A(M), -1], {}),
    ("diagflat", "diagflat", [A(V), 1], {}),
    ("meshgrid", "meshgrid", [A(V), A(SEQ)], {}),
    ("assign", "assign", [A(X)], {}),
    ("clone", "clone", [A(X)], {}),
    ("tril_indices", "tril_indices", [4, 3, 1], {}, {"device": "cpu"}),
    ("triu_indices", "triu_indices", [4, None, 0], {}, {"device": "cpu"}),
    ("one_hot", "one_hot", [A(I), 5], {}),
    ("complex", "complex", [A(X), A(Y)], {}),
    ("polar", "polar", [A(np.abs(X)), A(Y)], {}),
    ("create_tensor", "create_tensor", ["float32"], {}, {"device": "cpu"}),
    # logic
    *[(n, n, [A(X), A(Y)], {}) for n in (
        "equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal")],
    ("equal_scalar", "equal", [A(I), 3], {}),
    *[(n, n, [A(B), A(Y > 0)], {}) for n in (
        "logical_and", "logical_or", "logical_xor")],
    ("logical_not", "logical_not", [A(B)], {}),
    *[(n, n, [A(I), A(J)], {}) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
        "bitwise_right_shift")],
    ("bitwise_not", "bitwise_not", [A(I)], {}),
    ("logic_is_tensor", "is_tensor", [3.0], {}),
    ("is_empty", "is_empty", [A(X[:0])], {}),
    ("equal_all", "equal_all", [A(X), A(X.copy())], {}),
    ("equal_all_differs", "equal_all", [A(X), A(Y)], {}),
    # search
    ("argmax", "argmax", [A(X), 1], {}),
    ("argmax_flat_keepdim", "argmax", [A(X)], {"keepdim": True}),
    ("argmin", "argmin", [A(X), 0], {"keepdim": True}),
    ("argsort", "argsort", [A(X), 0, True], {}),
    ("sort", "sort", [A(X)], {}),
    ("topk", "topk", [A(X), 2], {}),
    ("topk_smallest_axis0", "topk", [A(X), 2, 0, False], {}),
    ("top_k", "top_k", [A(X), 3], {}),
    ("searchsorted", "searchsorted", [A(SEQ), A(V)], {}),
    ("searchsorted_right_int32", "searchsorted", [A(SEQ), A(V), True, True],
     {}),
    ("bucketize", "bucketize", [A(V), A(SEQ)], {"right": True}),
    ("index_sample", "index_sample", [A(X), A(PERM[:, :2])], {}),
    ("masked_select", "masked_select", [A(X), A(B)], {}),
    ("nonzero", "nonzero", [A(B)], {}),
    ("nonzero_tuple", "nonzero", [A(B), True], {}),
    ("where", "where", [A(B), A(X), A(Y)], {}),
    ("where_one_arg", "where", [A(B)], {}),
    ("mode", "mode", [A(I), 1], {}),
    ("mode_axis0_keepdim", "mode", [A(I), 0, True], {}),
    ("kthvalue", "kthvalue", [A(X), 2], {}),
    ("unique", "unique", [A(I)],
     {"return_index": True, "return_inverse": True, "return_counts": True}),
    ("unique_plain", "unique", [A(I)], {}),
    ("unique_consecutive", "unique_consecutive",
     [A(np.array([1, 1, 2, 2, 2, 3, 1, 1]))],
     {"return_inverse": True, "return_counts": True}),
    ("unique_consecutive_axis", "unique_consecutive",
     [A(np.array([1, 1, 3, 1]))], {"axis": 0, "return_counts": True}),
    # manipulation
    ("reshape", "reshape", [A(X), [4, -1]], {}),
    ("reshape_", "reshape_", [A(X), [2, 6]], {}),
    ("flatten", "flatten", [A(X3), 1], {}),
    ("flatten_", "flatten_", [A(X3)], {}),
    ("transpose", "transpose", [A(X3), [2, 0, 1]], {}),
    ("squeeze", "squeeze", [A(X[:, None, :1])], {}),
    ("squeeze_axis", "squeeze", [A(X[:, None, :1]), [1, 0]], {}),
    ("squeeze_", "squeeze_", [A(X[:, None]), 1], {}),
    ("unsqueeze", "unsqueeze", [A(X), [0, -1]], {}),
    ("unsqueeze_", "unsqueeze_", [A(X), 1], {}),
    ("concat", "concat", [[A(X), A(Y)], 1], {}),
    ("stack", "stack", [[A(X), A(Y)], 1], {}),
    ("split", "split", [A(X), [1, -1], 1], {}),
    ("split_equal", "split", [A(X), 2, 1], {}),
    ("chunk", "chunk", [A(X), 2, 1], {}),
    ("tile", "tile", [A(V), [2, 1]], {}),
    ("expand", "expand", [A(V[None]), [3, -1]], {}),
    ("expand_as", "expand_as", [A(V), A(X)], {}),
    ("broadcast_to", "broadcast_to", [A(V), [2, 4]], {}),
    ("broadcast_tensors", "broadcast_tensors", [[A(V), A(X)]], {}),
    ("flip", "flip", [A(X), [0, 1]], {}),
    ("rot90", "rot90", [A(X), 3], {}),
    ("roll", "roll", [A(X), 1, 1], {}),
    ("roll_flat", "roll", [A(X), 2], {}),
    ("gather", "gather", [A(X), A(IDX)], {}),
    ("gather_axis1_2d", "gather", [A(X), A(np.array([[3], [1]]))],
     {"axis": 1}),
    ("gather_nd", "gather_nd", [A(X3), A(np.array([[0, 1], [1, 2]]))], {}),
    ("scatter", "scatter", [A(X), A(IDX), A(Y[:2])], {}),
    ("scatter_add", "scatter", [A(X), A(np.array([1, 1, 0])), A(Y)],
     {"overwrite": False}),
    ("scatter_nd", "scatter_nd", [A(np.array([[1], [3], [1]])), A(V[:3]),
                                  [5]], {}),
    ("scatter_nd_add", "scatter_nd_add",
     [A(X), A(np.array([[0, 1], [2, 3], [0, 1]])), A(V[:3])], {}),
    ("index_select", "index_select", [A(X), A(IDX), 0], {}),
    ("index_select_axis1", "index_select", [A(X), A(np.array([3, 3, 0])),
                                            1], {}),
    ("index_add", "index_add", [A(X), A(np.array([0, 2])), 1, A(Y[:, :2])],
     {}),
    ("index_put", "index_put",
     [A(X), (A(np.array([0, 2])), A(np.array([1, 3]))), A(V[:2])], {}),
    ("index_put_acc", "index_put",
     [A(X), (A(np.array([0, 0])), A(np.array([1, 1]))), A(V[:2]), True], {}),
    ("take_along_axis", "take_along_axis", [A(X), A(PERM), 1], {}),
    ("take_along_axis_bcast", "take_along_axis",
     [A(X3), A(PERM[None, :, :2]), 2], {}),
    ("put_along_axis", "put_along_axis", [A(X), A(PERM), A(Y), 1], {}),
    ("put_along_axis_add", "put_along_axis",
     [A(X), A(PERM[:, :2]), A(Y[:, :2]), 1, "add"], {}),
    ("put_along_axis_mul", "put_along_axis",
     [A(X), A(PERM[:, :2]), A(Y[:, :2]), 1, "mul"], {}),
    ("masked_fill", "masked_fill", [A(X), A(B), 7.0], {}),
    ("slice", "slice", [A(X3), [0, 2], [1, -3], [2, 10]], {}),
    ("strided_slice", "strided_slice", [A(X3), [1, 2], [0, 3], [3, 0],
                                        [2, -2]], {}),
    ("unbind", "unbind", [A(X3), 1], {}),
    ("unstack", "unstack", [A(X3)], {}),
    ("pad_constant", "pad", [A(X4), [1, 0, 2, 1]], {"value": 3.0}),
    ("pad_reflect", "pad", [A(X4), [1, 2, 2, 1]], {"mode": "reflect"}),
    ("pad_replicate_nhwc", "pad", [A(X4), [1, 1, 0, 2]],
     {"mode": "replicate", "data_format": "NHWC"}),
    ("pad_circular_full", "pad", [A(X), [1, 1, 2, 0]],
     {"mode": "circular"}),
    ("repeat_interleave", "repeat_interleave", [A(X), 2, 1], {}),
    ("repeat_interleave_flat", "repeat_interleave", [A(V), 3], {}),
    ("moveaxis", "moveaxis", [A(X3), 0, 2], {}),
    ("swapaxes", "swapaxes", [A(X3), 0, 2], {}),
    ("as_complex", "as_complex", [A(X3[..., :2].copy())], {}),
    ("as_real", "as_real", [A(C)], {}),
    ("view_shape", "view", [A(X), [6, 2]], {}),
    ("view_dtype", "view", [A(X), "float64"], {}),
    ("view_as", "view_as", [A(X), A(M[:3].reshape(2, 6))], {}),
    ("atleast_1d", "atleast_1d", [A(np.float32(2.0))], {}),
    ("atleast_2d", "atleast_2d", [A(V), A(X)], {}),
    ("atleast_3d", "atleast_3d", [A(V)], {}),
    ("tensor_split", "tensor_split", [A(X), 3, 1], {}),
    ("tensor_split_indices", "tensor_split", [A(X), [1, 3], 1], {}),
    ("hsplit", "hsplit", [A(X), 2], {}),
    ("vsplit", "vsplit", [A(X), 3], {}),
    ("dsplit", "dsplit", [A(X3), 2], {}),
    ("hstack", "hstack", [[A(X), A(Y)]], {}),
    ("vstack", "vstack", [[A(V), A(V)]], {}),
    ("dstack", "dstack", [[A(X), A(Y)]], {}),
    ("column_stack", "column_stack", [[A(V), A(V)]], {}),
    ("row_stack", "row_stack", [[A(X), A(Y)]], {}),
    ("unflatten", "unflatten", [A(X), 1, [2, 2]], {}),
    ("unfold", "unfold", [A(X3), 2, 2, 1], {}),
    ("cast", "cast", [A(X), "int32"], {}),
    ("crop", "crop", [A(X3), [1, -1, 2], [1, 1, 1]], {}),
    ("tolist", "tolist", [A(I)], {}),
    ("numel", "numel", [A(X3)], {}),
    ("shard_index", "shard_index", [A(I), 5, 2, 1], {}),
    ("diagonal", "diagonal", [A(X3), 1, 1, 2], {}),
    ("diagonal_scatter", "diagonal_scatter", [A(M), A(V[:3]), 1], {}),
    ("select_scatter", "select_scatter", [A(X), A(V), 0, 1], {}),
    ("slice_scatter", "slice_scatter",
     [A(X), A(np.ones((3, 2), np.float32)), [1], [0], [4], [2]], {}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_reference(case):
    _, fname, args, kwargs = case[:4]
    port_only = case[4] if len(case) > 4 else {}
    r = getattr(paddle, fname)(*[_conv(a, False) if not isinstance(a, tuple)
                                 else tuple(_conv(e, False) for e in a)
                                 for a in args], **kwargs)
    p = getattr(pt, fname)(*[_conv(a, True) if not isinstance(a, tuple)
                             else tuple(_conv(e, True) for e in a)
                             for a in args], **kwargs, **port_only)
    _same(_np(p), _np(r))


def test_every_ported_name_has_a_case():
    from paddle_tpu_torch.tensor import (attribute, creation, logic,
                                         manipulation, search)
    covered = {c[1] for c in CASES} | {"top_p_sampling"}
    names = set(attribute.__all__ + creation.__all__ + logic.__all__
                + manipulation.__all__ + search.__all__)
    assert names <= covered, sorted(names - covered)


def test_top_p_sampling_stays_in_the_nucleus():
    """Draws are torch's own, so held to the reference's rule rather than
    its bits: every id lies in its row's nucleus, and one seed repeats."""
    probs = torch.softmax(torch.tensor(X * 3), -1)
    ps = torch.tensor([0.5, 0.9, 0.2])
    out = [pt.top_p_sampling(probs, ps, seed=7, return_top=True, k=2)
           for _ in range(2)]
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)
    val, ids, top_v, top_i = out[0]
    s, order = torch.sort(probs, -1, descending=True)
    before = torch.cumsum(s, -1) - s
    for row in range(3):
        nucleus = order[row][before[row] < ps[row]]
        assert int(ids[row, 0]) in nucleus.tolist()
    torch.testing.assert_close(val, probs.gather(-1, ids))
    torch.testing.assert_close(top_v, torch.topk(probs, 2, -1).values)
    with pytest.raises(ValueError):
        pt.top_p_sampling(probs, ps, mode="nucleus")


def test_unique_consecutive_rows():
    """Along an axis of a 2-D tensor, where the reference raises (its
    keep mask is flattened before `any`, search.py:175): consecutive equal
    rows collapse, as numpy's definition gives."""
    x = torch.tensor([[1, 2], [1, 2], [3, 4], [1, 2]])
    out, inv, counts = pt.unique_consecutive(x, return_inverse=True,
                                             return_counts=True, axis=0)
    assert out.tolist() == [[1, 2], [3, 4], [1, 2]]
    assert inv.tolist() == [0, 0, 1, 2] and counts.tolist() == [2, 1, 1]
