"""The port's sparse and sparse.nn against the JAX package's, on the CPU in
float32, with inputs drawn by numpy from a seed: the COO/CSR classes and
their conversions, coalesce, the unary and elementwise families, sum,
transpose, reshape, slice, matmul both ways, mv, SDDMM, addmm, mask_as,
pca_lowrank, the sparse softmax and attention, BatchNorm, Conv3D and
SubmConv3D (weights through convert.py), MaxPool3D; then chip_smoke.py's
phase-23 GCN at a small size, one training step with equal loss and
gradients (the reference's through its jitted functional_call).

Tolerances: float32 rtol 1e-5, atol 1e-6 where both packages sum in the
same order; 1e-5/1e-5 for products and softmaxes (XLA's dot against
torch's, sums in another order); the GCN step's gradients 2e-5/2e-5.
Sparsity patterns (indices, crows, cols) are equal exactly.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from paddle_tpu_torch import convert
from torch_seq_parity import (assert_grads_close, copy_weights, ref_np,
                              ref_run, reference)

EXACT = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-5, atol=2e-5)

_R = np.random.RandomState(0)
# a 5 x 6 pattern with a duplicate (1, 0) and unsorted columns
IDX = np.array([[0, 1, 1, 3, 2, 0, 4, 1], [2, 0, 5, 3, 1, 4, 0, 0]])
VALS = _R.randn(8).astype(np.float32)
SHAPE = [5, 6]
DENSE = _R.randn(6, 3).astype(np.float32)
LEFT = _R.randn(4, 5).astype(np.float32)


@pytest.fixture
def on_cpu():
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def _pair(idx=IDX, vals=VALS, shape=SHAPE):
    return (paddle.sparse.sparse_coo_tensor(idx, vals, shape),
            pt.sparse.sparse_coo_tensor(idx, vals, shape, place="cpu"))


def _ref_dense(r):
    """A reference sparse tensor's dense view, scattered with numpy (its
    own to_dense compiles an op per pattern)."""
    vals = ref_np(r.values())
    if r.is_sparse_coo():
        idx = ref_np(r.indices())
    else:
        crows = ref_np(r.crows())
        idx = np.stack([np.repeat(np.arange(len(crows) - 1),
                                  np.diff(crows)), ref_np(r.cols())])
    out = np.zeros(r.shape, vals.dtype)
    np.add.at(out, tuple(idx), vals)
    return out


def _same_coo(r, p, tol=EXACT):
    """Equal patterns (exactly), values and dense views."""
    assert type(p).__name__ == type(r).__name__
    assert list(p.shape) == list(r.shape)
    if p.is_sparse_coo():
        np.testing.assert_array_equal(p.indices().numpy(),
                                      ref_np(r.indices()))
    else:
        np.testing.assert_array_equal(p.crows().numpy(), ref_np(r.crows()))
        np.testing.assert_array_equal(p.cols().numpy(), ref_np(r.cols()))
    np.testing.assert_allclose(p.values().detach().numpy(),
                               ref_np(r.values()), **tol)
    np.testing.assert_allclose(p.to_dense().detach().numpy(), _ref_dense(r),
                               **tol)


def test_classes_and_conversions():
    r, p = _pair()
    assert p.nnz() == r.nnz() and p.is_sparse() and p.is_sparse_coo()
    assert p.dtype == torch.float32 and p.ndim == 2
    _same_coo(r.coalesce(), p.coalesce())
    rc, pc = r.to_sparse_csr(), p.to_sparse_csr()
    assert pc.is_sparse_csr() and not pc.is_sparse_coo()
    _same_coo(rc, pc)
    _same_coo(rc.to_sparse_coo(), pc.to_sparse_coo())
    np.testing.assert_allclose(p.numpy(), r.numpy(), **EXACT)
    assert pt.sparse.is_same_shape(p, pc)
    # a CSR tensor made directly; shape read from the indices
    crow, col = ref_np(rc.crows()), ref_np(rc.cols())
    val = ref_np(rc.values())
    _same_coo(paddle.sparse.sparse_csr_tensor(crow, col, val, SHAPE),
              pt.sparse.sparse_csr_tensor(crow, col, val, SHAPE,
                                          place="cpu"))
    assert pt.sparse.sparse_coo_tensor(IDX, VALS, place="cpu").shape == \
        paddle.sparse.sparse_coo_tensor(IDX, VALS).shape
    with pytest.raises(RuntimeError, match="backward"):
        p.backward()


UNARY = ["sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
         "sqrt", "square", "log1p", "abs", "expm1", "relu", "relu6", "neg",
         "rad2deg", "deg2rad", "isnan"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches_reference(name):
    # values in (0, 0.9): inside every function's domain
    vals = (np.abs(VALS) % 0.9).astype(np.float32)
    r, p = _pair(vals=vals)
    got, want = getattr(pt.sparse, name)(p), getattr(paddle.sparse, name)(r)
    np.testing.assert_array_equal(got.indices().numpy(),
                                  ref_np(want.indices()))
    np.testing.assert_allclose(got.values().numpy().astype(np.float32),
                               ref_np(want.values()).astype(np.float32),
                               **EXACT)
    # a dense tensor goes through as it is
    d = torch.tensor(vals)
    np.testing.assert_allclose(getattr(pt.sparse, name)(d).numpy().astype(
        np.float32), ref_np(getattr(paddle.sparse, name)(
            paddle.to_tensor(vals))).astype(np.float32), **EXACT)


def test_parametrised_unary_and_cast():
    r, p = _pair()
    _same_coo(paddle.sparse.leaky_relu(r, 0.2), pt.sparse.leaky_relu(p, 0.2))
    rp, pp = _pair(vals=np.abs(VALS) + 0.1)
    _same_coo(paddle.sparse.pow(rp, 1.5), pt.sparse.pow(pp, 1.5))
    rc, pc = r.to_sparse_csr(), p.to_sparse_csr()
    got = pt.sparse.cast(pc, "int32", "float64")
    want = paddle.sparse.cast(rc, "int32", "float32")
    assert got.crows().dtype == torch.int32 and got.dtype == torch.float64
    np.testing.assert_array_equal(got.cols().numpy(), ref_np(want.cols()))
    got = pt.sparse.cast(p, value_dtype="float16")
    assert got.dtype == torch.float16 and got.indices().dtype == torch.int64


@pytest.mark.parametrize("axis,keepdim", [(None, False), (0, False),
                                          (1, True), (-1, False)])
def test_sum(axis, keepdim):
    r, p = _pair()
    want = paddle.sparse.sum(r, axis=axis, keepdim=keepdim)
    got = pt.sparse.sum(p, axis=axis, keepdim=keepdim)
    if axis is None:
        np.testing.assert_allclose(got.numpy(), ref_np(want), **TOL)
    else:
        _same_coo(want, got, TOL)
    _same_coo(paddle.sparse.sum(r.to_sparse_csr(), axis=1, keepdim=True),
              pt.sparse.sum(p.to_sparse_csr(), axis=1, keepdim=True), TOL)


def test_transpose_reshape_slice():
    r, p = _pair()
    _same_coo(paddle.sparse.transpose(r, [1, 0]),
              pt.sparse.transpose(p, [1, 0]))
    _same_coo(paddle.sparse.transpose(r.to_sparse_csr(), [1, 0]),
              pt.sparse.transpose(p.to_sparse_csr(), [1, 0]))
    _same_coo(r.T(), p.T())
    for shape in ([3, 10], [-1, 5], [30]):
        _same_coo(paddle.sparse.reshape(r, shape),
                  pt.sparse.reshape(p, shape))
    _same_coo(paddle.sparse.reshape(r.to_sparse_csr(), [10, 3]),
              pt.sparse.reshape(p.to_sparse_csr(), [10, 3]))
    _same_coo(paddle.sparse.slice(r, [0, 1], [1, 0], [4, 5]),
              pt.sparse.slice(p, [0, 1], [1, 0], [4, 5]))


OTHER_IDX = np.array([[0, 2, 4, 1], [2, 1, 5, 3]])
OTHER_VALS = (_R.randn(4) + 3.0).astype(np.float32)


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide"])
def test_elementwise(name):
    r, p = _pair()
    r2, p2 = _pair(OTHER_IDX, OTHER_VALS)
    fr, fp = getattr(paddle.sparse, name), getattr(pt.sparse, name)
    _same_coo(fr(r, r2), fp(p, p2))
    _same_coo(fr(r.to_sparse_csr(), r2), fp(p.to_sparse_csr(), p2))
    # sparse with dense: a dense result
    d = (_R.randn(*SHAPE) + 3.0).astype(np.float32)
    np.testing.assert_allclose(
        fp(p, torch.tensor(d)).numpy(),
        ref_np(fr(r, paddle.to_tensor(d))), **EXACT)
    with pytest.raises(ValueError, match="shapes must match"):
        fp(p, pt.sparse.sparse_coo_tensor(IDX, VALS, [6, 6], place="cpu"))


def test_operators():
    r, p = _pair()
    r2, p2 = _pair(OTHER_IDX, OTHER_VALS)
    _same_coo(r + r2, p + p2)
    _same_coo(r - r2, p - p2)
    _same_coo(-r, -p)
    np.testing.assert_allclose((p @ torch.tensor(DENSE)).numpy(),
                               ref_np(r @ paddle.to_tensor(DENSE)), **TOL)


def test_matmul_mv_addmm():
    r, p = _pair()
    d, left = torch.tensor(DENSE), torch.tensor(LEFT)
    for x, y in ((r, paddle.to_tensor(DENSE)), (r.to_sparse_csr(),
                                                paddle.to_tensor(DENSE))):
        px = p if x.is_sparse_coo() else p.to_sparse_csr()
        np.testing.assert_allclose(pt.sparse.matmul(px, d).numpy(),
                                   ref_np(paddle.sparse.matmul(x, y)), **TOL)
    np.testing.assert_allclose(
        pt.sparse.matmul(left, p).numpy(),
        ref_np(paddle.sparse.matmul(paddle.to_tensor(LEFT), r)), **TOL)
    np.testing.assert_allclose(
        pt.sparse.matmul(left, torch.tensor(LEFT.T.copy())).numpy(),
        ref_np(paddle.sparse.matmul(paddle.to_tensor(LEFT),
                                    paddle.to_tensor(LEFT.T.copy()))), **TOL)
    v = DENSE[:, 0].copy()
    np.testing.assert_allclose(
        pt.sparse.mv(p, torch.tensor(v)).numpy(),
        ref_np(paddle.sparse.mv(r, paddle.to_tensor(v))), **TOL)
    inp = _R.randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(
        pt.sparse.addmm(torch.tensor(inp), p, d, 0.5, 2.0).numpy(),
        ref_np(paddle.sparse.addmm(paddle.to_tensor(inp), r,
                                   paddle.to_tensor(DENSE), 0.5, 2.0)), **TOL)


def test_matmul_gradients_flow_to_values_and_dense():
    """The values and the dense operand get torch's gradients of the dense
    product."""
    vals = torch.tensor(VALS, requires_grad=True)
    d = torch.tensor(DENSE, requires_grad=True)
    sp = pt.sparse.sparse_coo_tensor(IDX, vals, SHAPE, stop_gradient=False)
    (pt.sparse.matmul(sp, d) ** 2).sum().backward()
    vals2 = torch.tensor(VALS, requires_grad=True)
    d2 = torch.tensor(DENSE, requires_grad=True)
    dense = torch.zeros(SHAPE).index_put((torch.tensor(IDX[0]),
                                          torch.tensor(IDX[1])), vals2,
                                         accumulate=True)
    ((dense @ d2) ** 2).sum().backward()
    torch.testing.assert_close(vals.grad, vals2.grad)
    torch.testing.assert_close(d.grad, d2.grad)


def test_masked_matmul_mask_as_pca():
    r, p = _pair()
    x, y = LEFT.T.copy(), _R.randn(4, 6).astype(np.float32)
    for rm, pm in ((r, p), (r.to_sparse_csr(), p.to_sparse_csr())):
        _same_coo(paddle.sparse.masked_matmul(paddle.to_tensor(x),
                                              paddle.to_tensor(y), rm),
                  pt.sparse.masked_matmul(torch.tensor(x), torch.tensor(y),
                                          pm), TOL)
        d = _R.randn(*SHAPE).astype(np.float32)
        _same_coo(paddle.sparse.mask_as(paddle.to_tensor(d), rm),
                  pt.sparse.mask_as(torch.tensor(d), pm))
    low = (_R.randn(8, 2) @ _R.randn(2, 6)).astype(np.float32)
    lr, lp = _pair(np.stack(np.nonzero(low)), low[np.nonzero(low)], [8, 6])
    u, s, v = pt.sparse.pca_lowrank(lp, q=2)
    _, s_ref, _ = paddle.sparse.pca_lowrank(lr, q=2)
    np.testing.assert_allclose(s.numpy(), ref_np(s_ref), rtol=1e-4,
                               atol=1e-4)


# a batch of two 4 x 5 score matrices for the softmax
SM_IDX = np.array([[0, 0, 0, 1, 1, 1, 1], [0, 0, 3, 1, 2, 2, 3],
                   [1, 4, 2, 0, 0, 3, 4]])
SM_VALS = _R.randn(7).astype(np.float32)


def test_softmax_and_activations():
    r, p = _pair()
    F, RF = pt.sparse.nn.functional, paddle.sparse.nn.functional
    _same_coo(RF.softmax(r), F.softmax(p), TOL)
    _same_coo(RF.softmax(r.to_sparse_csr()), F.softmax(p.to_sparse_csr()),
              TOL)
    r3, p3 = _pair(SM_IDX, SM_VALS, [2, 4, 5])
    _same_coo(paddle.sparse.nn.Softmax()(r3), pt.sparse.nn.Softmax()(p3),
              TOL)
    with pytest.raises(NotImplementedError, match="last axis"):
        F.softmax(p, axis=0)
    for ref_l, port_l in ((paddle.sparse.nn.ReLU(), pt.sparse.nn.ReLU()),
                          (paddle.sparse.nn.ReLU6(), pt.sparse.nn.ReLU6()),
                          (paddle.sparse.nn.LeakyReLU(0.3),
                           pt.sparse.nn.LeakyReLU(0.3))):
        _same_coo(ref_l(r), port_l(p))


def test_attention():
    """SDDMM, the scaled sparse softmax, then SpMM, at a 6 x 6 band."""
    band = np.array([(i, j) for i in range(6) for j in range(6)
                     if abs(i - j) <= 1]).T
    r, p = _pair(band, np.ones(band.shape[1], np.float32), [6, 6])
    q, k, v = (_R.randn(6, 8).astype(np.float32) for _ in range(3))
    want = paddle.sparse.nn.functional.attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), r)
    got = pt.sparse.nn.functional.attention(
        *(torch.tensor(a) for a in (q, k, v)), p)
    np.testing.assert_allclose(got.numpy(), ref_np(want), **TOL)


# a 2 x 4 x 4 x 4 volume of 3 channels with 9 active sites
SITES = np.array([[0, 0, 0, 0, 1, 1, 1, 1, 0], [0, 1, 3, 2, 0, 2, 3, 1, 0],
                  [1, 2, 0, 3, 1, 1, 2, 0, 3], [0, 3, 1, 2, 2, 0, 3, 1, 3]])
FEATS = _R.randn(9, 3).astype(np.float32)
VOLUME = [2, 4, 4, 4, 3]


def _volume():
    return _pair(SITES, FEATS, VOLUME)


def _carried(ref_layer, port_layer):
    np_state = {k: ref_np(v) for k, v in ref_layer.state_dict().items()}
    port_layer.set_state_dict(convert.state_from_reference(np_state, "cpu"))
    return port_layer


@pytest.mark.parametrize("cls,kw", [
    ("SubmConv3D", dict(kernel_size=3, padding=1)),
    ("Conv3D", dict(kernel_size=3, padding=1)),
    ("Conv3D", dict(kernel_size=2, stride=2, bias_attr=False)),
], ids=["subm", "conv-pad1", "conv-stride2"])
def test_sparse_conv3d(cls, kw, on_cpu):
    """The output sites equal the reference's (the input's own for
    SubmConv3D), and the values with the reference's weights carried by
    convert.py."""
    ref = reference(lambda: getattr(paddle.sparse.nn, cls)(3, 5, **kw))
    port = _carried(ref, getattr(pt.sparse.nn, cls)(3, 5, **kw))
    r, p = _volume()
    want, got = ref(r), port(p)
    _same_coo(want, got, TOL)
    if cls == "SubmConv3D":
        assert got.nnz() == len({tuple(c) for c in SITES.T})


def test_sparse_batchnorm_and_pool(on_cpu):
    ref = reference(lambda: paddle.sparse.nn.BatchNorm(3))
    port = _carried(ref, pt.sparse.nn.BatchNorm(3))
    r, p = _volume()
    _same_coo(ref(r), port(p), TOL)
    np.testing.assert_allclose(port._bn._mean.numpy(),
                               ref_np(ref._bn._mean), **TOL)
    assert isinstance(pt.sparse.nn.SyncBatchNorm(3), pt.sparse.nn.BatchNorm)
    r, p = _pair(SITES, np.abs(FEATS) + 0.5, VOLUME)
    _same_coo(paddle.sparse.nn.MaxPool3D(2)(r), pt.sparse.nn.MaxPool3D(2)(p))


def test_sparse_layers_convert_and_raise(on_cpu):
    """convert.py carries sparse.nn's layers and raises on a missing key
    or a shape it does not hold."""
    ref = reference(lambda: paddle.sparse.nn.Conv3D(3, 4, 3))
    np_state = {k: ref_np(v) for k, v in ref.state_dict().items()}
    assert set(convert.state_from_reference(np_state, "cpu")) == \
        {"_conv.weight", "_conv.bias"}
    with pytest.raises(KeyError, match="missing"):
        convert.state_from_reference({"_conv.weight": np_state[
            "_conv.weight"], "_conv.extra": np.zeros(1)}, "cpu")
    bn = reference(lambda: paddle.sparse.nn.BatchNorm(4))
    st = {k: ref_np(v) for k, v in bn.state_dict().items()}
    st["_bn.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="_bn.bias"):
        convert.state_from_reference(st, "cpu")


def test_default_device_and_values_device():
    """Values given as a tensor keep its device; lists go to the default
    device, which without a GPU raises unless the CPU is asked for."""
    sp = pt.sparse.sparse_coo_tensor(IDX, torch.tensor(VALS), SHAPE)
    assert sp.device.type == "cpu" and sp.indices().dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.sparse.sparse_coo_tensor(IDX, VALS.tolist(), SHAPE)


# -- chip_smoke.py's phase-23 GCN at a small size ---------------------------

def _small_graph():
    g = cs.arxiv_graph(nodes=40, edges=120, features=8, classes=5, train=24,
                       seed=1)
    return g, cs.gcn_adjacency(g["src"], g["dst"], g["nodes"])


def test_gcn_adjacency_is_normalised():
    g, (crows, cols, vals) = _small_graph()
    n = g["nodes"]
    a = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(crows))
    np.add.at(a, (rows, cols), vals)
    raw = np.zeros((n, n), np.float32)
    np.add.at(raw, (g["dst"], g["src"]), 1.0)
    raw += np.eye(n, dtype=np.float32)
    d = raw.sum(1) ** -0.5
    np.testing.assert_allclose(a, d[:, None] * raw * d[None, :], rtol=1e-6)
    np.testing.assert_allclose(a, a.T, rtol=1e-6)


def with_graph(P, net, graph):
    """`net` with its graph argument bound: forward(x) = net(x, graph), so
    that the reference's functional_call sees only arrays."""
    class WithGraph(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.net = net
            self._graph = graph

        def forward(self, x):
            return self.net(x, self._graph)

    return WithGraph()


def test_gcn_step_matches_reference(on_cpu):
    g, (crows, cols, vals) = _small_graph()
    n = g["nodes"]
    adj_p = pt.sparse.sparse_csr_tensor(crows, cols, vals, [n, n])
    adj_r = paddle.sparse.sparse_csr_tensor(crows, cols, vals, [n, n])
    build = lambda P, adj: with_graph(P, cs.gcn(P, 8, 16, 5, 3, 0.0),  # noqa
                                      adj)
    ref = reference(lambda: build(paddle, adj_r))
    port = copy_weights(build(pt, adj_p), ref)
    assert list(port.state_dict()) == list(ref.state_dict())
    x, y, idx = g["x"], g["labels"], g["train_idx"]
    logits_p = port(torch.tensor(x))
    loss_p = cs.graph_loss(pt, logits_p, torch.tensor(y), torch.tensor(idx))
    loss_p.backward()

    def calls(f):
        logits = RefTensor(f(x))
        loss = cs.graph_loss(paddle, logits, paddle.to_tensor(y),
                             paddle.to_tensor(idx))
        return loss._data, logits._data

    (loss_r, logits_r), grads = ref_run(ref, calls, loss=lambda o: o[0])
    np.testing.assert_allclose(logits_p.detach().numpy(), logits_r, **TOL)
    np.testing.assert_allclose(float(loss_p), float(loss_r), **TOL)
    assert_grads_close(port, grads, **GTOL)
    # one Adam step lowers the loss
    opt = pt.optimizer.Adam(0.01, parameters=port.parameters())
    opt.step()
    after = cs.graph_loss(pt, port(torch.tensor(x)), torch.tensor(y),
                          torch.tensor(idx))
    assert float(after) < float(loss_p)
