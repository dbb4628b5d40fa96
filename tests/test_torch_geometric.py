"""The port's geometric against the JAX package's, on the CPU in float32,
inputs drawn by numpy from a seed: message passing (send_u_recv,
send_ue_recv, send_uv) under every reduction and message op, the segment
family, reindex_graph and reindex_heter_graph (exactly equal), and the
samplers: with sample_size -1 exactly the reference's output, else held to
the contract (every pick a true neighbour, min(deg, size) of them, no
repeats) and to uniform or weighted frequencies over many draws, since the
port draws from its own generator. Then chip_smoke.py's phase-23
GraphSAGE at a small size: one full-batch training step with equal loss
and gradients (the reference's through its jitted functional_call), and a
mini-batch built by sample_neighbors and reindex_graph as phase 23 builds
it, its forward equal to the reference's on the same blocks.

Tolerances: float32 rtol 1e-5, atol 1e-6 for gathers and reductions that
sum in one order on both sides; 1e-5/1e-5 for a layer's products; the
GraphSAGE gradients 2e-5/2e-5.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from torch_seq_parity import (assert_grads_close, copy_weights, ref_np,
                              ref_run, reference)

EXACT = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-5, atol=2e-5)

_R = np.random.RandomState(0)
X = _R.randn(7, 4).astype(np.float32)
# 12 edges over 7 nodes; node 6 receives nothing
SRC = np.array([0, 1, 2, 3, 4, 5, 0, 2, 4, 1, 3, 5])
DST = np.array([1, 2, 3, 4, 5, 0, 2, 0, 0, 3, 3, 1])
E = _R.randn(12, 4).astype(np.float32)


@pytest.fixture
def on_cpu():
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def _t(a):
    return torch.tensor(a)


def _r(a):
    return paddle.to_tensor(a)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("out_size", [None, 7])
def test_send_u_recv(reduce_op, out_size):
    got = pt.geometric.send_u_recv(_t(X), _t(SRC), _t(DST), reduce_op,
                                   out_size)
    want = paddle.geometric.send_u_recv(_r(X), _r(SRC), _r(DST), reduce_op,
                                        out_size)
    np.testing.assert_allclose(got.numpy(), ref_np(want), **EXACT)
    if out_size:
        assert (got[6] == 0).all()      # untouched rows are 0, not +-inf


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_ue_recv(message_op, reduce_op):
    got = pt.geometric.send_ue_recv(_t(X), _t(E), _t(SRC), _t(DST),
                                    message_op, reduce_op, 8)
    want = paddle.geometric.send_ue_recv(_r(X), _r(E), _r(SRC), _r(DST),
                                         message_op, reduce_op, 8)
    np.testing.assert_allclose(got.numpy(), ref_np(want), **EXACT)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv(message_op):
    y = (np.abs(X) + 0.5).astype(np.float32)
    got = pt.geometric.send_uv(_t(X), _t(y), _t(SRC), _t(DST), message_op)
    want = paddle.geometric.send_uv(_r(X), _r(y), _r(SRC), _r(DST),
                                    message_op)
    np.testing.assert_allclose(got.numpy(), ref_np(want), **EXACT)


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
def test_segment(pool):
    ids = np.array([0, 0, 1, 3, 3, 3, 5])        # segments 2 and 4 empty
    got = getattr(pt.geometric, f"segment_{pool}")(_t(X), _t(ids))
    want = getattr(paddle.geometric, f"segment_{pool}")(_r(X), _r(ids))
    np.testing.assert_allclose(got.numpy(), ref_np(want), **EXACT)


def test_max_reduce_gradient_matches_reference():
    """d(sum of a max-reduce)/dx: 1 at each row's maximum (no ties)."""
    x = torch.tensor(X, requires_grad=True)
    pt.geometric.send_u_recv(x, _t(SRC), _t(DST), "max").sum().backward()
    xr = paddle.to_tensor(X, stop_gradient=False)
    paddle.geometric.send_u_recv(xr, _r(SRC), _r(DST), "max").sum() \
        .backward()
    np.testing.assert_allclose(x.grad.numpy(), ref_np(xr.grad), **EXACT)


# a CSC graph: node v's in-neighbours are row[colptr[v]:colptr[v + 1]]
ROW = np.array([1, 2, 3, 4, 0, 2, 5, 6, 0, 1, 3, 0, 4, 5, 6, 1, 2],
               np.int64)
COLPTR = np.array([0, 4, 8, 11, 11, 15, 17], np.int64)   # node 3: none
NODES = np.array([0, 1, 2, 3, 4, 5], np.int64)
EIDS = np.arange(100, 117, dtype=np.int64)


def _check_contract(nodes, nbrs, counts, size, eids=None):
    """Every pick a true in-neighbour, min(deg, size) of them, no repeat
    edge; eids name the picked edges."""
    at = 0
    for v, c in zip(nodes, counts):
        lo, hi = COLPTR[v], COLPTR[v + 1]
        deg = hi - lo
        assert c == (deg if size < 0 else min(deg, size))
        picked = nbrs[at:at + c]
        assert set(picked) <= set(ROW[lo:hi])
        if eids is not None:
            e = eids[at:at + c]
            assert len(set(e)) == c and set(e) <= set(EIDS[lo:hi])
            np.testing.assert_array_equal(ROW[e - 100], picked)
        else:
            assert len(set(picked)) == c       # no repeated neighbour here
        at += c
    assert at == len(nbrs)


def test_sample_neighbors_all_equals_reference():
    got = pt.geometric.sample_neighbors(_t(ROW), _t(COLPTR), _t(NODES),
                                        eids=_t(EIDS), return_eids=True)
    want = paddle.geometric.sample_neighbors(_r(ROW), _r(COLPTR),
                                             _r(NODES), eids=_r(EIDS),
                                             return_eids=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.int64


def test_sample_neighbors_contract_and_uniformity():
    pt.seed(3)
    hits = np.zeros(len(ROW))
    for _ in range(400):
        nbrs, cnt, eids = pt.geometric.sample_neighbors(
            _t(ROW), _t(COLPTR), _t(NODES), sample_size=2, eids=_t(EIDS),
            return_eids=True)
        _check_contract(NODES, nbrs.numpy(), cnt.numpy(), 2, eids.numpy())
        hits[eids.numpy() - 100] += 1
    # node 0 (degree 4): each edge picked with probability 1/2
    assert np.all(np.abs(hits[:4] / 400 - 0.5) < 0.1), hits[:4]
    with pytest.raises(ValueError, match="eids"):
        pt.geometric.sample_neighbors(_t(ROW), _t(COLPTR), _t(NODES), 2,
                                      return_eids=True)


def test_weighted_sample_neighbors():
    w = np.array([4, 1, 1, 0, 1, 1, 1, 1, 0, 0, 5, 1, 1, 1, 1, 1, 1],
                 np.float32)
    got = pt.geometric.weighted_sample_neighbors(
        _t(ROW), _t(COLPTR), _t(w), _t(NODES), eids=_t(EIDS),
        return_eids=True)
    want = paddle.geometric.weighted_sample_neighbors(
        _r(ROW), _r(COLPTR), _r(w), _r(NODES), eids=_r(EIDS),
        return_eids=True)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ref_np(r))
    pt.seed(4)
    first = np.zeros(4)
    for _ in range(600):
        nbrs, cnt, eids = pt.geometric.weighted_sample_neighbors(
            _t(ROW), _t(COLPTR), _t(w), _t(NODES), 1, eids=_t(EIDS),
            return_eids=True)
        _check_contract(NODES, nbrs.numpy(), cnt.numpy(), 1, eids.numpy())
        first[eids.numpy()[0] - 100] += 1
        # node 2 has one positive weight (to 3): a zero one (to 0 or 1)
        # fills the second pick
        nbrs, cnt = pt.geometric.weighted_sample_neighbors(
            _t(ROW), _t(COLPTR), _t(w), _t(np.array([2])), 2)
        assert 3 in nbrs.numpy() and len(set(nbrs.tolist()) & {0, 1}) == 1
    # node 0's weights 4:1:1:0
    np.testing.assert_allclose(first / 600, [4 / 6, 1 / 6, 1 / 6, 0],
                               atol=0.06)


def test_reindex_graph_and_heter():
    x = np.array([5, 9, 2], np.int64)
    nbrs = np.array([9, 7, 7, 3, 5, 11, 2], np.int64)
    cnt = np.array([2, 4, 1], np.int64)
    got = pt.geometric.reindex_graph(_t(x), _t(nbrs), _t(cnt))
    want = paddle.geometric.reindex_graph(_r(x), _r(nbrs), _r(cnt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))
    nb2, cnt2 = np.array([4, 5, 8], np.int64), np.array([1, 1, 1], np.int64)
    got = pt.geometric.reindex_heter_graph(_t(x), [_t(nbrs), _t(nb2)],
                                           [_t(cnt), _t(cnt2)])
    want = paddle.geometric.reindex_heter_graph(_r(x), [_r(nbrs), _r(nb2)],
                                                [_r(cnt), _r(cnt2)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ref_np(w))


# -- chip_smoke.py's phase-23 GraphSAGE at a small size ----------------------

def _graph():
    return cs.arxiv_graph(nodes=40, edges=120, features=8, classes=5,
                          train=24, seed=2)


def with_blocks(P, net, blocks):
    """`net` with its blocks bound: forward(x) = net(x, blocks)."""
    class WithBlocks(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.net = net
            self._blocks = blocks

        def forward(self, x):
            return self.net(x, self._blocks)

    return WithBlocks()


def _sage_pair(blocks_p, blocks_r):
    build = lambda P, b: with_blocks(  # noqa: E731
        P, cs.graph_sage(P, 8, 16, 5, 3, 0.0), b)
    ref = reference(lambda: build(paddle, blocks_r))
    port = copy_weights(build(pt, blocks_p), ref)
    assert list(port.state_dict()) == list(ref.state_dict())
    return port, ref


def test_graph_sage_step_matches_reference(on_cpu):
    g = _graph()
    n = g["nodes"]
    blocks_p = [(_t(g["src"]), _t(g["dst"]), n)] * 3
    blocks_r = [(_r(g["src"]), _r(g["dst"]), n)] * 3
    port, ref = _sage_pair(blocks_p, blocks_r)
    x, y, idx = g["x"], g["labels"], g["train_idx"]
    logits_p = port(_t(x))
    loss_p = cs.graph_loss(pt, logits_p, _t(y), _t(idx))
    loss_p.backward()

    def calls(f):
        logits = RefTensor(f(x))
        return cs.graph_loss(paddle, logits, _r(y), _r(idx))._data, \
            logits._data

    (loss_r, logits_r), grads = ref_run(ref, calls, loss=lambda o: o[0])
    np.testing.assert_allclose(logits_p.detach().numpy(), logits_r, **TOL)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r), **TOL)
    assert_grads_close(port, grads, **GTOL)


def test_graph_sage_minibatch_blocks(on_cpu):
    """Phase 23's mini-batch: hop by hop from the seeds, sample_neighbors
    then reindex_graph; each layer's destinations are the first rows of
    its input. The blocks hold the sampler's contract, and the forward on
    them equals the reference's."""
    g = _graph()
    row, colptr = cs.csc_graph(g["src"], g["dst"], g["nodes"])
    pt.seed(0)
    blocks, nodes = cs.sample_blocks(pt, _t(row), _t(colptr),
                                     _t(np.array([3, 17, 29, 8])), (4, 3, 2))
    assert len(blocks) == 3
    for src, dst, n in blocks:
        assert int(dst.max()) < n and int(src.max()) < len(nodes)
    # each edge is a true edge of the graph, in global ids
    edges = set(zip(g["src"].tolist(), g["dst"].tolist()))
    for src, dst, _ in blocks:
        for s, d in zip(nodes[src].tolist(), nodes[dst].tolist()):
            assert (s, d) in edges
    blocks_r = [(_r(s.numpy()), _r(d.numpy()), n) for s, d, n in blocks]
    port, ref = _sage_pair(blocks, blocks_r)
    feats = g["x"][nodes.numpy()]
    got = port(_t(feats))
    want, _ = ref_run(ref, lambda f: f(feats), training=True)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
