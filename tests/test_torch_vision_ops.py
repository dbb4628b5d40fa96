"""The port's vision.ops against the JAX package's, on the cases of
tests/test_vision_ops.py and beside them: the RoI ops (roi_align aligned
or not, sampling ratios, boxes past the image's edge; roi_pool on a lone
peak in a large bin; psroi_pool; the layers; roi_align's gradient),
nms (with scores, ties among them, categories, top_k: the same indices
in the same order), matrix_nms (linear and gaussian decay), deform_conv2d
(zero offsets against conv2d, random offsets with and without a mask,
stride, padding and dilation; the gradient; DeformConv2D), yolo_box
(clipping, iou_aware), yolo_loss and its gradient, prior_box, box_coder
both ways, distribute_fpn_proposals, generate_proposals, read_file and
decode_jpeg. Inputs come from numpy seeds; float32 results within
F32_TOL and gradients within GRAD_TOL of their tensor's largest |value|
(tests/test_torch_vision.py's tolerances); host ops exactly."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import ops as PV


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F32_TOL = 1e-4
GRAD_TOL = 1e-4


def _j(a):
    return paddle.Tensor(jnp.asarray(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._data)


def _close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _boxes(rs, n, size, lo=-4.0):
    xy = rs.uniform(lo, size - 4, (n, 2))
    wh = rs.uniform(1, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- RoI ops -----------------------------------------------------------------

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sr,out,scale", [(-1, 2, 1.0), (2, 7, 0.5),
                                          (3, (3, 5), 0.25)])
def test_roi_align_matches_reference(aligned, sr, out, scale):
    """Two images, 3 and 4 RoIs, some past the map's edge (the reference
    clamps to the border value)."""
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 3, 12, 16).astype(np.float32)
    boxes = _boxes(rs, 7, 16 / scale)
    num = np.array([3, 4], np.int32)
    want = JV.roi_align(_j(feat), _j(boxes), _j(num), out, scale, sr,
                        aligned)
    got = PV.roi_align(torch.tensor(feat), torch.tensor(boxes),
                       torch.tensor(num), out, scale, sr, aligned)
    _close(got, want)
    layer = PV.RoIAlign(out, scale)
    _close(layer(torch.tensor(feat), torch.tensor(boxes), torch.tensor(num),
                 aligned=aligned), want) if sr == -1 else None


def test_roi_align_constant_feature_and_batching():
    """tests/test_vision_ops.py's cases: a constant map pools to the
    constant; each RoI reads its own image."""
    feat = np.full((1, 3, 8, 8), 5.0, np.float32)
    got = PV.roi_align(torch.tensor(feat), torch.tensor([[1., 1., 6., 6.]]),
                       torch.tensor([1]), 2)
    np.testing.assert_allclose(got.numpy(), np.full((1, 3, 2, 2), 5.0),
                               rtol=1e-5)
    feat = np.stack([np.full((1, 6, 6), 1.0), np.full((1, 6, 6), 2.0)]
                    ).astype(np.float32)
    boxes = torch.tensor([[0., 0., 5., 5.], [0., 0., 5., 5.]])
    got = PV.roi_align(torch.tensor(feat), boxes, torch.tensor([1, 1]), 1)
    np.testing.assert_allclose(got.numpy().reshape(-1), [1.0, 2.0],
                               rtol=1e-5)


def test_roi_align_gradient_matches_jax_grad():
    rs = np.random.RandomState(1)
    feat = rs.randn(2, 2, 8, 8).astype(np.float32)
    boxes = _boxes(rs, 5, 8)
    num = np.array([2, 3], np.int32)
    cot = rs.randn(5, 2, 4, 4).astype(np.float32)
    want = jax.grad(lambda f: (JV.roi_align(
        paddle.Tensor(f, stop_gradient=False), _j(boxes), _j(num),
        4)._data * cot).sum())(jnp.asarray(feat))
    t = torch.tensor(feat, requires_grad=True)
    (PV.roi_align(t, torch.tensor(boxes), torch.tensor(num), 4)
     * torch.as_tensor(cot)).sum().backward()
    w = np.asarray(want)
    np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                               atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("out,scale", [(1, 1.0), (2, 0.5), ((3, 2), 1.0)])
def test_roi_pool_matches_reference(out, scale):
    rs = np.random.RandomState(2)
    feat = rs.randn(2, 3, 10, 12).astype(np.float32)
    boxes = _boxes(rs, 5, 12 / scale, lo=0.0)
    num = np.array([2, 3], np.int32)
    want = JV.roi_pool(_j(feat), _j(boxes), _j(num), out, scale)
    got = PV.roi_pool(torch.tensor(feat), torch.tensor(boxes),
                      torch.tensor(num), out, scale)
    _same(got, want)
    _same(PV.RoIPool(out, scale)(torch.tensor(feat), torch.tensor(boxes),
                                 torch.tensor(num)), want)


def test_roi_pool_finds_a_lone_peak_in_a_large_bin():
    feat = np.zeros((1, 1, 32, 32), np.float32)
    feat[0, 0, 17, 23] = 9.0
    got = PV.roi_pool(torch.tensor(feat), torch.tensor([[0., 0., 31., 31.]]),
                      torch.tensor([1]), 1)
    assert got.max().item() == 9.0


def test_psroi_pool_matches_reference():
    rs = np.random.RandomState(3)
    feat = rs.randn(2, 2 * 9, 8, 8).astype(np.float32)
    boxes = _boxes(rs, 4, 8, lo=0.0)
    num = np.array([1, 3], np.int32)
    want = JV.psroi_pool(_j(feat), _j(boxes), _j(num), 3, 1.0)
    got = PV.psroi_pool(torch.tensor(feat), torch.tensor(boxes),
                        torch.tensor(num), 3, 1.0)
    assert got.shape == (4, 2, 3, 3)
    _close(got, want)
    _close(PV.PSRoIPool(3)(torch.tensor(feat), torch.tensor(boxes),
                           torch.tensor(num)), want)


# -- NMS ---------------------------------------------------------------------

@pytest.mark.parametrize("with_cats", [False, True])
@pytest.mark.parametrize("thresh,top_k", [(0.3, None), (0.5, 20),
                                          (0.7, None)])
def test_nms_keeps_the_reference_indices_in_order(thresh, top_k, with_cats):
    """200 boxes with scores rounded to two digits (many ties: numpy's
    argsort order decides among them on both sides)."""
    rs = np.random.RandomState(4)
    boxes = _boxes(rs, 200, 100, lo=0.0)
    scores = np.round(rs.rand(200), 2).astype(np.float32)
    kw = dict(top_k=top_k)
    if with_cats:
        cats = rs.randint(0, 3, 200)
        kw.update(category_idxs=cats, categories=[0, 1, 2])
    want = JV.nms(_j(boxes), thresh, _j(scores), **{
        k: (_j(v) if k == "category_idxs" else v) for k, v in kw.items()})
    got = PV.nms(torch.tensor(boxes), thresh, torch.tensor(scores), **{
        k: (torch.tensor(v) if k == "category_idxs" else v)
        for k, v in kw.items()})
    assert got.dtype == torch.int64
    _same(got, want)


def test_nms_reference_cases():
    b = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     dtype=torch.float32)
    s = torch.tensor([0.9, 0.8, 0.7])
    assert PV.nms(b, 0.5, s).tolist() == [0, 2]
    b2 = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 10]], dtype=torch.float32)
    assert len(PV.nms(b2, 0.5, torch.tensor([0.9, 0.8]),
                      category_idxs=torch.tensor([0, 1]),
                      categories=[0, 1])) == 2
    assert PV.nms(b, 0.5).tolist() == [0, 2]        # input order


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_matches_reference(gaussian):
    rs = np.random.RandomState(5)
    bboxes = np.stack([_boxes(rs, 30, 50, lo=0.0) for _ in range(2)])
    scores = rs.rand(2, 4, 30).astype(np.float32)
    args = (0.3,)
    kw = dict(post_threshold=0.1, nms_top_k=20, keep_top_k=25,
              use_gaussian=gaussian, return_index=True)
    want = JV.matrix_nms(_j(bboxes), _j(scores), *args, **kw)
    got = PV.matrix_nms(torch.tensor(bboxes), torch.tensor(scores), *args,
                        **kw)
    assert len(got) == len(want) == 3
    _close(got[0], want[0], tol=1e-6)
    _same(got[1], want[1])
    _same(got[2], want[2])


# -- deformable convolution ----------------------------------------------------

def test_deform_conv2d_zero_offset_equals_conv2d():
    rs = np.random.RandomState(6)
    img = torch.tensor(rs.randn(1, 2, 6, 6).astype(np.float32))
    w = torch.tensor(rs.randn(4, 2, 3, 3).astype(np.float32))
    out = PV.deform_conv2d(img, torch.zeros(1, 18, 4, 4), w)
    np.testing.assert_allclose(out.numpy(), PF.conv2d(img, w).numpy(),
                               rtol=1e-5, atol=1e-5)
    mask0 = torch.zeros(1, 9, 4, 4)
    assert PV.deform_conv2d(img, torch.zeros(1, 18, 4, 4), w,
                            mask=mask0).abs().max().item() == 0.0


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(stride=2, padding=1),
                                dict(padding=(2, 2), dilation=2)],
                         ids=["plain", "strided", "dilated"])
def test_deform_conv2d_matches_reference(kw, mask):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 9, 10).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    st = kw.get("stride", 1)
    pd = kw.get("padding", 0)
    pd = (pd, pd) if isinstance(pd, int) else pd
    dl = kw.get("dilation", 1)
    oh = (9 + 2 * pd[0] - dl * 2 - 1) // st + 1
    ow = (10 + 2 * pd[1] - dl * 2 - 1) // st + 1
    off = (rs.randn(2, 18, oh, ow) * 2).astype(np.float32)
    m = rs.rand(2, 9, oh, ow).astype(np.float32) if mask else None
    want = JV.deform_conv2d(_j(x), _j(off), _j(w), _j(b),
                            mask=None if m is None else _j(m), **kw)
    got = PV.deform_conv2d(torch.tensor(x), torch.tensor(off),
                           torch.tensor(w), torch.tensor(b),
                           mask=None if m is None else torch.tensor(m), **kw)
    _close(got, want)


def test_deform_conv2d_pads_each_dim_by_its_own_padding():
    """padding (ph, pw) pads the rows by ph and the columns by pw: with
    zero offsets the result is conv2d's. (The reference pads both dims by
    (ph, pw) as (before, after) while sizing the output by 2 ph and 2 pw,
    so it samples past its padded map where ph != pw; the port does not
    follow it there.)"""
    rs = np.random.RandomState(16)
    img = torch.tensor(rs.randn(1, 2, 7, 6).astype(np.float32))
    w = torch.tensor(rs.randn(3, 2, 3, 3).astype(np.float32))
    want = PF.conv2d(img, w, padding=(2, 1), dilation=2)
    out = PV.deform_conv2d(img, torch.zeros((1, 18) + want.shape[2:]), w,
                           padding=(2, 1), dilation=2)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_deform_conv2d_gradient_matches_jax_grad():
    rs = np.random.RandomState(8)
    x = rs.randn(1, 2, 6, 6).astype(np.float32)
    off = rs.randn(1, 18, 4, 4).astype(np.float32)
    w = rs.randn(3, 2, 3, 3).astype(np.float32)
    m = rs.rand(1, 9, 4, 4).astype(np.float32)
    cot = rs.randn(1, 3, 4, 4).astype(np.float32)

    def loss(a, o, k, mm):
        t = [paddle.Tensor(v, stop_gradient=False) for v in (a, o, k, mm)]
        return (JV.deform_conv2d(t[0], t[1], t[2], mask=t[3])._data
                * cot).sum()
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(v) for v in (x, off, w, m)])
    ts = [torch.tensor(v, requires_grad=True) for v in (x, off, w, m)]
    (PV.deform_conv2d(ts[0], ts[1], ts[2], mask=ts[3])
     * torch.as_tensor(cot)).sum().backward()
    for t, wg in zip(ts, want):
        wg = np.asarray(wg)
        np.testing.assert_allclose(t.grad.numpy(), wg, rtol=0,
                                   atol=GRAD_TOL * np.abs(wg).max())


def test_deform_conv2d_layer():
    """The weight (out, in, kh, kw) within +-sqrt(6 / fan_in), a zero bias,
    and forward equal to the functional on the layer's parameters."""
    layer = PV.DeformConv2D(4, 8, 3, padding=1, device="cpu")
    assert layer.weight.shape == (8, 4, 3, 3)
    assert layer.weight.abs().max() <= np.sqrt(6 / 36)
    assert not layer.bias.any()
    x = torch.randn(1, 4, 5, 5)
    off = torch.randn(1, 18, 5, 5)
    torch.testing.assert_close(
        layer(x, off), PV.deform_conv2d(x, off, layer.weight, layer.bias,
                                        padding=1), rtol=0, atol=0)
    assert PV.DeformConv2D(4, 8, 3, bias_attr=False, device="cpu").bias \
        is None


# -- YOLO, anchors, proposals ------------------------------------------------

ANCHORS = [10, 14, 23, 27, 37, 58]


@pytest.mark.parametrize("kw", [dict(), dict(clip_bbox=False, scale_x_y=1.2),
                                dict(iou_aware=True, iou_aware_factor=0.4),
                                dict(conf_thresh=0.5)],
                         ids=["plain", "unclipped", "iou_aware", "thresh"])
def test_yolo_box_matches_reference(kw):
    rs = np.random.RandomState(9)
    kw = dict(kw)
    conf = kw.pop("conf_thresh", 0.0)
    c = 3 * (6 if kw.get("iou_aware") else 5) + 3 * 2
    x = rs.randn(2, c, 4, 5).astype(np.float32)
    size = np.array([[64, 80], [48, 60]], np.int32)
    want = JV.yolo_box(_j(x), _j(size), ANCHORS, 2, conf, **kw)
    got = PV.yolo_box(torch.tensor(x), torch.tensor(size), ANCHORS, 2, conf,
                      **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_yolo_loss_and_gradient_match_reference():
    rs = np.random.RandomState(10)
    x = (rs.randn(2, 3 * 7, 4, 4) * 0.3).astype(np.float32)
    gtb = np.zeros((2, 3, 4), np.float32)
    gtb[:, 0] = [0.5, 0.5, 0.3, 0.4]
    gtb[0, 1] = [0.2, 0.7, 0.1, 0.2]
    gtl = rs.randint(0, 2, (2, 3))
    args = (ANCHORS, [0, 1, 2], 2, 0.7, 16)

    def loss(a):
        return JV.yolo_loss(paddle.Tensor(a, stop_gradient=False), _j(gtb),
                            _j(gtl), *args)._data
    want, want_g = jax.value_and_grad(loss)(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = PV.yolo_loss(t, torch.tensor(gtb), torch.tensor(gtl), *args)
    got.backward()
    assert abs(got.item() - float(want)) <= F32_TOL * abs(float(want))
    wg = np.asarray(want_g)
    np.testing.assert_allclose(t.grad.numpy(), wg, rtol=0,
                               atol=GRAD_TOL * np.abs(wg).max())


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=[1.0, 2.0], flip=True),
    dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 24.0], clip=True,
         steps=(8.0, 8.0), offset=0.3)], ids=["flip", "max_sizes"])
def test_prior_box_matches_reference(kw):
    rs = np.random.RandomState(11)
    feat = rs.randn(1, 8, 4, 5).astype(np.float32)
    img = rs.randn(1, 3, 32, 40).astype(np.float32)
    want = JV.prior_box(_j(feat), _j(img), **kw)
    got = PV.prior_box(torch.tensor(feat), torch.tensor(img), **kw)
    for g, w in zip(got, want):
        _close(g, w, tol=1e-6)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("var", ["list", "tensor", "none"])
def test_box_coder_both_ways_matches_reference(var, normalized):
    rs = np.random.RandomState(12)
    pb = _boxes(rs, 6, 50, lo=0.0)
    tb = _boxes(rs, 6, 50, lo=0.0)
    pv = {"list": [0.1, 0.1, 0.2, 0.2], "none": None,
          "tensor": rs.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    jv = _j(pv) if var == "tensor" else pv
    tv = torch.tensor(pv) if var == "tensor" else pv
    want = JV.box_coder(_j(pb), jv, _j(tb), box_normalized=normalized)
    got = PV.box_coder(torch.tensor(pb), tv, torch.tensor(tb),
                       box_normalized=normalized)
    _close(got, want)
    want_d = JV.box_coder(_j(pb), jv, want, "decode_center_size",
                          box_normalized=normalized)
    got_d = PV.box_coder(torch.tensor(pb), tv, got, "decode_center_size",
                         box_normalized=normalized)
    _close(got_d, want_d)
    np.testing.assert_allclose(got_d.numpy(), tb, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("with_num", [False, True])
def test_distribute_fpn_proposals_matches_reference(with_num):
    rs = np.random.RandomState(13)
    rois = _boxes(rs, 40, 400, lo=0.0)
    num = np.array([40], np.int32)
    kw = dict(rois_num=num) if with_num else {}
    want = JV.distribute_fpn_proposals(_j(rois), 2, 5, 4, 224, **{
        k: _j(v) for k, v in kw.items()})
    got = PV.distribute_fpn_proposals(torch.tensor(rois), 2, 5, 4, 224, **{
        k: torch.tensor(v) for k, v in kw.items()})
    assert len(got) == len(want)
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    _same(got[1], want[1])
    rebuilt = torch.cat([o for o in got[0] if len(o)])
    np.testing.assert_array_equal(rebuilt[got[1].reshape(-1)].numpy(), rois)
    if with_num:
        for g, w in zip(got[2], want[2]):
            _same(g, w)


@pytest.mark.parametrize("return_num", [False, True])
def test_generate_proposals_matches_reference(return_num):
    rs = np.random.RandomState(14)
    h = w = 4
    na = 3
    scores = rs.rand(2, na, h, w).astype(np.float32)
    deltas = (rs.randn(2, na * 4, h, w) * 0.1).astype(np.float32)
    anchors = np.tile(np.array([[0, 0, 15, 15], [0, 0, 31, 31],
                                [0, 0, 7, 7]], np.float32),
                      (h * w, 1)).reshape(-1, 4)
    var = np.ones_like(anchors)
    size = np.array([[64, 64], [48, 56]], np.float32)
    kw = dict(post_nms_top_n=8, return_rois_num=return_num)
    want = JV.generate_proposals(_j(scores), _j(deltas), _j(size),
                                 _j(anchors), _j(var), **kw)
    got = PV.generate_proposals(torch.tensor(scores), torch.tensor(deltas),
                                torch.tensor(size), torch.tensor(anchors),
                                torch.tensor(var), **kw)
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        _same(g, wt)


# -- file IO -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_read_file_and_decode_jpeg_match_reference(tmp_path, mode):
    from PIL import Image
    img = (np.random.RandomState(15).rand(12, 10, 3) * 255).astype(np.uint8)
    path = tmp_path / "a.jpg"
    Image.fromarray(img).save(path, format="JPEG")
    raw = PV.read_file(str(path))
    assert raw.dtype == torch.uint8
    _same(raw, JV.read_file(str(path)))
    got = PV.decode_jpeg(raw, mode)
    want = JV.decode_jpeg(JV.read_file(str(path)), mode)
    assert got.dtype == torch.uint8
    _same(got, want)
