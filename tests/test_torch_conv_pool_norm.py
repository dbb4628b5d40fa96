"""The port's convolutions, pools, batch norm, their layers, and the SGD
and Momentum optimizers against the JAX package's.

- conv1d/2d/3d in float32 and bfloat16: stride, dilation, groups, every
  padding form (an int, one per dim, 2n ints, the [[0,0],[0,0],[h0,h1],
  [w0,w1]] form, "SAME" with stride 2 and an even kernel, "VALID"), NHWC,
  with and without bias; outputs, and input, weight and bias gradients.
- max and avg pools with padding, ceil_mode, exclusive True and False,
  asymmetric and "SAME" pads, NHWC; adaptive avg pools from 10x10 and
  13x13 to 7x7 and 1x1; the adaptive max pool; a max pool whose windows
  tie, whose gradient goes to each window's first maximum in both.
- batch_norm in training, eval and use_global_stats, NCHW and NHWC, in
  float32 and bfloat16 (with float32 or bfloat16 running statistics):
  outputs, input/weight/bias gradients, and the running statistics after
  one and after three training forwards.
- SGD and Momentum, with and without use_nesterov and weight_decay: three
  updates through the reference's `tree_update` at a float32 learning
  rate, as bench.py's compiled step passes it, in float32 and bfloat16.
- The layers: Conv2D's Uniform(+-1/sqrt(fan_in)) init and `bias_attr`,
  BatchNorm2D's `_mean`/`_variance` buffers, Sequential's child names.

Inputs come from numpy seeds. float32 parity is within F32_TOL (the same
math summed in other orders); bfloat16 within BF16_TOL of the largest
|value| compared (a bf16 rounding or two of values of order 1, the bound
tests/test_torch_bert.py holds bf16 to). bfloat16 gradients are held to
the reference's float32 gradients at the same bf16-rounded inputs (see
`_compare`) within BF16_GRAD_TOL: a batch norm's weight and bias
gradients are sums over the batch of terms that each carry about three
bf16 roundings and cancel, so their error is that of the terms, about
1e-2 of the largest sum. Optimizer states are held to OPT_TOL in float32
and to BF16_TOL in bfloat16.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as poptim
from paddle_tpu_torch.nn import functional as PF

F32_TOL = 1e-4
BF16_TOL = 1e-2
BF16_GRAD_TOL = 2e-2
OPT_TOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    inf = np.isinf(want)        # windows of padding alone: -inf in both
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    got, want = got[~inf], want[~inf]
    if tol in (BF16_TOL, BF16_GRAD_TOL):
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= tol, (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _np(t):
    return np.asarray(t._data.astype(jnp.float32))


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _reference(ref_fn, arrays, jdt, cot):
    """ref_fn's output and each input's gradient under `cot`, as float32
    arrays, the inputs in `jdt`."""
    jin = [None if a is None else
           paddle.Tensor(jnp.asarray(a).astype(jdt), stop_gradient=False)
           for a in arrays]
    out = ref_fn(*jin)
    if cot is None:
        return _np(out), []
    (out * paddle.Tensor(jnp.asarray(cot).astype(jdt))).sum().backward()
    return _np(out), [None if j is None else _np(j.grad) for j in jin]


def _compare(ref_fn, pt_fn, arrays, dtype, grad=True, seed=1,
             bf16_sums=False):
    """ref_fn and pt_fn on the same arrays in `dtype`: the outputs, and with
    `grad` each input's gradient under the same random cotangent. bf16
    gradients, and with `bf16_sums` bf16 outputs too, are held to the
    reference's float32 results at the same bf16-rounded inputs and
    cotangent: the reference accumulates a bf16 sum (a bias's or a batch
    norm's gradient, an avg pool's window) in bf16, where torch
    accumulates in float32."""
    jdt, tdt, tol = DTYPES[dtype]
    tin = [None if a is None else
           torch.as_tensor(a).to(tdt).requires_grad_(grad) for a in arrays]
    tout = pt_fn(*tin)
    assert tout.dtype == tdt
    cot = (np.random.RandomState(seed).randn(*tout.shape).astype(np.float32)
           if grad else None)
    f32 = dtype == "float32"
    want, grads = _reference(ref_fn, arrays, jdt, cot if f32 else None)
    if not f32 and (grad or bf16_sums):
        want32, grads = _reference(
            ref_fn, [None if a is None else _bf16(a) for a in arrays],
            jnp.float32, None if cot is None else _bf16(cot))
        want = want32 if bf16_sums else want
    _close(tout, want, tol, "out")
    if not grad:
        return
    (tout * torch.as_tensor(cot).to(tdt)).sum().backward()
    for i, (g, t) in enumerate(zip(grads, tin)):
        if g is not None:
            _close(t.grad, g, tol if f32 else BF16_GRAD_TOL, f"grad {i}")


# -- convolutions -------------------------------------------------------------

# (n, x shape, weight shape, kwargs)
CONV_CASES = {
    "2d_stride_pad_bias": (2, (2, 4, 9, 9), (6, 4, 3, 3),
                           dict(stride=2, padding=1, bias=True)),
    "2d_dilation_groups": (2, (2, 4, 10, 10), (6, 2, 3, 3),
                           dict(padding=2, dilation=2, groups=2, bias=True)),
    "2d_same_stride2_even": (2, (2, 3, 9, 10), (5, 3, 4, 4),
                             dict(stride=2, padding="SAME")),
    "2d_valid_stride2": (2, (2, 3, 9, 9), (4, 3, 3, 3),
                         dict(stride=2, padding="VALID")),
    "2d_per_dim": (2, (2, 3, 7, 8), (4, 3, 3, 5), dict(padding=[1, 2])),
    "2d_low_high": (2, (2, 3, 7, 8), (4, 3, 3, 3),
                    dict(padding=[0, 1, 2, 1], stride=2, bias=True)),
    "2d_nhwc": (2, (2, 9, 9, 4), (6, 4, 3, 3),
                dict(stride=2, padding=1, bias=True, data_format="NHWC")),
    "2d_stem": (2, (2, 3, 16, 16), (8, 3, 7, 7),
                dict(stride=2, padding=3)),
    "1d_same_stride2_even": (1, (2, 3, 11), (4, 3, 4),
                             dict(stride=2, padding="SAME", bias=True)),
    "1d_low_high": (1, (2, 4, 10), (6, 2, 3),
                    dict(padding=[1, 2], groups=2)),
    "1d_nlc": (1, (2, 10, 3), (4, 3, 3),
               dict(padding=1, bias=True, data_format="NLC")),
    "1d_pairs": (1, (2, 3, 10), (4, 3, 3),
                 dict(padding=[[0, 0], [0, 0], [2, 1]], stride=2)),
    "3d_stride_groups": (3, (1, 4, 5, 6, 6), (4, 2, 3, 3, 3),
                         dict(stride=(1, 2, 2), padding=1, groups=2,
                              bias=True)),
    "3d_same_even": (3, (1, 2, 5, 6, 7), (3, 2, 2, 3, 4),
                     dict(stride=2, padding="SAME")),
    "3d_ndhwc_pairs": (3, (1, 5, 6, 6, 2), (3, 2, 3, 3, 3),
                       dict(padding=[[0, 0], [1, 0], [0, 2], [1, 1],
                                     [0, 0]], data_format="NDHWC")),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case, dtype):
    n, xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    bias = kw.pop("bias", False)
    rs = np.random.RandomState(0)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) / np.sqrt(np.prod(ws[1:]))).astype(np.float32)
    b = rs.randn(ws[0]).astype(np.float32) if bias else None
    name = f"conv{n}d"
    _compare(lambda a, c, d: getattr(JF, name)(a, c, d, **kw),
             lambda a, c, d: getattr(PF, name)(a, c, d, **kw),
             [x, w, b], dtype, grad=dtype == "float32")


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_takes_the_pairs_padding_form(fmt):
    """[[0,0],[0,0],[h0,h1],[w0,w1]] in 2-D equals its 2n-int form. The
    reference's `_padding` (:26-40) reads a 4-entry list as 2n ints before
    it tries the pairs form, so it raises on the 2-D pairs form; the 1-D
    and 3-D pairs forms are held to the reference above."""
    x = torch.randn(2, 3, 7, 8)
    w = torch.randn(4, 3, 3, 3)
    want = PF.conv2d(x, w, padding=[1, 0, 2, 1])
    pairs = [[0, 0], [0, 0], [1, 0], [2, 1]]
    if fmt == "NHWC":
        x, want = x.movedim(1, -1), want.movedim(1, -1)
        pairs = [[0, 0], [1, 0], [2, 1], [0, 0]]
    torch.testing.assert_close(PF.conv2d(x, w, padding=pairs,
                                         data_format=fmt), want)


def test_conv_rejects_a_bad_padding():
    x, w = torch.zeros(1, 1, 5, 5), torch.zeros(1, 1, 3, 3)
    with pytest.raises(ValueError):
        PF.conv2d(x, w, padding=[1, 2, 3])
    with pytest.raises(ValueError):
        PF.conv2d(x, w, padding="full")


# -- pools ------------------------------------------------------------------

# (function, x shape, args, kwargs)
POOL_CASES = {
    "max2d_stem": ("max_pool2d", (2, 3, 12, 12), (3, 2, 1), {}),
    "max2d_ceil": ("max_pool2d", (2, 3, 9, 9), (2, 2), dict(ceil_mode=True)),
    "max2d_pad_ceil": ("max_pool2d", (2, 3, 10, 10), (3, 2, 1),
                       dict(ceil_mode=True)),
    "max2d_low_high": ("max_pool2d", (2, 3, 9, 9), (3, 2, [0, 1, 1, 0]), {}),
    "max2d_wide_pad": ("max_pool2d", (1, 2, 6, 6), (2, 1, 2), {}),
    "max2d_same": ("max_pool2d", (2, 3, 9, 10), (3, 2, "SAME"), {}),
    "max2d_nhwc": ("max_pool2d", (2, 9, 9, 3), (3, 2, 1),
                   dict(data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11), (3, 2, 1), dict(ceil_mode=True)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 7), (2, 2), dict(ceil_mode=True)),
    "avg2d_excl": ("avg_pool2d", (2, 3, 9, 9), (3, 2, 1), {}),
    "avg2d_incl": ("avg_pool2d", (2, 3, 9, 9), (3, 2, 1),
                   dict(exclusive=False)),
    "avg2d_excl_ceil": ("avg_pool2d", (2, 3, 10, 10), (3, 2, 1),
                        dict(ceil_mode=True)),
    "avg2d_incl_ceil": ("avg_pool2d", (2, 3, 10, 10), (3, 2, 1),
                        dict(ceil_mode=True, exclusive=False)),
    "avg2d_low_high_incl": ("avg_pool2d", (2, 3, 9, 8), (3, 2, [1, 0, 0, 2]),
                            dict(exclusive=False, ceil_mode=True)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 10), (3, 2, "SAME"), {}),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 9, 3), (3, 2, 1),
                   dict(data_format="NHWC", exclusive=False)),
    "avg1d": ("avg_pool1d", (2, 3, 11), (3, 2, 1),
              dict(ceil_mode=True, exclusive=False)),
    "avg3d": ("avg_pool3d", (1, 2, 5, 6, 7), (3, 2, 1), dict(ceil_mode=True)),
    "adaptive_avg2d_10_7": ("adaptive_avg_pool2d", (2, 3, 10, 10), (7,), {}),
    "adaptive_avg2d_13_7": ("adaptive_avg_pool2d", (2, 3, 13, 13), ((7, 7),),
                            {}),
    "adaptive_avg2d_10_1": ("adaptive_avg_pool2d", (2, 3, 10, 10), (1,), {}),
    "adaptive_avg2d_13_1": ("adaptive_avg_pool2d", (2, 3, 13, 13), ((1, 1),),
                            {}),
    "adaptive_avg2d_1_7": ("adaptive_avg_pool2d", (2, 3, 1, 2), ((7, 7),),
                           {}),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 13), (7,), {}),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 3, 5, 6), ((2, 3, 4),),
                       {}),
    "adaptive_max2d": ("adaptive_max_pool2d", (2, 3, 13, 13), (7,), {}),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case, dtype):
    fn, xs, args, kw = POOL_CASES[case]
    x = np.random.RandomState(0).randn(*xs).astype(np.float32)
    _compare(lambda a: getattr(JF, fn)(a, *args, **kw),
             lambda a: getattr(PF, fn)(a, *args, **kw), [x], dtype,
             grad=dtype == "float32", bf16_sums=fn.startswith("avg"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_gradient_goes_to_the_first_tied_maximum(k, s, p, dtype):
    """Values 0, 1 and 2 only, half of them ReLU'd to 0: most windows hold
    their maximum more than once. Each window's cotangent goes to its
    first maximum in row-major order in both, so the gradients agree
    position for position."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randint(-2, 3, (2, 3, 9, 9)), 0).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    xj = paddle.Tensor(jnp.asarray(x).astype(jdt), stop_gradient=False)
    xt = torch.as_tensor(x).to(tdt).requires_grad_(True)
    oj, ot = JF.max_pool2d(xj, k, s, p), PF.max_pool2d(xt, k, s, p)
    cot = (1 + rs.randint(0, 4, tuple(ot.shape))).astype(np.float32)
    (oj * paddle.Tensor(jnp.asarray(cot).astype(jdt))).sum().backward()
    (ot * torch.as_tensor(cot).to(tdt)).sum().backward()
    want = _np(xj.grad)
    got = xt.grad.float().numpy()
    assert (want != 0).sum() < x.size / 2           # ties: fewer winners
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call,ref", [
    (lambda x: PF.max_pool2d(x, 2, return_mask=True),
     lambda x: JF.max_pool2d(x, 2, return_mask=True)),
    (lambda x: PF.adaptive_max_pool2d(x, 2, return_mask=True),
     lambda x: JF.adaptive_max_pool2d(x, 2, return_mask=True)),
    (lambda x: PF.lp_pool2d(x, 2, 2), lambda x: JF.lp_pool2d(x, 2, 2)),
    (lambda x: PF.avg_pool2d(x, 2, divisor_override=3), None),
], ids=["max_mask", "adaptive_mask", "lp_pool", "divisor_override"])
def test_unported_pool_options_raise(call, ref):
    """divisor_override is not ported and raises. return_mask and the lp
    pools raised too until the vision-zoo slice ported them: they now give
    the reference's results (tests/test_torch_conv_transpose_pool.py holds
    them to it in full)."""
    x = np.arange(-5.0, 11.0, dtype=np.float32).reshape(1, 1, 4, 4)
    if ref is None:
        with pytest.raises(NotImplementedError):
            call(torch.as_tensor(x))
        return
    got, want = call(torch.as_tensor(x)), ref(paddle.Tensor(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                       rtol=1e-6)


# -- batch norm -------------------------------------------------------------

BN_SHAPES = {"NCHW": (4, 3, 5, 6), "NHWC": (4, 5, 6, 3), "NC": (64, 3)}


def _bn_inputs(layout, seed=0):
    rs = np.random.RandomState(seed)
    x = (2.0 * rs.randn(*BN_SHAPES[layout]) + 0.5).astype(np.float32)
    w = (1.0 + 0.5 * rs.randn(3)).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    rm = rs.randn(3).astype(np.float32)
    rv = rs.uniform(0.5, 2.0, 3).astype(np.float32)
    return x, w, b, rm, rv


# (dtype of x and the affine, dtype of the running statistics)
BN_DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
             "bf16_f32_stats": ("bfloat16", "float32")}


@pytest.mark.parametrize("layout,dtypes", [
    (layout, dtypes) for layout in sorted(BN_SHAPES)
    for dtypes in sorted(BN_DTYPES)
    if dtypes != "bf16_f32_stats" or layout == "NCHW"])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
def test_batch_norm_matches_reference(mode, layout, dtypes):
    dtype, stats = BN_DTYPES[dtypes]
    x, w, b, rm, rv = _bn_inputs(layout)
    fmt = "NHWC" if layout == "NHWC" else "NCHW"
    kw = dict(training=mode == "train", momentum=0.9, epsilon=1e-5,
              data_format=fmt,
              use_global_stats=True if mode == "global_stats" else None)
    if mode == "global_stats":
        kw["training"] = True
    sj, st = DTYPES[stats][:2]
    jstats = []          # each reference call's own running statistics

    def ref_fn(a, c, d):
        jstats.append([paddle.Tensor(jnp.asarray(v).astype(sj))
                       for v in (rm, rv)])
        return JF.batch_norm(a, *jstats[-1], c, d, **kw)
    tstats = [torch.tensor(a).to(st) for a in (rm, rv)]
    _compare(ref_fn, lambda a, c, d: PF.batch_norm(a, *tstats, c, d, **kw),
             [x, w, b], dtype)
    for j, t in zip(jstats[0], tstats):   # moved in training, else kept
        assert t.dtype == st
        _close(t, _np(j), DTYPES[stats][2], "running stat")


@pytest.mark.parametrize("dtypes", sorted(BN_DTYPES))
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_running_stats_after_three_forwards(layout, dtypes):
    """Three training forwards of different batches, each moving the
    running mean and the unbiased variance by Paddle's momentum, in the
    buffers' own dtype."""
    dtype, stats = BN_DTYPES[dtypes]
    jdt, tdt, _ = DTYPES[dtype]
    sj, st, tol = DTYPES[stats]
    _, w, b, rm, rv = _bn_inputs(layout)
    jstats = [paddle.Tensor(jnp.asarray(a).astype(sj)) for a in (rm, rv)]
    tstats = [torch.tensor(a).to(st) for a in (rm, rv)]
    fmt = "NHWC" if layout == "NHWC" else "NCHW"
    for i in range(3):
        x = _bn_inputs(layout, seed=10 + i)[0]
        JF.batch_norm(paddle.Tensor(jnp.asarray(x).astype(jdt)), *jstats,
                      paddle.Tensor(jnp.asarray(w).astype(jdt)),
                      paddle.Tensor(jnp.asarray(b).astype(jdt)),
                      training=True, momentum=0.8, data_format=fmt)
        with torch.no_grad():
            PF.batch_norm(torch.as_tensor(x).to(tdt), *tstats,
                          torch.as_tensor(w).to(tdt),
                          torch.as_tensor(b).to(tdt), training=True,
                          momentum=0.8, data_format=fmt)
        for j, t in zip(jstats, tstats):
            _close(t, _np(j), tol, f"forward {i + 1}")
    # they moved from where they started
    assert not np.allclose(tstats[0].float().numpy(), rm, atol=1e-2)


def test_batch_norm_rounds_like_the_reference_not_like_torch():
    """bf16 training: the statistics are cast to bf16 before the
    normalization, which runs in bf16 with the weight and bias after it;
    torch's batch_norm normalizes and applies the affine in f32 and
    rounds once. The port stays nearer the reference than torch's does."""
    x, w, b, rm, rv = _bn_inputs("NCHW")
    x = np.random.RandomState(5).randn(16, 3, 8, 8).astype(np.float32) * 3
    bf = jnp.bfloat16
    want = _np(JF.batch_norm(
        paddle.Tensor(jnp.asarray(x).astype(bf)),
        paddle.Tensor(jnp.asarray(rm)), paddle.Tensor(jnp.asarray(rv)),
        paddle.Tensor(jnp.asarray(w).astype(bf)),
        paddle.Tensor(jnp.asarray(b).astype(bf)), training=True))
    xt, wt, bt = (torch.as_tensor(a).bfloat16() for a in (x, w, b))
    got = PF.batch_norm(xt, torch.as_tensor(rm), torch.as_tensor(rv), wt, bt,
                        training=True).float().numpy()
    fused = torch.nn.functional.batch_norm(
        xt.float(), None, None, wt.float(), bt.float(),
        training=True).bfloat16().float().numpy()
    assert (got != want).mean() < (fused != want).mean()


# -- optimizers -------------------------------------------------------------

OPT_CASES = {
    "sgd": (joptim.SGD, poptim.SGD, {}),
    "sgd_wd": (joptim.SGD, poptim.SGD, dict(weight_decay=0.01)),
    "momentum": (joptim.Momentum, poptim.Momentum, dict(momentum=0.9)),
    "momentum_wd": (joptim.Momentum, poptim.Momentum,
                    dict(momentum=0.9, weight_decay=0.01)),
    "nesterov": (joptim.Momentum, poptim.Momentum,
                 dict(momentum=0.9, use_nesterov=True)),
    "nesterov_wd": (joptim.Momentum, poptim.Momentum,
                    dict(momentum=0.8, use_nesterov=True,
                         weight_decay=0.05)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_reference(case, dtype):
    """Three updates of two parameters, each with a fresh gradient, the
    learning rate a float32 scalar as bench.py's step passes it: the
    parameters and the velocity after every update."""
    jcls, pcls, kw = OPT_CASES[case]
    jdt, tdt, tol = DTYPES[dtype]
    tol = OPT_TOL if tol == F32_TOL else tol
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(4, 5).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: torch.as_tensor(v).to(tdt) for k, v in params.items()}
    jopt = jcls(0.1, parameters=[], **kw)
    popt = pcls(0.1, parameters=[], **kw)
    jst, pst = jopt.tree_init(jp), popt.tree_init(tp)
    for step in (1, 2, 3):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, jst = jopt.tree_update(
            jp, {k: jnp.asarray(g).astype(jdt) for k, g in grads.items()},
            jst, jnp.float32(0.1), jnp.int32(step))
        popt.tree_update(tp, {k: torch.as_tensor(g).to(tdt)
                              for k, g in grads.items()}, pst, 0.1, step)
        for k in params:
            assert tp[k].dtype == tdt
            _close(tp[k], np.asarray(jp[k].astype(jnp.float32)), tol,
                   f"{k} after step {step}")
            for s in pst[k]:
                _close(pst[k][s], np.asarray(jst[k][s].astype(jnp.float32)),
                       tol, f"{k} {s} after step {step}")


def test_momentum_step_updates_parameters_with_grads():
    """`step()` over a model's parameters: the same update as
    `tree_update`, and a parameter without a grad stays."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    lin.bias.requires_grad_(False)
    opt = poptim.Momentum(0.1, momentum=0.9, parameters=lin.parameters())
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    lin(torch.ones(4, 3)).sum().backward()
    g = lin.weight.grad.clone()
    opt.step()
    torch.testing.assert_close(lin.weight.detach(), w0 - 0.1 * g)
    assert torch.equal(lin.bias, b0)
    assert torch.equal(opt.state_dict()["0_velocity"], g)


# -- layers -----------------------------------------------------------------

def test_conv_layer_init_and_bias_attr():
    """Weight and bias from Uniform(+-1/sqrt(fan_in)), fan_in = in / groups
    * prod(kernel); bias_attr=False leaves the bias out."""
    conv = pnn.Conv2D(8, 16, 3, groups=2, device="cpu")
    bound = 1.0 / np.sqrt(4 * 9)
    assert tuple(conv.weight.shape) == (16, 4, 3, 3)
    for t in (conv.weight, conv.bias):
        assert t.abs().max() <= bound and t.abs().max() > 0.8 * bound
    assert pnn.Conv2D(8, 16, 3, bias_attr=False, device="cpu").bias is None
    assert [k for k, _ in conv.named_parameters()] == ["weight", "bias"]
    x = torch.randn(2, 8, 6, 6)
    torch.testing.assert_close(
        conv(x), PF.conv2d(x, conv.weight, conv.bias, groups=2))


def test_batch_norm_layer_buffers_and_modes():
    """`_mean` zeros and `_variance` ones in float32 beside ones/zeros
    affine; training moves them, eval reads them."""
    bn = pnn.BatchNorm2D(3, device="cpu")
    assert list(bn.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert bn._mean.dtype == torch.float32 and not bn._mean.any()
    assert torch.equal(bn._variance, torch.ones(3))
    x = torch.randn(4, 3, 5, 5) + 2.0
    bn(x)
    assert torch.allclose(bn._mean, 0.1 * x.mean((0, 2, 3)))
    bn.eval()
    out = bn(x)
    want = (x - bn._mean[:, None, None]) / torch.sqrt(
        bn._variance[:, None, None] + 1e-5)
    torch.testing.assert_close(out, want)
    assert pnn.BatchNorm1D(3, weight_attr=False, device="cpu").weight is None


def test_sequential_child_names():
    a, b = pnn.ReLU(), pnn.Linear(2, 2, device="cpu")
    assert list(dict(pnn.Sequential(a, b).named_children())) == ["0", "1"]
    assert list(dict(pnn.Sequential(("act", a), ("fc", b))
                     .named_children())) == ["act", "fc"]
    seq = pnn.Sequential(OrderedDict([("fc", b), ("act", a)]))
    assert list(dict(seq.named_children())) == ["fc", "act"]
    assert seq[0] is b and len(seq) == 2


@pytest.mark.parametrize("layer,fn,args", [
    (pnn.MaxPool2D(3, stride=2, padding=1), "max_pool2d", (3, 2, 1)),
    (pnn.AvgPool2D(3, stride=2, padding=1, exclusive=False), "avg_pool2d",
     (3, 2, 1)),
    (pnn.AdaptiveAvgPool2D((7, 7)), "adaptive_avg_pool2d", ((7, 7),)),
    (pnn.AdaptiveMaxPool2D(3), "adaptive_max_pool2d", (3,)),
], ids=["max", "avg", "adaptive_avg", "adaptive_max"])
def test_pool_layers_call_their_functionals(layer, fn, args):
    x = torch.randn(2, 3, 10, 10)
    kw = {"exclusive": False} if fn == "avg_pool2d" else {}
    torch.testing.assert_close(layer(x), getattr(PF, fn)(x, *args, **kw))
