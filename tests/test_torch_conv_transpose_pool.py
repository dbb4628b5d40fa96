"""The port's transposed convolutions, max-pool masks, max unpooling, lp
pools and adaptive max pools against the JAX package's: conv1d/2d/3d
_transpose over stride, dilation, groups, output_padding, output_size,
SAME and VALID (a kernel smaller than the stride, where the reference's
high pad is negative, included) and channels-last, with their layers and
gradients; max_pool1d/2d/3d(return_mask=True) indices on ReLU'd inputs
full of ties (and on infinities and NaN), equal exactly; max_unpool round
trips; lp_pool1d/2d on negative inputs (the reference pools |x|^p);
adaptive_max_pool1d/3d and their (out, None) mask. Inputs come from
numpy seeds; float32 results within F32_TOL and gradients within
GRAD_TOL of their tensor's largest |value| (tests/test_torch_vision.py's
tolerances)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.nn import functional as PF


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


def _close(got, want, tol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want._data if hasattr(want, "_data") else want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _grads_match(jfn, pfn, arrays, cot_seed=9):
    """The gradient of sum(f(*arrays) * cotangent) for every input."""
    out = np.asarray(jfn(*[_j(a) for a in arrays])._data)
    cot = np.random.RandomState(cot_seed).randn(*out.shape).astype(
        np.float32)

    def loss(*raw):
        return (jfn(*[paddle.Tensor(r, stop_gradient=False)
                      for r in raw])._data * cot).sum()
    want = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    (pfn(*ts) * torch.as_tensor(cot)).sum().backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-3))


# -- transposed convolutions ---------------------------------------------------

CASES_2D = [
    dict(stride=2, padding=1),
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=2, padding="SAME"),
    dict(stride=2, padding="VALID"),
    dict(stride=3, padding="SAME", k=2),          # kernel < stride
    dict(stride=4, padding="SAME", k=3),          # kernel < stride, odd
    dict(stride=2, padding=[0, 1, 1, 0]),         # asymmetric
    dict(stride=2, padding=[2, 1, 0, 2]),
    dict(stride=1, padding=2),                    # pad > k_eff - 1 - ...
    dict(stride=2, padding=1, dilation=2),
    dict(stride=2, padding=1, groups=2),
    dict(stride=3, padding=1, groups=4, dilation=2, output_padding=2),
    dict(stride=2, padding=1, output_size=[8, 9]),
    dict(stride=3, padding="SAME", output_size=[13, 16]),
]


@pytest.mark.parametrize("case", CASES_2D, ids=[str(i) for i in
                                                range(len(CASES_2D))])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_transpose_matches_reference(case, fmt):
    kw = dict(case)
    k = kw.pop("k", 3)
    groups = kw.get("groups", 1)
    rs = np.random.RandomState(len(str(case)))
    x = rs.randn(2, 4, 4, 5).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w = rs.randn(4, 8 // groups, k, k).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    want = JF.conv2d_transpose(_j(x), _j(w), _j(b), data_format=fmt, **kw)
    got = PF.conv2d_transpose(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), data_format=fmt, **kw)
    _close(got, want)


@pytest.mark.parametrize("case", [CASES_2D[0], CASES_2D[4], CASES_2D[6],
                                  CASES_2D[11], CASES_2D[12]],
                         ids=["pad1", "same_k2_s3", "asym", "grouped",
                              "output_size"])
def test_conv2d_transpose_gradients_match_jax_grad(case):
    kw = dict(case)
    k = kw.pop("k", 3)
    groups = kw.get("groups", 1)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 4, 5).astype(np.float32)
    w = rs.randn(4, 8 // groups, k, k).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    _grads_match(lambda a, c, d: JF.conv2d_transpose(a, c, d, **kw),
                 lambda a, c, d: PF.conv2d_transpose(a, c, d, **kw),
                 [x, w, b])


@pytest.mark.parametrize("kw", [dict(stride=2, padding=1),
                                dict(stride=3, padding="SAME"),
                                dict(stride=2, padding=[1, 0],
                                     output_padding=1, dilation=2),
                                dict(stride=2, groups=2, output_size=[12])],
                         ids=["pad1", "same", "asym_dil", "grouped_size"])
@pytest.mark.parametrize("fmt", ["NCL", "NLC"])
def test_conv1d_transpose_matches_reference(kw, fmt):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 5).astype(np.float32)
    if fmt == "NLC":
        x = x.transpose(0, 2, 1).copy()
    w = rs.randn(4, 6 // kw.get("groups", 1), 3).astype(np.float32)
    want = JF.conv1d_transpose(_j(x), _j(w), data_format=fmt, **kw)
    got = PF.conv1d_transpose(torch.tensor(x), torch.tensor(w),
                              data_format=fmt, **kw)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(stride=2, padding=1),
                                dict(stride=2, padding="SAME"),
                                dict(stride=(1, 2, 3), padding=[0, 1, 1, 0,
                                                                1, 1],
                                     output_padding=(0, 1, 2))],
                         ids=["pad1", "same", "asym"])
@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_conv3d_transpose_matches_reference(kw, fmt):
    rs = np.random.RandomState(6)
    x = rs.randn(1, 3, 3, 4, 3).astype(np.float32)
    if fmt == "NDHWC":
        x = np.moveaxis(x, 1, -1).copy()
    w = rs.randn(3, 2, 3, 3, 3).astype(np.float32)
    want = JF.conv3d_transpose(_j(x), _j(w), data_format=fmt, **kw)
    got = PF.conv3d_transpose(torch.tensor(x), torch.tensor(w),
                              data_format=fmt, **kw)
    _close(got, want)


def test_output_size_out_of_range_and_with_output_padding_raise():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError):
        PF.conv2d_transpose(x, w, stride=2, padding=1, output_size=[9, 9])
    with pytest.raises(ValueError):
        PF.conv2d_transpose(x, w, stride=2, padding=1, output_padding=1,
                            output_size=[8, 8])


@pytest.mark.parametrize("n,args", [
    (1, dict(in_channels=4, out_channels=6, kernel_size=3, stride=2,
             padding=1, output_padding=1, groups=2)),
    (2, dict(in_channels=4, out_channels=6, kernel_size=(3, 2), stride=2,
             padding="SAME", dilation=1, groups=2)),
    (3, dict(in_channels=2, out_channels=4, kernel_size=2, stride=2)),
], ids=["1d", "2d", "3d"])
def test_transpose_layers_match_reference(n, args):
    """The layers' weight (in, out / groups, *k) and bias, carried by the
    converter; forward with and without output_size (which overrides
    output_padding, as the reference's layer)."""
    paddle.seed(0)
    ref = getattr(jnn, f"Conv{n}DTranspose")(**args)
    port = getattr(pnn, f"Conv{n}DTranspose")(**args, device="cpu")
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    load_reference_state(port, state)
    rs = np.random.RandomState(n)
    x = rs.randn(*((2, args["in_channels"]) + (4,) * n)).astype(np.float32)
    _close(port(torch.tensor(x)), ref(_j(x)))
    size = [8 if n == 1 else 9] * n       # default + 1
    _close(port(torch.tensor(x), output_size=size),
           ref(_j(x), output_size=size))


def test_transpose_layer_init_bounds():
    """Uniform(+-1/sqrt(fan_in)) with fan_in = in / groups * prod(k), as
    the reference's `_ConvNd`."""
    torch.manual_seed(0)
    layer = pnn.Conv2DTranspose(64, 32, 4, groups=2, device="cpu")
    bound = 1.0 / np.sqrt(32 * 16)
    assert layer.weight.shape == (64, 16, 4, 4)
    assert bound * 0.98 < layer.weight.abs().max() <= bound


# -- max pool masks and unpooling ----------------------------------------------

def _relu_ties(shape, seed=0):
    """ReLU'd normals: half zeros, so most windows tie; plus repeated
    values."""
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0)
    x = np.round(x, 1).astype(np.float32)
    return x


MASK_CASES = [
    (2, dict(kernel_size=2)),
    (2, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=3, stride=2, ceil_mode=True)),
    (2, dict(kernel_size=3, stride=1, padding="SAME")),
    (2, dict(kernel_size=2, stride=2, padding=[0, 1, 1, 0])),
    (2, dict(kernel_size=(2, 3), stride=(1, 2), data_format="NHWC")),
    (1, dict(kernel_size=3, stride=2, padding=1)),
    (1, dict(kernel_size=2, ceil_mode=True)),
    (3, dict(kernel_size=2)),
    (3, dict(kernel_size=3, stride=2, padding=1)),
]


@pytest.mark.parametrize("n,kw", MASK_CASES,
                         ids=[f"{n}d_{i}" for i, (n, _) in
                              enumerate(MASK_CASES)])
def test_max_pool_mask_equals_reference(n, kw):
    shape = {1: (2, 3, 17), 2: (2, 3, 9, 11), 3: (1, 2, 5, 6, 7)}[n]
    x = _relu_ties(shape, n)
    if kw.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    fn = f"max_pool{n}d"
    want_out, want_idx = getattr(JF, fn)(_j(x), return_mask=True, **kw)
    got_out, got_idx = getattr(PF, fn)(torch.tensor(x), return_mask=True,
                                       **kw)
    assert got_idx.dtype == torch.int64
    np.testing.assert_array_equal(got_idx.numpy(),
                                  np.asarray(want_idx._data))
    np.testing.assert_array_equal(got_out.numpy(),
                                  np.asarray(want_out._data))


def test_max_pool_mask_non_finite_values():
    """+inf and NaN count as -inf for the mask (the reference maps every
    non-finite value so); a window of them only takes its lowest real
    index."""
    x = _relu_ties((1, 2, 6, 6), 4)
    x[0, 0, 0, :] = np.inf
    x[0, 1, :2, :2] = np.nan
    x[0, 1, 4:, 4:] = -np.inf
    want = JF.max_pool2d(_j(x), 2, return_mask=True)[1]
    got = PF.max_pool2d(torch.tensor(x), 2, return_mask=True)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_unpool_round_trip_matches_reference(n):
    """max_pool(return_mask) then max_unpool: each max back at its place,
    zeros elsewhere; the layer, and an explicit output_size."""
    shape = {1: (2, 3, 16), 2: (2, 3, 8, 10), 3: (1, 2, 4, 6, 4)}[n]
    x = _relu_ties(shape, 7)
    pooled, idx = getattr(PF, f"max_pool{n}d")(torch.tensor(x), 2,
                                               return_mask=True)
    jp, ji = getattr(JF, f"max_pool{n}d")(_j(x), 2, return_mask=True)
    want = getattr(JF, f"max_unpool{n}d")(jp, ji, 2)
    got = getattr(PF, f"max_unpool{n}d")(pooled, idx, 2)
    _close(got, want, tol=0)
    back = got.numpy()
    assert np.array_equal(np.where(back != 0, x, 0), back)
    layer = getattr(pnn, f"MaxUnPool{n}D")(2)
    _close(layer(pooled, idx), want, tol=0)
    size = [2, 3] + [s + 1 for s in shape[2:]]
    _close(getattr(PF, f"max_unpool{n}d")(pooled, idx, 2, output_size=size),
           getattr(JF, f"max_unpool{n}d")(jp, ji, 2, output_size=size),
           tol=0)


def test_max_unpool_gradient_matches_jax_grad():
    x = _relu_ties((2, 3, 8, 10), 8) + 0.05
    _, idx = PF.max_pool2d(torch.tensor(x), 2, return_mask=True)
    _, jidx = JF.max_pool2d(_j(x), 2, return_mask=True)
    v = np.random.RandomState(1).randn(2, 3, 4, 5).astype(np.float32)
    _grads_match(lambda a: JF.max_unpool2d(a, jidx, 2),
                 lambda a: PF.max_unpool2d(a, idx, 2), [v])


def test_max_pool_with_mask_gradient_matches_jax_grad():
    """The pooled values' gradient with return_mask set: the reference's
    is that of its pool without the mask (its mask path has no
    gradient)."""
    x = np.random.RandomState(2).randn(2, 3, 9, 9).astype(np.float32)
    _grads_match(lambda a: JF.max_pool2d(a, 3, 2, 1),
                 lambda a: PF.max_pool2d(a, 3, 2, 1, return_mask=True)[0],
                 [x])


def test_max_pool_mask_layer():
    x = _relu_ties((2, 3, 8, 8), 3)
    out, idx = pnn.MaxPool2D(2, return_mask=True)(torch.tensor(x))
    want = JF.max_pool2d(_j(x), 2, return_mask=True)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want._data))


# -- lp pools and adaptive max pools ---------------------------------------------

LP_CASES = [(1, 2.0, dict(kernel_size=3, stride=2)),
            (1, 3.0, dict(kernel_size=2, padding=1)),
            (2, 2.0, dict(kernel_size=2)),
            (2, 1.5, dict(kernel_size=3, stride=2, padding=1,
                          ceil_mode=True)),
            (2, 4.0, dict(kernel_size=(2, 3), padding="SAME"))]


@pytest.mark.parametrize("n,p,kw", LP_CASES,
                         ids=[f"{n}d_p{p}_{i}" for i, (n, p, _) in
                              enumerate(LP_CASES)])
def test_lp_pool_on_negative_inputs_matches_reference(n, p, kw):
    """Mostly negative inputs: the reference pools |x|^p (torch's
    lp_pool would pool x^p and give NaN or the wrong sign); the layer
    too; and the gradient."""
    shape = (2, 3, 12) if n == 1 else (2, 3, 8, 9)
    x = (np.random.RandomState(n).randn(*shape) - 1.0).astype(np.float32)
    fn = f"lp_pool{n}d"
    want = getattr(JF, fn)(_j(x), p, **kw)
    got = getattr(PF, fn)(torch.tensor(x), p, **kw)
    assert torch.isfinite(got).all()
    _close(got, want)
    layer = getattr(pnn, f"LPPool{n}D")(p, **kw)
    _close(layer(torch.tensor(x)), want)
    _grads_match(lambda a: getattr(JF, fn)(a, p, **kw),
                 lambda a: getattr(PF, fn)(a, p, **kw), [x])


@pytest.mark.parametrize("n,out", [(1, 5), (1, 4), (3, 2), (3, (2, 3, 1))])
def test_adaptive_max_pool_matches_reference(n, out):
    """Uneven bins; return_mask gives (out, None) as the reference's; the
    layers; the gradient."""
    shape = (2, 3, 11) if n == 1 else (1, 2, 5, 7, 3)
    x = np.random.RandomState(n).randn(*shape).astype(np.float32)
    fn = f"adaptive_max_pool{n}d"
    want = getattr(JF, fn)(_j(x), out)
    _close(getattr(PF, fn)(torch.tensor(x), out), want)
    got, mask = getattr(PF, fn)(torch.tensor(x), out, return_mask=True)
    assert mask is None and getattr(JF, fn)(_j(x), out,
                                            return_mask=True)[1] is None
    _close(got, want)
    _close(getattr(pnn, f"AdaptiveMaxPool{n}D")(out)(torch.tensor(x)), want)
    _grads_match(lambda a: getattr(JF, fn)(a, out),
                 lambda a: getattr(PF, fn)(a, out), [x])
