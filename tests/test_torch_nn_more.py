"""The nn functionals and layers this slice ports (activation, common,
norm, attention's flash_attn_unpadded, extras) against the reference's.

Functionals: one parametrised case per function and path, the same numpy
arrays to both, values at rtol 1e-5, atol 1e-5 (tests/torch_op_parity.py)
and, for the differentiable ones, the gradient of sum(out * w) (w fixed
from the seed) by each package's autograd at the same tolerance.
`interpolate` is held at its trouble spots: nearest at non-integer
scales, downsampling (antialiased), bicubic (Keys a = -0.5),
align_corners, NHWC, 1-D and 3-D. Layers: each new class built in both
packages with the reference's parameters copied in
(`convert.load_reference_state`), its forward compared at the same
tolerance. Random functionals (dropouts, rrelu in training) are held to
their structure and supports."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_reference_state
from torch_op_parity import A, port_call, ref_call, same, to_np
from torch_seq_parity import ref_run

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.default_rng(4)
X = R.standard_normal((2, 6, 5, 5)).astype(np.float32)
X2 = R.standard_normal((4, 6)).astype(np.float32)
Y2 = R.standard_normal((4, 6)).astype(np.float32)
IMG = R.standard_normal((2, 3, 8, 8)).astype(np.float32)
IMG5 = R.standard_normal((1, 2, 5, 6)).astype(np.float32)
SEQ = R.standard_normal((2, 3, 7)).astype(np.float32)
VOL = R.standard_normal((1, 2, 4, 5, 6)).astype(np.float32)
LAB = np.array([2, 0, 5, 1])
ONEHOT = np.eye(6, dtype=np.float32)[LAB]
QKV = R.standard_normal((2, 9, 3, 2, 8)).astype(np.float32)
Q4 = R.standard_normal((2, 2, 6, 8)).astype(np.float32)


def _F(pkg):
    return pkg.nn.functional


def _run(fn, args, kwargs, grad):
    """Values, and with `grad` the gradient of sum(out * w) in every float
    tensor argument, by the port's autograd and the reference's jax.grad."""
    p, leaves = port_call(getattr(_F(pt), fn), args, kwargs, grad)
    p0 = p[0] if isinstance(p, tuple) else p
    w = np.random.default_rng(9).standard_normal(tuple(p0.shape)).astype(
        np.float32)
    r, grads = ref_call(getattr(_F(paddle), fn), args, kwargs,
                        w if grad else None)
    same(to_np(p), to_np(r), TOL)
    if not grad:
        return
    (p0 * torch.tensor(w)).sum().backward()
    for i, (a, g) in enumerate(zip(leaves, grads)):
        if a.requires_grad:
            same(to_np(a.grad), to_np(g), TOL, f"grad[{i}]")


ACT = [
    ("elu", [A(X2)], {"alpha": 0.7}), ("selu", [A(X2)], {}),
    ("celu", [A(X2)], {"alpha": 1.5}), ("softplus", [A(X2 * 10)],
                                        {"beta": 2.0, "threshold": 15.0}),
    ("softshrink", [A(X2)], {"threshold": 0.3}),
    ("hardshrink", [A(X2)], {"threshold": 0.3}), ("tanhshrink", [A(X2)], {}),
    ("hardtanh", [A(X2)], {"min": -0.5, "max": 0.8}),
    ("leaky_relu", [A(X2)], {"negative_slope": 0.2}),
    ("thresholded_relu", [A(X2)], {"threshold": 0.4, "value": 0.1}),
    ("prelu", [A(X), A(np.linspace(0.1, 0.6, 6).astype(np.float32))], {}),
    ("prelu-one", [A(X2), A(np.array([0.3], np.float32))], {}),
    ("prelu-nhwc", [A(X.transpose(0, 2, 3, 1).copy()),
                    A(np.linspace(0.1, 0.6, 6).astype(np.float32))],
     {"data_format": "NHWC"}),
    ("rrelu", [A(X2)], {}), ("maxout", [A(X)], {"groups": 3}),
    ("maxout-last", [A(X2)], {"groups": 2, "axis": -1}),
    ("glu", [A(X2)], {}), ("glu-axis", [A(X)], {"axis": 1}),
    ("mish", [A(X2 * 5)], {}), ("softsign", [A(X2)], {}),
    ("log_sigmoid", [A(X2)], {}), ("sigmoid", [A(X2)], {}),
    ("silu", [A(X2)], {}), ("gelu", [A(X2)], {"approximate": True}),
    ("softmax", [A(X2)], {"axis": 0}),
]


def _fn(case_id):
    """A case's function: its id up to the variant after a "-"."""
    return case_id.split("-")[0]


@pytest.mark.parametrize("fn,args,kwargs", ACT, ids=[c[0] for c in ACT])
def test_activation_values_and_gradients(fn, args, kwargs):
    _run(_fn(fn), args, kwargs, grad=True)


INPLACE_ACT = [("relu_", []), ("elu_", [0.5]), ("tanh_", []),
               ("softmax_", [0]), ("hardtanh_", [-0.3, 0.3]),
               ("leaky_relu_", [0.1]), ("thresholded_relu_", [0.2, 0.0])]


@pytest.mark.parametrize("fn,extra", INPLACE_ACT,
                         ids=[c[0] for c in INPLACE_ACT])
def test_inplace_activations(fn, extra):
    x = torch.tensor(X2)
    assert getattr(_F(pt), fn)(x, *extra) is x
    xr = paddle.to_tensor(X2)
    getattr(_F(paddle), fn)(xr, *extra)
    same(to_np(x), to_np(xr), TOL)


INTERP = [
    ("nearest_up_7", [A(IMG5)], {"size": [7, 9]}),
    ("nearest_down_3", [A(IMG)], {"size": [3, 5]}),
    ("nearest_scale_1p5", [A(IMG)], {"scale_factor": 1.5}),
    ("bilinear_up", [A(IMG5)], {"size": [9, 11], "mode": "bilinear"}),
    ("bilinear_down", [A(IMG)], {"size": [3, 5], "mode": "bilinear"}),
    ("bilinear_scale", [A(IMG)], {"scale_factor": [0.6, 1.3],
                                  "mode": "bilinear"}),
    ("bicubic_up", [A(IMG5)], {"size": [8, 10], "mode": "bicubic"}),
    ("bicubic_down", [A(IMG)], {"size": [5, 3], "mode": "bicubic"}),
    ("bilinear_align", [A(IMG5)], {"size": [8, 4], "mode": "bilinear",
                                   "align_corners": True}),
    ("bicubic_align", [A(IMG5)], {"size": [7, 7], "mode": "bicubic",
                                  "align_corners": True}),
    ("nearest_align_ignored", [A(IMG5)], {"size": [7, 9],
                                          "align_corners": True}),
    ("bilinear_nhwc", [A(IMG.transpose(0, 2, 3, 1).copy())],
     {"size": [5, 12], "mode": "bilinear", "data_format": "NHWC"}),
    ("linear_1d", [A(SEQ)], {"size": 11, "mode": "linear",
                             "data_format": "NCL"}),
    ("trilinear_3d", [A(VOL)], {"size": [3, 7, 4], "mode": "trilinear",
                                "data_format": "NCDHW"}),
    ("area_is_linear", [A(IMG)], {"size": [3, 3], "mode": "area"}),
]


@pytest.mark.parametrize("args,kwargs", [c[1:] for c in INTERP],
                         ids=[c[0] for c in INTERP])
def test_interpolate_matches_jax_image_resize(args, kwargs):
    _run("interpolate", args, kwargs, grad=kwargs.get("mode") in
         ("bilinear", "bicubic"))


COMMON = [
    ("upsample", [A(IMG5)], {"scale_factor": 2, "mode": "nearest"}, False),
    ("zeropad2d", [A(IMG5)], {"padding": [1, 2, 0, 3]}, True),
    ("pad", [A(IMG5), [1, 1, 2, 0]], {"mode": "reflect"}, True),
    ("cosine_similarity", [A(X2), A(Y2)], {"axis": 1}, True),
    ("normalize", [A(X)], {}, True),
    ("normalize-p1", [A(X2)], {"p": 1, "axis": 0}, True),
    ("label_smooth", [A(ONEHOT)], {"epsilon": 0.2}, True),
    ("label_smooth-prior", [A(ONEHOT)],
     {"prior_dist": A(np.full((1, 6), 1 / 6, np.float32))}, False),
    ("bilinear", [A(X2[:, :3].copy()), A(Y2[:, :5].copy()),
                  A(R.standard_normal((2, 3, 5)).astype(np.float32)),
                  A(R.standard_normal((1, 2)).astype(np.float32))], {}, True),
    ("unfold", [A(IMG)], {"kernel_sizes": [3, 2], "strides": 2,
                          "paddings": [1, 0, 2, 1], "dilations": 1}, True),
    ("unfold-dilated", [A(IMG)], {"kernel_sizes": 2, "dilations": 2,
                                  "paddings": 1}, False),
    ("fold", [A(R.standard_normal((2, 12, 16)).astype(np.float32))],
     {"output_sizes": [5, 5], "kernel_sizes": 2, "strides": 1,
      "paddings": [0, 0, 0, 0]}, True),
    ("fold-padded", [A(R.standard_normal((1, 8, 25)).astype(np.float32))],
     {"output_sizes": [4, 8], "kernel_sizes": [2, 2], "strides": [1, 2],
      "paddings": [1, 1]}, False),
    ("pixel_shuffle", [A(X[:, :4].copy())], {"upscale_factor": 2}, True),
    ("pixel_shuffle-nhwc", [A(X.transpose(0, 2, 3, 1)[..., :4].copy())],
     {"upscale_factor": 2, "data_format": "NHWC"}, False),
    ("pixel_unshuffle", [A(IMG)], {"downscale_factor": 2}, True),
    ("pixel_unshuffle-nhwc", [A(IMG.transpose(0, 2, 3, 1).copy())],
     {"downscale_factor": 4, "data_format": "NHWC"}, False),
    ("channel_shuffle", [A(X)], {"groups": 3}, False),
    ("channel_shuffle-nhwc", [A(X.transpose(0, 2, 3, 1).copy())],
     {"groups": 2, "data_format": "NHWC"}, False),
    ("one_hot", [A(LAB), 7], {}, False),
    ("sequence_mask", [A(np.array([1, 3, 0]))], {"maxlen": 4}, False),
    ("sequence_mask-auto", [A(np.array([[2, 5]]))], {"dtype": "float32"},
     False),
    ("dropout2d-eval", [A(X)], {"training": False}, False),
    ("alpha_dropout-eval", [A(X)], {"training": False}, False),
    ("instance_norm", [A(X)], {"weight": A(np.linspace(.5, 1.5, 6).astype(
        np.float32)), "bias": A(np.linspace(-1, 1, 6).astype(np.float32))},
     True),
    ("instance_norm-nhwc", [A(X.transpose(0, 2, 3, 1).copy())],
     {"data_format": "NHWC"}, True),
    ("group_norm", [A(X), 3], {"weight": A(np.linspace(.5, 1.5, 6).astype(
        np.float32)), "bias": A(np.linspace(-1, 1, 6).astype(np.float32))},
     True),
    ("group_norm-nhwc", [A(X.transpose(0, 2, 3, 1).copy()), 2],
     {"data_format": "NHWC"}, True),
    ("group_norm-2d", [A(X2), 2], {}, True),
    ("local_response_norm", [A(X), 3], {"alpha": 0.1, "k": 2.0}, True),
    ("local_response_norm-nhwc", [A(X.transpose(0, 2, 3, 1).copy()), 4],
     {"data_format": "NHWC"}, False),
]


@pytest.mark.parametrize("fn,args,kwargs,grad", COMMON,
                         ids=[c[0] for c in COMMON])
def test_common_and_norm_functionals(fn, args, kwargs, grad):
    _run(_fn(fn), args, kwargs, grad)


GRID = R.uniform(-1.2, 1.2, (2, 4, 5, 2)).astype(np.float32)
THETA = np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, 0.05]],
                  [[1.2, 0.0, -0.2], [0.3, 0.8, 0.0]]], np.float32)
LOGITS = R.standard_normal((4, 6)).astype(np.float32)
COS = np.tanh(LOGITS)
PACK = R.standard_normal((10, 2, 8)).astype(np.float32)
CU = np.array([0, 3, 10], np.int32)
SE = np.array([[[[4], [5], [6], [7], [8], [9]]]], np.int32)
SE2 = np.concatenate([SE - 3, SE], -1)
OFFSET = np.array([0, 1, 3, 4, 6, 7, 9], np.int32)
COLS = np.array([0, 0, 1, 2, 1, 3, 4, 2, 5], np.int32)
RNNT = R.standard_normal((2, 4, 3, 5)).astype(np.float32)

EXTRAS = [
    ("pairwise_distance", [A(X2), A(Y2)], {}, True),
    ("pairwise_distance-inf", [A(X2), A(Y2)], {"p": float("inf"),
                                               "keepdim": True}, False),
    ("pairwise_distance-p3", [A(X2), A(Y2)], {"p": 3.0}, False),
    ("affine_grid", [A(THETA), [2, 3, 4, 5]], {}, True),
    ("affine_grid-unaligned", [A(THETA), [2, 3, 4, 5]],
     {"align_corners": False}, False),
    *[(f"grid_sample-{m}-{p}-{a}", [A(IMG[:, :, :6, :7].copy()), A(GRID)],
       {"mode": m, "padding_mode": p, "align_corners": a}, m == "bilinear")
      for m in ("bilinear", "nearest")
      for p in ("zeros", "border", "reflection") for a in (True, False)],
    ("fractional_max_pool2d", [A(IMG), 3], {"random_u": 0.3}, True),
    ("fractional_max_pool2d-mask", [A(IMG5), [2, 4]],
     {"random_u": 0.7, "return_mask": True}, False),
    ("fractional_max_pool3d", [A(VOL), [2, 3, 2]], {"random_u": 0.4}, False),
    ("temporal_shift", [A(R.standard_normal((6, 8, 2, 2)).astype(
        np.float32)), 3], {}, True),
    ("feature_alpha_dropout-eval", [A(X)], {"training": False}, False),
    ("multi_margin_loss", [A(LOGITS), A(LAB)], {}, True),
    ("multi_margin_loss-p2-weight", [A(LOGITS), A(LAB)],
     {"p": 2, "margin": 0.5, "weight": A(np.linspace(0.5, 2, 6).astype(
         np.float32)), "reduction": "none"}, False),
    ("hsigmoid_loss", [A(X2), A(LAB), 6,
                       A(R.standard_normal((6, 6)).astype(np.float32)),
                       A(R.standard_normal(6).astype(np.float32))], {}, True),
    ("hsigmoid_loss-pow2", [A(X2), A(np.array([0, 3, 7, 4])), 8,
                            A(R.standard_normal((8, 6)).astype(np.float32))],
     {}, False),
    ("flash_attn_qkvpacked", [A(QKV)], {}, True),
    ("flash_attn_qkvpacked-causal", [A(QKV)], {"causal": True}, False),
    ("flash_attn_varlen_qkvpacked", [A(np.stack([PACK] * 3, 1)),
                                     A(CU), A(CU), 7, 7, 0.35],
     {"causal": True}, False),
    ("flash_attn_unpadded", [A(PACK), A(PACK[::-1].copy()), A(PACK),
                             A(CU), A(CU), 7, 7, 0.35], {}, True),
    ("flash_attn_unpadded-causal", [A(PACK[:8].copy()), A(PACK), A(PACK),
                                    A(np.array([0, 3, 8], np.int32)),
                                    A(CU), 5, 7, 0.35], {"causal": True},
     False),
    ("flashmask_attention", [A(QKV[:, :6, 0].copy()), A(QKV[:, :6, 1].copy()),
                             A(QKV[:, :6, 2].copy())],
     {"startend_row_indices": A(SE)}, True),
    ("flashmask_attention-startend-causal",
     [A(QKV[:, :6, 0].copy()), A(QKV[:, :6, 1].copy()),
      A(QKV[:, :6, 2].copy())],
     {"startend_row_indices": A(SE2), "causal": True}, False),
    ("flashmask_attention-none", [A(QKV[:, :, 0].copy()),
                                  A(QKV[:, :, 1].copy()),
                                  A(QKV[:, :, 2].copy())], {}, False),
    ("margin_cross_entropy", [A(COS), A(LAB)], {}, True),
    ("margin_cross_entropy-softmax", [A(COS), A(LAB)],
     {"margin1": 0.9, "margin2": 0.2, "margin3": 0.1, "scale": 30.0,
      "return_softmax": True, "reduction": "sum"}, False),
    ("class_center_sample", [A(LAB), 20, 8], {}, False),
    ("sparse_attention", [None, A(OFFSET), A(COLS), A(Q4),
                          A(Q4[:, :, ::-1].copy()), A(Q4)], {}, True),
    ("rnnt_loss", [A(RNNT), A(np.array([[1, 2], [3, 0]], np.int32)),
                   A(np.array([4, 3], np.int32)),
                   A(np.array([2, 1], np.int32))], {}, True),
    ("rnnt_loss-none", [A(RNNT), A(np.array([[1, 2], [3, 4]], np.int32)),
                        A(np.array([2, 4], np.int32)),
                        A(np.array([2, 2], np.int32))],
     {"blank": 4, "reduction": "none"}, False),
    ("adaptive_log_softmax_with_loss",
     [A(X2), A(np.array([0, 3, 5, 8])),
      A(R.standard_normal((6, 4)).astype(np.float32)),
      [(A(R.standard_normal((6, 3)).astype(np.float32)),
        A(R.standard_normal((3, 3)).astype(np.float32))),
       (A(R.standard_normal((6, 2)).astype(np.float32)),
        A(R.standard_normal((2, 3)).astype(np.float32)))], [2, 5]],
     {"head_bias": A(np.linspace(-1, 1, 4).astype(np.float32))}, True),
]


@pytest.mark.parametrize("fn,args,kwargs,grad", EXTRAS,
                         ids=[c[0] for c in EXTRAS])
def test_extras_functionals(fn, args, kwargs, grad):
    _run(_fn(fn), args, kwargs, grad)


def test_random_functionals_structure():
    pt.seed(0)
    x = torch.ones(8, 16, 3, 3)
    y = pt.nn.functional.dropout2d(x, 0.5)
    per_channel = y.reshape(8, 16, -1)
    assert ((per_channel == 0).all(-1) | (per_channel == 2).all(-1)).all()
    y = pt.nn.functional.dropout3d(torch.ones(4, 8, 2, 2, 2), 0.5)
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    a = pt.nn.functional.alpha_dropout(torch.zeros(10000), 0.2)
    assert len(a.unique()) == 2 and abs(float(a.mean())) < 0.05
    f = pt.nn.functional.feature_alpha_dropout(torch.zeros(64, 32, 4), 0.3)
    assert (f == f[:, :, :1]).all() and len(f.unique()) == 2
    z = torch.tensor(X2)
    r = pt.nn.functional.rrelu(z, 0.1, 0.3, training=True)
    neg = z < 0
    ratio = (r[neg] / z[neg])
    assert ((ratio >= 0.1) & (ratio <= 0.3)).all()
    np.testing.assert_array_equal(r[~neg].numpy(), z[~neg].numpy())
    u = pt.nn.functional.fractional_max_pool2d(torch.tensor(IMG), 3)
    assert tuple(u.shape) == (2, 3, 3, 3)


def _ref_state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


LAYERS = [
    ("ELU", (0.5,), [X2]), ("SELU", (), [X2]), ("CELU", (), [X2]),
    ("GELU", (), [X2]), ("Sigmoid", (), [X2]), ("Tanh", (), [X2]),
    ("Softmax", (0,), [X2]), ("LogSoftmax", (), [X2]),
    ("LogSigmoid", (), [X2]), ("Hardshrink", (), [X2]),
    ("Hardtanh", (), [X2]), ("LeakyReLU", (0.3,), [X2]), ("Mish", (), [X2]),
    ("Silu", (), [X2]), ("Softplus", (), [X2]), ("Softshrink", (), [X2]),
    ("Softsign", (), [X2]), ("Tanhshrink", (), [X2]),
    ("ThresholdedReLU", (), [X2]), ("Maxout", (2,), [X]), ("GLU", (), [X2]),
    ("RReLU", (), [X2]), ("PReLU", (6, 0.1), [X]),
    ("Identity", (3, "unused"), [X2]), ("Flatten", (), [X]),
    ("Dropout2D", (), [X]), ("Dropout3D", (), [VOL]),
    ("AlphaDropout", (), [X2]),
    ("Upsample", (None, 2.0, "bilinear"), [IMG5]),
    ("UpsamplingNearest2D", ([7, 9],), [IMG5]),
    ("UpsamplingBilinear2D", (None, 2),  [IMG5]),
    ("Pad1D", ([1, 2],), [SEQ]), ("Pad2D", ([1, 0, 2, 1], "replicate"), [X]),
    ("Pad3D", ([1, 1, 0, 1, 2, 0],), [VOL]), ("ZeroPad2D", ([1, 0, 1, 2],), [X]),
    ("CosineSimilarity", (), [X2, Y2]),
    ("Bilinear", (6, 6, 3), [X2, Y2]),
    ("Unfold", ([2, 2],), [IMG]), ("Fold", ([5, 5], 2), [
        R.standard_normal((2, 12, 16)).astype(np.float32)]),
    ("PixelShuffle", (2,), [X[:, :4].copy()]),
    ("PixelUnshuffle", (2,), [IMG]), ("ChannelShuffle", (2,), [X]),
    ("GroupNorm", (3, 6), [X]), ("InstanceNorm1D", (3,), [SEQ]),
    ("InstanceNorm2D", (6,), [X]), ("InstanceNorm3D", (2,), [VOL]),
    ("LocalResponseNorm", (3,), [X]), ("ZeroPad1D", ([2, 1],), [SEQ]),
    ("ZeroPad3D", ([1, 0, 0, 1, 2, 1],), [VOL]), ("Unflatten", (1, [2, 3]), [X2]),
    ("Softmax2D", (), [X]), ("PairwiseDistance", (), [X2, Y2]),
    ("FractionalMaxPool2D", (3, None, 0.5), [IMG]),
    ("FractionalMaxPool3D", (2, None, 0.5), [VOL]),
    ("MultiMarginLoss", (), [LOGITS, LAB]),
    ("HSigmoidLoss", (6, 6), [X2, LAB]),
    ("FeatureAlphaDropout", (), [X]),
    ("RNNTLoss", (), [RNNT, np.array([[1, 2], [3, 0]], np.int32),
                      np.array([4, 3], np.int32),
                      np.array([2, 1], np.int32)]),
    ("AdaptiveLogSoftmaxWithLoss", (6, 10, [3, 6]),
     [X2, np.array([0, 4, 7, 9])]),
]


@pytest.mark.parametrize("name,ctor,inputs", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layers_match_reference(name, ctor, inputs):
    ref = getattr(paddle.nn, name)(*ctor)
    port = getattr(pt.nn, name)(*ctor, **(
        {"device": "cpu"} if name in ("PReLU", "Bilinear", "GroupNorm",
                                      "HSigmoidLoss",
                                      "AdaptiveLogSoftmaxWithLoss")
        or name.startswith("InstanceNorm") else {}))
    assert isinstance(port, pt.nn.Layer)
    state = _ref_state(ref)
    assert list(port.state_dict()) == list(state), name
    load_reference_state(port, state)
    port.eval()
    p = port(*[torch.tensor(a) for a in inputs])
    r, _ = ref_run(ref, lambda f: f(*inputs), training=False)
    same(to_np(p), to_np(r), TOL)


def test_parameter_dict():
    params = {"a": torch.nn.Parameter(torch.ones(2)),
              "b": torch.nn.Parameter(torch.zeros(3))}
    d = pt.nn.ParameterDict(params)
    assert list(d.keys()) == ["a", "b"] and len(d) == 2 and "a" in d
    d["c"] = torch.nn.Parameter(torch.ones(1))
    assert [n for n, _ in d.named_parameters()] == ["a", "b", "c"]
    assert d["b"] is params["b"]


def test_adaptive_log_prob_sums_to_one():
    pt.seed(0)
    layer = pt.nn.AdaptiveLogSoftmaxWithLoss(6, 10, [3, 6], device="cpu")
    lp = layer.log_prob(torch.tensor(X2))
    np.testing.assert_allclose(lp.exp().sum(-1).detach().numpy(), 1.0,
                               rtol=1e-5)
    out, _ = layer(torch.tensor(X2), torch.tensor([0, 4, 7, 9]))
    np.testing.assert_allclose(out.detach().numpy(), lp.gather(
        1, torch.tensor([[0], [4], [7], [9]]))[:, 0].detach().numpy(),
        rtol=1e-5, atol=1e-6)
