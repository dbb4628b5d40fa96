"""The port's 24 loss functionals and the loss layers against the JAX
package's: values and the gradients of their sum with respect to every
float input, in float32, on inputs drawn from numpy seeds.

cross_entropy is held in every form the reference takes: hard labels with
`ignore_index`, a trailing label axis, class weights (whose mean divides
by the valid positions' weights), label smoothing, soft labels (given by
`soft_label`, or told by a float label of the logits' shape),
`use_softmax=False` on probabilities, a class axis other than the last,
each reduction. The tolerance is a few float32 roundings (the same
formulas, reduced in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF

TOL = 2e-5

rng = np.random.RandomState(0)
F = lambda *s: rng.randn(*s).astype(np.float32)      # noqa: E731
P = lambda *s: rng.uniform(0.05, 0.95, s).astype(np.float32)  # noqa: E731


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


LABELS = np.array([0, 3, -100, 4, 1, 2], np.int64)
SIGNS = np.array([1, -1, 1, 1, -1, -1], np.float32)

# name: (functional, [inputs], differentiable input indices, kwargs)
CASES = {
    "ce_hard_ignore": ("cross_entropy", [F(6, 5), LABELS], [0], {}),
    "ce_hard_axis1_none": ("cross_entropy",
                           [F(4, 5, 3), rng.randint(0, 5, (4, 3))], [0],
                           dict(axis=1, reduction="none")),
    "ce_label_column_weight": ("cross_entropy",
                               [F(6, 5), LABELS[:, None], P(5)], [0],
                               dict(weight=True)),
    "ce_weight_ignore_none": ("cross_entropy", [F(6, 5), LABELS, P(5)],
                              [0], dict(weight=True, reduction="none")),
    "ce_smoothing_sum": ("cross_entropy", [F(6, 5), LABELS], [0],
                         dict(label_smoothing=0.1, reduction="sum")),
    "ce_soft_flag_smoothing": ("cross_entropy",
                               [F(6, 5), _softmax(F(6, 5))], [0],
                               dict(soft_label=True, label_smoothing=0.2)),
    "ce_soft_by_dtype": ("cross_entropy", [F(6, 5), _softmax(F(6, 5))],
                         [0], {}),
    "ce_probabilities": ("cross_entropy", [_softmax(F(6, 5)), LABELS], [0],
                         dict(use_softmax=False)),
    "softmax_with_ce": ("softmax_with_cross_entropy",
                        [F(6, 5), LABELS[:, None]], [0], {}),
    "bce_weight": ("binary_cross_entropy", [P(6, 3), P(6, 3), P(6, 3)],
                   [0], dict(weight=True)),
    "bce_logits_pos_weight": ("binary_cross_entropy_with_logits",
                              [F(6, 3), P(6, 3), P(3) + 0.5, P(6, 3)], [0],
                              dict(pos_weight=True, weight=True)),
    "bce_logits_sum": ("binary_cross_entropy_with_logits",
                       [F(6, 3), P(6, 3)], [0], dict(reduction="sum")),
    "mse": ("mse_loss", [F(4, 3), F(4, 3)], [0, 1], {}),
    "l1_sum": ("l1_loss", [F(4, 3), F(4, 3)], [0, 1],
               dict(reduction="sum")),
    "square_error_cost": ("square_error_cost", [F(4, 3), F(4, 3)], [0, 1],
                          {}),
    "nll_weight_ignore": ("nll_loss",
                          [np.log(_softmax(F(6, 5))), LABELS, P(5)], [0],
                          dict(weight=True)),
    "nll_spatial_none": ("nll_loss", [np.log(_softmax(F(2, 5, 3), 1), ),
                                      rng.randint(0, 5, (2, 3))], [0],
                         dict(reduction="none")),
    "smooth_l1_delta": ("smooth_l1_loss", [F(5, 4), F(5, 4)], [0, 1],
                        dict(delta=0.5)),
    "kl_div_batchmean": ("kl_div", [np.log(_softmax(F(4, 5))),
                                    _softmax(F(4, 5))], [0, 1],
                         dict(reduction="batchmean")),
    "kl_div_log_target": ("kl_div", [np.log(_softmax(F(4, 5))),
                                     np.log(_softmax(F(4, 5)))], [0, 1],
                          dict(log_target=True, reduction="sum")),
    "margin_ranking": ("margin_ranking_loss", [F(6), F(6), SIGNS], [0, 1],
                       dict(margin=0.3)),
    "hinge_embedding": ("hinge_embedding_loss", [F(6, 2), SIGNS[:, None]],
                        [0], dict(margin=0.5)),
    "cosine_embedding": ("cosine_embedding_loss", [F(6, 4), F(6, 4), SIGNS],
                         [0, 1], dict(margin=0.1)),
    "triplet_swap_p1": ("triplet_margin_loss", [F(5, 4), F(5, 4), F(5, 4)],
                        [0, 1, 2], dict(p=1.0, swap=True)),
    "triplet_distance_default": ("triplet_margin_with_distance_loss",
                                 [F(5, 4), F(5, 4), F(5, 4)], [0, 1, 2],
                                 dict(margin=0.5, reduction="sum")),
    "multi_label_soft_margin": ("multi_label_soft_margin_loss",
                                [F(5, 4), (P(5, 4) > 0.5).astype(
                                    np.float32), P(4)], [0],
                                dict(weight=True)),
    "soft_margin": ("soft_margin_loss", [F(5, 4), np.sign(F(5, 4))], [0],
                    {}),
    "poisson_log_full": ("poisson_nll_loss", [F(5, 4), P(5, 4) * 4], [0],
                         dict(full=True)),
    "poisson_raw": ("poisson_nll_loss", [P(5, 4) + 0.5, P(5, 4) * 4], [0],
                    dict(log_input=False, reduction="sum")),
    "gaussian_full": ("gaussian_nll_loss", [F(5, 4), F(5, 4), P(5, 4)],
                      [0, 1, 2], dict(full=True)),
    "log_loss": ("log_loss", [P(6, 1), (P(6, 1) > 0.5).astype(np.float32)],
                 [0], {}),
    "sigmoid_focal_normalizer": ("sigmoid_focal_loss",
                                 [F(6, 3), (P(6, 3) > 0.5).astype(
                                     np.float32), np.float32([4.0])], [0],
                                 dict(normalizer=True)),
    "sigmoid_focal_mean": ("sigmoid_focal_loss",
                           [F(6, 3), (P(6, 3) > 0.5).astype(np.float32)],
                           [0], dict(reduction="mean", gamma=1.5)),
    "dice": ("dice_loss", [_softmax(F(3, 4, 5)),
                           rng.randint(0, 5, (3, 4, 1))], [0], {}),
    "npair": ("npair_loss", [F(6, 4), F(6, 4),
                             np.array([0, 1, 0, 2, 1, 2], np.float32)],
              [0, 1], {}),
    "ctc_mean": ("ctc_loss", [F(12, 2, 6), np.array([[1, 2, 2], [3, 1, 0]]),
                              np.array([12, 10]), np.array([3, 2])], [0],
                 {}),
    "ctc_sum_blank": ("ctc_loss", [F(8, 2, 5), np.array([[1, 1], [2, 3]]),
                                   np.array([8, 7]), np.array([2, 2])],
                      [0], dict(blank=4, reduction="sum")),
}

# keyword inputs passed positionally in the case lists
_KW_INPUTS = ("pos_weight", "weight", "normalizer")


def _call(mod, fname, inputs, kw):
    kw = dict(kw)
    n_kw = sum(1 for k in _KW_INPUTS if kw.get(k) is True)
    pos = inputs[:len(inputs) - n_kw]
    extra = list(inputs[len(inputs) - n_kw:])
    for k in _KW_INPUTS:
        if kw.get(k) is True:
            kw[k] = extra.pop(0)
    return getattr(mod, fname)(*pos, **kw)


def _reference(fname, arrays, diff, kw):
    ts = [paddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    out = _call(JF, fname, ts, kw)
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.sum() for o in outs).backward()
    return ([np.asarray(o._data) for o in outs],
            [np.asarray(ts[i].grad._data) for i in diff])


def _port(fname, arrays, diff, kw):
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = _call(PF, fname, ts, kw)
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.sum() for o in outs).backward()
    return ([o.detach().numpy() for o in outs],
            [ts[i].grad.numpy() for i in diff])


def _close(got, want, what):
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    fname, arrays, diff, kw = CASES[case]
    want_out, want_grads = _reference(fname, arrays, diff, kw)
    got_out, got_grads = _port(fname, arrays, diff, kw)
    _close(got_out, want_out, case + " value")
    _close(got_grads, want_grads, case + " grads")


def test_every_reference_loss_is_covered():
    ported = set(PF.loss.__all__)
    assert ported == set(JF.loss.__all__) and len(ported) == 24
    assert ported == {c[0] for c in CASES.values()}


def test_triplet_with_a_distance_function():
    a, p, n = F(5, 4), F(5, 4), F(5, 4)
    want = JF.triplet_margin_with_distance_loss(
        *map(paddle.to_tensor, (a, p, n)),
        distance_function=lambda x, y: ((x - y) ** 2).sum(-1), swap=True)
    got = PF.triplet_margin_with_distance_loss(
        *map(torch.tensor, (a, p, n)),
        distance_function=lambda x, y: ((x - y) ** 2).sum(-1), swap=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=TOL, atol=TOL)


LAYERS = [
    ("CrossEntropyLoss", dict(ignore_index=-100, label_smoothing=0.1),
     [F(6, 5), LABELS]),
    ("MSELoss", dict(reduction="sum"), [F(4, 3), F(4, 3)]),
    ("L1Loss", {}, [F(4, 3), F(4, 3)]),
    ("NLLLoss", dict(reduction="sum"),
     [np.log(_softmax(F(6, 5))), LABELS]),
    ("BCELoss", {}, [P(6, 3), P(6, 3)]),
    ("BCEWithLogitsLoss", {}, [F(6, 3), P(6, 3)]),
    ("SmoothL1Loss", dict(delta=0.5), [F(5, 4), F(5, 4)]),
    ("KLDivLoss", dict(reduction="batchmean"),
     [np.log(_softmax(F(4, 5))), _softmax(F(4, 5))]),
    ("MarginRankingLoss", dict(margin=0.2), [F(6), F(6), SIGNS]),
    ("HingeEmbeddingLoss", {}, [F(6), SIGNS]),
    ("CosineEmbeddingLoss", {}, [F(6, 4), F(6, 4), SIGNS]),
    ("TripletMarginLoss", dict(margin=0.5), [F(5, 4), F(5, 4), F(5, 4)]),
    ("TripletMarginWithDistanceLoss", {}, [F(5, 4), F(5, 4), F(5, 4)]),
    ("MultiLabelSoftMarginLoss", {},
     [F(5, 4), (P(5, 4) > 0.5).astype(np.float32)]),
    ("SoftMarginLoss", {}, [F(5, 4), np.sign(F(5, 4))]),
    ("PoissonNLLLoss", dict(full=True), [F(5, 4), P(5, 4) * 4]),
    ("GaussianNLLLoss", {}, [F(5, 4), F(5, 4), P(5, 4)]),
    ("CTCLoss", dict(blank=0, reduction="sum"),
     [F(10, 2, 5), np.array([[1, 2], [3, 3]]), np.array([10, 9]),
      np.array([2, 2])]),
]


@pytest.mark.parametrize("name,kw,arrays", LAYERS,
                         ids=[n for n, _, _ in LAYERS])
def test_loss_layers_match_reference(name, kw, arrays):
    want = getattr(jnn, name)(**kw)(*map(paddle.to_tensor, arrays))
    got = getattr(pnn, name)(**kw)(*map(torch.tensor, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=TOL, atol=TOL)


def test_cross_entropy_layer_class_weight_and_bf16_logits():
    """A weight tensor given to the layer, and bfloat16 logits, whose loss
    is computed in float32 in both."""
    logits, w = F(6, 5), P(5)
    want = jnn.CrossEntropyLoss(weight=paddle.to_tensor(w))(
        paddle.to_tensor(logits).astype("bfloat16"),
        paddle.to_tensor(LABELS))
    got = pnn.CrossEntropyLoss(weight=torch.tensor(w))(
        torch.tensor(logits).bfloat16(), torch.tensor(LABELS))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want._data.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)
