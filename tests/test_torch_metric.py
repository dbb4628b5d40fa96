"""The port's metrics against the JAX package's: the same numpy inputs
give equal values (exactly: both compute on the host in numpy), over
several updates, with top-k accuracy, labels with and without a trailing
axis, bfloat16 logits (ranked as float32), and after a reset."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as pm


def _batches(seed, n=3, b=16, c=10, label_col=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        logits = rng.randn(b, c).astype(np.float32)
        labels = rng.randint(0, c, (b, 1) if label_col else (b,))
        out.append((logits, labels))
    return out


@pytest.mark.parametrize("topk,label_col", [((1,), False), ((1, 5), True),
                                            (3, False)])
def test_accuracy_matches_reference(topk, label_col):
    ref, port = jm.Accuracy(topk=topk), pm.Accuracy(topk=topk)
    assert port.name() == ref.name()
    for logits, labels in _batches(1, label_col=label_col):
        want = ref.update(ref.compute(paddle.to_tensor(logits),
                                      paddle.to_tensor(labels)))
        got = port.update(port.compute(torch.tensor(logits),
                                       torch.tensor(labels)))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert port.accumulate() == ref.accumulate()
    port.reset()
    assert port.accumulate() == (0.0 if len(port.topk) == 1
                                 else [0.0] * len(port.topk))


def test_accuracy_ranks_bf16_logits_as_float32():
    (logits, labels), = _batches(2, n=1)
    bf = torch.tensor(logits).bfloat16()
    ref, port = jm.Accuracy(topk=(1, 2)), pm.Accuracy(topk=(1, 2))
    want = ref.compute(paddle.to_tensor(bf.float().numpy()),
                       paddle.to_tensor(labels))
    got = port.compute(bf, torch.tensor(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
@pytest.mark.parametrize("two_columns", [False, True])
def test_binary_metrics_match_reference(name, two_columns):
    rng = np.random.RandomState(3)
    ref, port = getattr(jm, name)(), getattr(pm, name)()
    for _ in range(3):
        p = rng.rand(32).astype(np.float32)
        if two_columns and name == "Auc":
            p = np.stack([1 - p, p], 1)
        labels = rng.randint(0, 2, (32, 1))
        ref.update(paddle.to_tensor(p), paddle.to_tensor(labels))
        port.update(torch.tensor(p), torch.tensor(labels))
    assert port.accumulate() == ref.accumulate()
    assert port.name() == ref.name()
    port.reset()
    assert port.accumulate() == 0.0
