"""Metrics. reference: paddle_tpu/metric/__init__.py (:14-157;
python/paddle/metric/metrics.py).

Every metric computes on the host in numpy, as the reference's does: a
tensor is copied to the CPU first, float16/bfloat16 as float32.
`Accuracy.compute` ranks the predictions with np.argsort(-p).
`accuracy` is tensor.math's, re-exported as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensor.math import accuracy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        p, l = _np(pred), _np(label)
        maxk = max(self.topk)
        idx = np.argsort(-p, axis=-1)[..., :maxk]
        if l.ndim == p.ndim:
            l = l.squeeze(-1)
        correct = idx == l[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for k in self.topk:
            num = c[..., :k].sum()
            tot = c.shape[0] if c.ndim <= 2 else np.prod(c.shape[:-1])
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += tot
            accs.append(num / max(tot, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _np(preds), _np(labels)
        pred_pos = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fp += int(((pred_pos == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _np(preds), _np(labels)
        pred_pos = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fn += int(((pred_pos == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p, l = _np(preds), _np(labels)
        if p.ndim == 2:
            p = p[:, 1]
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        l = l.reshape(-1)
        for b, lab in zip(bins.reshape(-1), l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate over thresholds from high to low
        pos = self._stat_pos[::-1].cumsum()
        neg = self._stat_neg[::-1].cumsum()
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name
