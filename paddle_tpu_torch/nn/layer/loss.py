"""Loss layers. reference: paddle_tpu/nn/layer/loss.py (:15-69):
CrossEntropyLoss, the layers its `_mk` builds (each passes its
constructor's arguments after the inputs to the functional of the same
loss, `name` dropped) and CTCLoss."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "TripletMarginWithDistanceLoss",
           "MultiLabelSoftMarginLoss", "SoftMarginLoss", "PoissonNLLLoss",
           "GaussianNLLLoss", "CTCLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.kwargs = dict(ignore_index=ignore_index, reduction=reduction,
                           soft_label=soft_label, axis=axis,
                           use_softmax=use_softmax,
                           label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               **self.kwargs)


def _mk(name, fname):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, *inputs):
        return getattr(F, fname)(*inputs, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__,
                                  "forward": forward,
                                  "__module__": __name__})


MSELoss = _mk("MSELoss", "mse_loss")
L1Loss = _mk("L1Loss", "l1_loss")
NLLLoss = _mk("NLLLoss", "nll_loss")
BCELoss = _mk("BCELoss", "binary_cross_entropy")
BCEWithLogitsLoss = _mk("BCEWithLogitsLoss",
                        "binary_cross_entropy_with_logits")
SmoothL1Loss = _mk("SmoothL1Loss", "smooth_l1_loss")
KLDivLoss = _mk("KLDivLoss", "kl_div")
MarginRankingLoss = _mk("MarginRankingLoss", "margin_ranking_loss")
HingeEmbeddingLoss = _mk("HingeEmbeddingLoss", "hinge_embedding_loss")
CosineEmbeddingLoss = _mk("CosineEmbeddingLoss", "cosine_embedding_loss")
TripletMarginLoss = _mk("TripletMarginLoss", "triplet_margin_loss")
TripletMarginWithDistanceLoss = _mk("TripletMarginWithDistanceLoss",
                                    "triplet_margin_with_distance_loss")
MultiLabelSoftMarginLoss = _mk("MultiLabelSoftMarginLoss",
                               "multi_label_soft_margin_loss")
SoftMarginLoss = _mk("SoftMarginLoss", "soft_margin_loss")
PoissonNLLLoss = _mk("PoissonNLLLoss", "poisson_nll_loss")
GaussianNLLLoss = _mk("GaussianNLLLoss", "gaussian_nll_loss")


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)
