"""Loss functionals. reference: paddle_tpu/nn/functional/loss.py (:30
`cross_entropy`).

Only the hard-label path is ported: integer class labels, `ignore_index`,
and the mean/sum/none reductions, in float32 through `log_softmax`. Soft
labels, label smoothing and class weights are not ported and raise.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """Cross-entropy of logits `input` against integer class indices
    `label` (the shape of `input` without `axis`, or with `axis` of size 1).
    Positions whose label is `ignore_index` contribute 0 and are not
    counted by the mean."""
    if weight is not None or soft_label or label_smoothing:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels and label smoothing "
            "are not ported; only hard labels are")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction={reduction!r}; pick mean, sum or none")
    if label.is_floating_point():
        raise NotImplementedError("cross_entropy: float (soft) labels are "
                                  "not ported; pass integer class indices")
    axis = axis % input.dim()
    lp = torch.log_softmax(input.float(), dim=axis)
    idx = label.squeeze(axis) if label.dim() == input.dim() else label
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    if reduction == "sum":
        return loss.sum()
    return loss
