"""Loss functionals. reference: paddle_tpu/nn/functional/loss.py (:22-369;
python/paddle/nn/functional/loss.py): the 24 functions from
`cross_entropy` to `ctc_loss`, with the reference's reductions and
formulas. `cross_entropy` and `ctc_loss` work in float32 whatever the
input's dtype, as there. The losses the reference runs under an AMP black
list name (cross_entropy, bce, bce_with_logits, mse_loss, l1_loss,
nll_loss, smooth_l1_loss, kl_div, ctc_loss) pass their inputs through
amp._cast under that name first.
"""

from __future__ import annotations

import math

import torch

from ...amp import _cast

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss", "ctc_loss",
    "log_loss", "square_error_cost", "sigmoid_focal_loss", "dice_loss",
    "npair_loss",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _log1pexp_neg_abs(z):
    """log(1 + exp(-|z|)), jnp.logaddexp(0, -|z|)."""
    return torch.logaddexp(torch.zeros_like(z), -z.abs())


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross-entropy of `input` along `axis` in float32: log_softmax of
    logits, or with use_softmax=False the log of probabilities (floored at
    1e-30). Soft labels (soft_label, or a float label with the classes
    along `axis`) give -sum(target * log p), the target smoothed to
    (1 - ls) * target + ls / classes. Hard labels (integer class indices,
    the shape of `input` without `axis` or with it of size 1) give
    (1 - ls) * -log p[label] + ls * -mean(log p), times weight[label];
    positions whose label is `ignore_index` give 0. The mean divides by
    the number of such valid positions, or with `weight` by the sum of
    their weights."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction={reduction!r}; pick mean, sum or none")
    input, label, weight = _cast("cross_entropy", input, label, weight)
    axis = axis % input.dim()
    x = input.float()
    lp = (torch.log_softmax(x, dim=axis) if use_softmax
          else torch.log(x.clamp(min=1e-30)))
    n_classes = input.shape[axis]
    ls = label_smoothing
    if soft_label or (label.dim() == input.dim()
                      and label.shape[axis] == n_classes
                      and label.is_floating_point()):
        tgt = label.float()
        if ls > 0:
            tgt = (1 - ls) * tgt + ls / n_classes
        loss = -(tgt * lp).sum(axis)
        if reduction == "mean":
            return loss.sum() / max(loss.numel(), 1)
        return _reduce(loss, reduction)
    idx = label.squeeze(axis) if label.dim() == input.dim() else label
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = -picked
    if ls > 0:
        loss = (1 - ls) * loss + ls * -lp.mean(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe],
                                torch.zeros_like(loss)).sum().clamp(min=1e-9)
        else:
            denom = valid.sum().float().clamp(min=1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """cross_entropy without reduction, keeping `axis` as size 1; with
    return_softmax also the softmax of `logits`."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p, lab, w = _cast("bce", input, label, weight)
    eps = 1e-12
    v = -(lab * torch.log(p.clamp(min=eps))
          + (1 - lab) * torch.log((1 - p).clamp(min=eps)))
    return _reduce(v if w is None else v * w, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, lab, pw, w = _cast("bce_with_logits", logit, label, pos_weight,
                          weight)
    if pw is not None:
        log_w = (pw - 1) * lab + 1
        v = (1 - lab) * z + log_w * (_log1pexp_neg_abs(z)
                                     + torch.clamp(-z, min=0))
    else:
        v = torch.clamp(z, min=0) - z * lab + _log1pexp_neg_abs(z)
    return _reduce(v if w is None else v * w, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    a, b = _cast("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def l1_loss(input, label, reduction="mean", name=None):
    a, b = _cast("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    """-input[n, label[n], ...] (log-probabilities, classes on axis 1),
    times weight[label]; ignore_index positions give 0, and the mean
    divides by the valid positions' summed weights."""
    lp, lab, w = _cast("nll_loss", input, label, weight)
    lp_m = lp.movedim(1, -1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    v = -lp_m.gather(-1, safe[..., None])[..., 0]
    if w is not None:
        v = v * w[safe]
    v = torch.where(valid, v, torch.zeros_like(v))
    if reduction == "mean":
        per = w[safe] if w is not None else torch.ones_like(v)
        denom = torch.where(valid, per, torch.zeros_like(per)).sum()
        return v.sum() / denom.clamp(min=1e-9)
    return _reduce(v, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Paddle's Huber form: 0.5 d^2 where d = |a - b| < delta, else
    delta (d - 0.5 delta)."""
    a, b = _cast("smooth_l1_loss", input, label)
    d = (a - b).abs()
    v = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(v, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    lp, t = _cast("kl_div", input, label)
    if log_target:
        v = torch.exp(t) * (t - lp)
    else:
        v = t * (torch.log(t.clamp(min=1e-12)) - lp)
    if reduction == "batchmean":
        return v.sum() / lp.shape[0]
    return _reduce(v, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp(min=1e-12)
    v = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0))
    return _reduce(v, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    v = -(label * torch.nn.functional.logsigmoid(input)
          + (1 - label) * torch.nn.functional.logsigmoid(-input))
    if weight is not None:
        v = v * weight
    return _reduce(v.mean(-1), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    if log_input:
        v = torch.exp(input) - label * input
    else:
        v = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label) - label
                    + 0.5 * torch.log(2 * math.pi * label))
        v = v + torch.where(label > 1, stirling, torch.zeros_like(stirling))
    return _reduce(v, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = variance.clamp(min=epsilon)
    v = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        v = v + 0.5 * torch.log(torch.tensor(2 * math.pi, dtype=input.dtype))
    return _reduce(v, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, lab = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * lab + _log1pexp_neg_abs(z)
    p_t = p * lab + (1 - p) * (1 - lab)
    a_t = alpha * lab + (1 - alpha) * (1 - lab)
    v = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        v = v / normalizer
    return _reduce(v, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - (2 |p ∩ onehot| + eps) / (|p| + |onehot| + eps) per sample,
    averaged; `label` holds class indices with a trailing axis of 1."""
    lab = label[..., 0] if label.shape[-1] == 1 else label
    oh = torch.nn.functional.one_hot(lab.long(), input.shape[-1]).to(
        input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = (input * oh).sum(axes)
    union = input.sum(axes) + oh.sum(axes)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lab = (labels[:, None] == labels[None, :]).to(sim.dtype)
    lab = lab / lab.sum(-1, keepdim=True)
    ce = -(lab * torch.log_softmax(sim, -1)).sum(-1)
    reg = l2_reg * ((anchor * anchor).sum(-1).mean()
                    + (positive * positive).sum(-1).mean()) * 0.25
    return ce.mean() + reg * 2


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward (alpha) recursion over the labels extended with
    blanks, in float32. `log_probs` (T, N, C) are normalized by a
    log_softmax first, as in the reference; the mean divides each
    sequence's loss by its label length."""
    lp, labels, input_lengths, label_lengths = _cast(
        "ctc_loss", log_probs, labels, input_lengths, label_lengths)
    lp = torch.log_softmax(lp.float(), -1)
    t_len, n, _ = lp.shape
    s = labels.shape[1]
    ar = torch.arange(n, device=lp.device)
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = labels.long()
    neg_inf = -1e30
    alpha = torch.full((n, 2 * s + 1), neg_inf, device=lp.device)
    alpha[:, 0] = lp[0, :, blank]
    alpha[:, 1] = lp[0][ar, ext[:, 1]]
    skip = torch.cat([torch.zeros((n, 2), dtype=torch.bool,
                                  device=lp.device),
                      (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                     1)
    pad1 = torch.full((n, 1), neg_inf, device=lp.device)
    pad2 = torch.full((n, 2), neg_inf, device=lp.device)
    alphas = [alpha]
    for t in range(1, t_len):
        a1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a2 = torch.where(skip, torch.cat([pad2, alpha[:, :-2]], 1),
                         torch.full_like(alpha, neg_inf))
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        alpha = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                              + torch.exp(a2 - m)) + lp[t][ar[:, None], ext]
        alphas.append(alpha)
    last = torch.stack(alphas)[input_lengths.long() - 1, ar]
    end = 2 * label_lengths.long()
    v1 = last[ar, end]
    v2 = last[ar, (end - 1).clamp(min=0)]
    m = torch.maximum(v1, v2)
    loss = -(m + torch.log(torch.exp(v1 - m) + torch.exp(v2 - m)))
    if reduction == "mean":
        return (loss / label_lengths.float().clamp(min=1.0)).mean()
    return _reduce(loss, reduction)
