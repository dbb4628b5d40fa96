"""The less common functionals. reference:
paddle_tpu/nn/functional/extras.py (all of it).

`flash_attn_qkvpacked` hands its packed slices qkv[:, :, i] (strided
views) to `flash_attention`, whose wrapper copies them into the
contiguous (b * h, s, d) layout the kernels take (ops/flash_attention.py
`_to_bhsd`); so on the card it reaches K1 and, in the backward, K3/K4
where the router picks them. `flashmask_attention` and `sparse_attention`
expand their encodings into a dense mask and take the dense path, as the
reference does. `grid_sample`'s reflection padding reflects as the
reference's formula does (|mod(v - lo, 2 r) - r| + lo).

In max_unpool, each value of x goes to the flat spatial index `indices` gives it (as
max_pool*(return_mask=True) returns them) in an output of zeros whose
spatial size is `output_size`'s last dims, or (in - 1) * stride + kernel
per dim: the reference leaves `padding` and `data_format` out of both, and
so does the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...framework.random import get_generator
from ...ops.flash_attention import NEG_INF
from ...tensor.linalg import _linspace
from .conv import _tuple

__all__ = [
    "pairwise_distance", "grid_sample", "affine_grid", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "temporal_shift",
    "feature_alpha_dropout", "multi_margin_loss", "hsigmoid_loss",
    "fractional_max_pool2d", "fractional_max_pool3d", "gather_tree",
    "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    "flashmask_attention", "margin_cross_entropy", "class_center_sample",
    "sparse_attention", "rnnt_loss", "adaptive_log_softmax_with_loss",
]


def _max_unpool(x, indices, n, kernel_size, stride, output_size):
    ks = _tuple(kernel_size, n)
    sd = _tuple(stride if stride is not None else kernel_size, n)
    if output_size is not None:
        out_sp = tuple(int(s) for s in output_size[-n:])
    else:
        out_sp = tuple((si - 1) * st + k
                       for si, st, k in zip(x.shape[2:], sd, ks))
    b, c = x.shape[:2]
    out = x.new_zeros((b, c, math.prod(out_sp)))
    out = out.scatter(2, indices.reshape(b, c, -1).long(),
                      x.reshape(b, c, -1))
    return out.reshape((b, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, output_size)


def gather_tree(ids, parents):
    """Full beams from a beam search's step ids and parent beams, both
    (max_time, batch, beam): walking back from the last step, each beam
    takes its id at every step and moves to its parent there."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(ids[t].gather(1, beam))
        beam = parents[t].gather(1, beam).long()
    return torch.stack(out[::-1])


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """(sum(|x - y| + epsilon)^p)^(1/p) along the last axis; max or min of
    |x - y| at p = +-inf."""
    d = x - y
    if p == float("inf"):
        return d.abs().amax(-1, keepdim=keepdim)
    if p == float("-inf"):
        return d.abs().amin(-1, keepdim=keepdim)
    return ((d.abs() + epsilon) ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The (n, h, w, 2) sampling grid of the 2-D affine maps theta (n, 2,
    3) over out_shape (n, c, h, w), in [-1, 1] coordinates."""
    n, _, h, w = [int(s) for s in out_shape]

    def base(size):
        if align_corners:
            return _linspace(torch.tensor(-1.0), torch.tensor(1.0), size,
                             torch.float32, theta.device)
        return (torch.arange(size, device=theta.device) * 2 + 1) / size - 1.0

    gy, gx = torch.meshgrid(base(h), base(w), indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("hwk,njk->nhwj", coords, theta.float()).to(
        theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x (n, c, h, w) sampled at grid (n, hg, wg, 2) in [-1, 1] coordinates,
    bilinearly or at the nearest pixel; outside the image zeros, the
    border's values, or a reflection."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(v, size):
        if align_corners:
            return (v + 1.0) * (size - 1) / 2.0
        return ((v + 1.0) * size - 1.0) / 2.0

    def reflect(v, lo, hi):
        rng = hi - lo
        if rng <= 0:
            return torch.zeros_like(v)
        return torch.remainder(v - lo, 2 * rng).sub(rng).abs() + lo

    fx, fy = unnorm(gx, w), unnorm(gy, h)
    if padding_mode == "border":
        fx, fy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        if align_corners:
            fx, fy = reflect(fx, 0.0, w - 1.0), reflect(fy, 0.0, h - 1.0)
        else:
            fx = reflect(fx, -0.5, w - 0.5).clamp(0, w - 1)
            fy = reflect(fy, -0.5, h - 0.5).clamp(0, h - 1)
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def gather(ix, iy):
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        vals = x[bidx, :, iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
        vals = vals.permute(0, 3, 1, 2)
        if padding_mode == "zeros":
            vals = vals * valid[:, None].to(x.dtype)
        return vals

    if mode == "nearest":
        return gather(torch.round(fx), torch.round(fy))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    wa = ((x1 - fx) * (y1 - fy))[:, None]
    wb = ((fx - x0) * (y1 - fy))[:, None]
    wc = ((x1 - fx) * (fy - y0))[:, None]
    wd = ((fx - x0) * (fy - y0))[:, None]
    out = (gather(x0, y0) * wa + gather(x1, y0) * wb
           + gather(x0, y1) * wc + gather(x1, y1) * wd)
    return out.to(x.dtype)


def _random_u(x, random_u):
    if random_u is not None:
        return float(random_u)
    return float(torch.rand((), device=x.device,
                            generator=get_generator(x.device)))


def _regions(in_size, out_size, u):
    """Pooling regions [start, end) of fractional max pooling (Graham
    2014), in float32 as the reference computes them."""
    alpha = np.float32(in_size / out_size)
    idx = np.floor(alpha * (np.arange(out_size, dtype=np.float32)
                            + np.float32(u))).astype(np.int64)
    idx = np.clip(idx, 0, in_size - 1)
    starts = np.concatenate([[0], idx[1:]])
    ends = np.concatenate([idx[1:], [in_size]])
    return starts.tolist(), ends.tolist()


def _fractional_2d(x, oh, ow, u):
    hs, he = _regions(x.shape[-2], oh, u)
    ws, we = _regions(x.shape[-1], ow, u)
    rows = [torch.stack([x[..., hs[i]:he[i], ws[j]:we[j]].amax((-2, -1))
                         for j in range(ow)], -1) for i in range(oh)]
    return torch.stack(rows, -2)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Max over pseudo-random regions whose sizes average in / out; the
    regions follow from `random_u` (a draw from the port's generator
    without one). With return_mask, (out, None) as the reference."""
    oh, ow = (output_size if isinstance(output_size, (tuple, list))
              else (output_size, output_size))
    out = _fractional_2d(x, oh, ow, _random_u(x, random_u))
    return (out, None) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """The depth regions (float64, as the reference's numpy), each slab's
    max then pooled as fractional_max_pool2d with the same u."""
    od, oh, ow = (output_size if isinstance(output_size, (tuple, list))
                  else (output_size,) * 3)
    u = _random_u(x, random_u)
    d = x.shape[2]
    starts = np.clip(np.floor(d / od * (np.arange(od) + u)).astype(np.int64),
                     0, d - 1)
    starts[0] = 0
    ends = np.append(starts[1:], d)
    out = torch.stack([_fractional_2d(x[:, :, s:e].amax(2), oh, ow, u)
                       for s, e in zip(starts.tolist(), ends.tolist())], 2)
    return (out, None) if return_mask else out


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: a fold of the channels moves one segment back in time, the
    next fold one forward, the rest stays."""
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(
        nt, c, h, w)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channels (one draw per sample and channel)."""
    if not training or p == 0.0:
        return x
    alpha = -1.7580993408473766
    keep = torch.empty((x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2),
                       device=x.device).bernoulli_(
        1.0 - p, generator=get_generator(x.device)) > 0
    q = 1.0 - p
    scale_a = (q + alpha ** 2 * q * (1 - q)) ** -0.5
    scale_b = -scale_a * alpha * (1 - q)
    kept = torch.where(keep, x, torch.full((), alpha, dtype=x.dtype,
                                           device=x.device))
    return (kept * scale_a + scale_b).to(x.dtype)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """sum over the wrong classes j of max(margin - x[y] + x[j], 0)^p
    (times weight[y]), over the class count."""
    c = input.shape[1]
    correct = input.gather(1, label[:, None].long())
    m = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        m = m * weight[label][:, None]
    mask = torch.arange(c, device=input.device)[None, :] != label[:, None]
    return _reduce((m * mask).sum(1) / c, reduction)


def _hsigmoid_tree(num_classes):
    """Paths of the complete binary tree (leaf cls + num_classes up to the
    root): node ids, codes and validity per level, as the reference's."""
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    codes = np.zeros((num_classes, depth), np.float32)
    nodes = np.zeros((num_classes, depth), np.int64)
    valid = np.zeros((num_classes, depth), np.float32)
    for cls in range(num_classes):
        node, lvl = cls + num_classes, depth - 1
        while node > 1 and lvl >= 0:
            codes[cls, lvl] = node % 2
            node //= 2
            nodes[cls, lvl] = node - 1
            valid[cls, lvl] = 1.0
            lvl -= 1
    return nodes, codes, valid


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: the
    mean over samples of the sigmoid cross-entropies along each label's
    path. Custom trees raise, as in the reference."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss: custom trees (path_table/path_code) are not "
            "supported; use the default complete binary tree")
    nodes, codes, valid = (torch.as_tensor(t, device=input.device)
                           for t in _hsigmoid_tree(num_classes))
    lab = label.reshape(-1).long()
    path_nodes, path_codes = nodes[lab], codes[lab]
    logits = torch.einsum("nd,nkd->nk", input, weight[path_nodes])
    if bias is not None:
        logits = logits + bias[path_nodes]
    lvl = (torch.clamp(logits, min=0) - logits * path_codes
           + torch.log1p(torch.exp(-logits.abs())))
    return (lvl * valid[lab]).sum(1).mean()


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, *, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """qkv (batch, seq, 3, heads, head_dim) into flash_attention; returns
    (out, None)."""
    from .attention import flash_attention
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, **kw):
    """qkv (total_tokens, 3, heads, head_dim) into flash_attn_unpadded."""
    from .attention import flash_attn_unpadded
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale, dropout=dropout,
                               causal=causal, return_softmax=return_softmax)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Attention under a FlashMask column encoding: with (b, h|1, sk, 1)
    indices, query rows at or past start[col] do not see key col; with
    (b, h|1, sk, 2), rows in [start, end). The mask is dense and additive,
    so this is the dense path. Returns (out, None)."""
    from .attention import scaled_dot_product_attention
    if startend_row_indices is None:
        return scaled_dot_product_attention(
            query, key, value, dropout_p=dropout, is_causal=causal,
            training=training), None
    sq, sk = int(query.shape[1]), int(key.shape[1])
    se = startend_row_indices
    rows = torch.arange(sq, device=query.device)[:, None]
    cols = torch.arange(sk, device=query.device)[None, :]
    blocked = rows[None, None] >= se[..., 0][:, :, None, :]
    if se.shape[-1] == 2:
        blocked = blocked & (rows[None, None] < se[..., 1][:, :, None, :])
    if causal:
        blocked = blocked | (rows < cols)[None, None]
    mask = torch.where(blocked, NEG_INF, 0.0).to(torch.float32)
    return scaled_dot_product_attention(query, key, value, attn_mask=mask,
                                        dropout_p=dropout, is_causal=False,
                                        training=training), None


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family softmax: the target logit cos(t) becomes cos(margin1
    t + margin2) - margin3, every logit times `scale`, then cross-entropy
    (and the softmax with return_softmax)."""
    lab = label.reshape(-1).long()
    target = logits.gather(1, lab[:, None])[:, 0]
    target = target.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    m_target = torch.cos(margin1 * torch.arccos(target) + margin2) - margin3
    onehot = torch.nn.functional.one_hot(lab, logits.shape[1]).to(
        logits.dtype)
    adjusted = (logits + onehot * (m_target - target)[:, None]) * scale
    lp = torch.log_softmax(adjusted, -1)
    loss = _reduce(-lp.gather(1, lab[:, None])[:, 0], reduction)
    return (loss, torch.exp(lp)) if return_softmax else loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """(label remapped to the sampled classes, the sampled classes): every
    positive class, then negatives drawn without replacement from numpy's
    default_rng seeded by |sum(label)|, sorted, as the reference draws
    them."""
    lab = label.detach().cpu().numpy()
    pos = np.unique(lab)
    n_extra = max(int(num_samples) - pos.size, 0)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    rng = np.random.default_rng(int(abs(int(lab.sum())) % (2**31)))
    neg = rng.choice(rest, size=min(n_extra, rest.size), replace=False) \
        if rest.size else np.empty((0,), lab.dtype)
    sampled = np.concatenate([pos, np.sort(neg)]).astype(lab.dtype)
    remap = {c: i for i, c in enumerate(sampled.tolist())}
    remapped = np.asarray([remap[c] for c in lab.tolist()], lab.dtype)
    return (torch.as_tensor(remapped, device=label.device),
            torch.as_tensor(sampled, device=label.device))


def sparse_attention(x, offset, columns, query, key, value, sparse_mask=None,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention (b, h, s, d) in which row i sees only the keys
    columns[offset[i]:offset[i + 1]] (CSR, shared or per (b, h)); dense
    scores under the mask."""
    b, h, sq, d = query.shape
    sk = key.shape[2]

    def one_mask(off, cols):
        row = torch.searchsorted(off, torch.arange(cols.shape[-1],
                                                   device=off.device),
                                 right=True) - 1
        m = torch.zeros(sq, sk, dtype=torch.bool, device=off.device)
        m[row, cols.long()] = True
        return m

    if offset.dim() == 1:
        mask = one_mask(offset, columns)[None, None]
    else:
        off = offset.reshape(b, -1, offset.shape[-1])
        cols = columns.reshape(b, -1, columns.shape[-1])
        mask = torch.stack([torch.stack([one_mask(off[i, j], cols[i, j])
                                         for j in range(off.shape[1])])
                            for i in range(b)])
        mask = mask.expand(b, h, sq, sk)
    logits = torch.einsum("bhqd,bhkd->bhqk", query.float(), key.float())
    logits = logits / torch.sqrt(torch.tensor(float(d)))
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, -1).masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(value.dtype), value)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss, -log P(label | input) over every monotonic
    alignment of the (T, U + 1) lattice; logits (B, T, U + 1, V).
    `fastemit_lambda` is accepted and not applied, as the reference."""
    bsz, t_max, u_max, v = input.shape
    lp = torch.log_softmax(input.float(), -1)
    blank_lp = lp[..., blank]
    lab = label.long().clamp(max=v - 1)
    emit = lp[:, :, :-1, :].gather(-1, lab[:, None, :, None].expand(
        bsz, t_max, u_max - 1, 1))[..., 0]
    emit = torch.nn.functional.pad(emit, (0, 1), value=NEG_INF)
    neg = torch.full((bsz,), NEG_INF, device=input.device)

    def emit_scan(row, emit_row):
        out, prev = [], neg
        for u in range(u_max):
            cur = row[:, 0] if u == 0 else torch.logaddexp(
                row[:, u], prev + emit_row[:, u - 1])
            out.append(cur)
            prev = cur
        return torch.stack(out, 1)

    alpha = torch.full((bsz, u_max), NEG_INF, device=input.device)
    alpha[:, 0] = 0.0
    alpha = emit_scan(alpha, emit[:, 0])
    ilen = input_lengths.long()
    for t in range(1, t_max):
        new = emit_scan(alpha + blank_lp[:, t - 1], emit[:, t])
        alpha = torch.where((t < ilen)[:, None], new, alpha)
    llen = label_lengths.long()
    ar = torch.arange(bsz, device=input.device)
    last_t = (ilen - 1).clamp(0, t_max - 1)
    ll = alpha[ar, llen] + blank_lp[ar, last_t, llen]
    return _reduce(-ll, reduction)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al.): (each sample's log-probability of
    its label, their negative mean). The head scores the first cutoffs[0]
    classes and one entry per tail cluster; a tail label adds its
    cluster's entry to its log-probability within the cluster, from
    input @ proj @ cls of that cluster's (proj, cls) weights."""
    n_clusters = len(cutoffs)
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    head_lp = torch.log_softmax(head, -1)
    c0 = head.shape[-1] - n_clusters
    lab = label.long()
    out = torch.where(lab < c0, head_lp.gather(
        1, lab.clamp(0, c0 - 1)[:, None])[:, 0], torch.zeros_like(head[:, 0]))
    lo = c0
    for i, (proj, cls_w) in enumerate(tail_weights):
        size = cls_w.shape[-1]
        inside = (lab >= lo) & (lab < lo + size)
        tail_lp = torch.log_softmax((input @ proj) @ cls_w, -1)
        rel = (lab - lo).clamp(0, size - 1)
        lp_i = head_lp[:, c0 + i] + tail_lp.gather(1, rel[:, None])[:, 0]
        out = torch.where(inside, lp_i, out)
        lo += size
    return out, -out.mean()
