"""Detection and vision ops. reference: paddle_tpu/vision/ops.py (the RoI
ops :43-199, the NMS family :202-297, `deform_conv2d` / `DeformConv2D`
:300-384, `yolo_box` :391, `yolo_loss` :439, `prior_box` :502,
`box_coder` :544, `distribute_fpn_proposals` :584, `generate_proposals`
:611, `read_file` / `decode_jpeg` :670-687).

- The RoI ops and `deform_conv2d` are batched torch gathers on the input's
  device: every RoI (or kernel point) samples the feature map at once
  through flat indices. The bilinear sample is the reference's: corners
  clamped into the image and weights clamped to [0, 1], so a point
  outside the image takes the nearest border value, not zero (torchvision's
  roi_align zeroes such points and is not used).
- `nms`, `matrix_nms`, `distribute_fpn_proposals` and `generate_proposals`
  run on the host with numpy, as the reference does (data-dependent output
  sizes); numpy's own `argsort` keeps the reference's order among equal
  scores. Their results are returned on the input's device.
- `read_file` returns the file's bytes as a host uint8 tensor;
  `decode_jpeg` decodes on the host with PIL and returns (C, H, W) uint8
  on its input's device.
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..framework.device import resolve_device
from ..framework.random import get_generator
from ..nn.layer.layers import Layer

__all__ = [
    "yolo_loss", "yolo_box", "prior_box", "box_coder", "deform_conv2d",
    "DeformConv2D", "distribute_fpn_proposals", "generate_proposals",
    "read_file", "decode_jpeg", "roi_pool", "RoIPool", "psroi_pool",
    "PSRoIPool", "roi_align", "RoIAlign", "nms", "matrix_nms",
]


def _np(x):
    """A host numpy copy of a tensor (bf16 as float32) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


# -- RoI ops ------------------------------------------------------------------

def _roi_images(boxes_num, n_rois, device):
    """The image index of each RoI from the per-image counts."""
    ends = torch.as_tensor(boxes_num, device=device).long().cumsum(0)
    rows = torch.arange(n_rois, device=device)
    return torch.searchsorted(ends, rows, right=True).clamp(
        max=len(ends) - 1)


def _gather(feat, img, y, x):
    """feat (N, C, H, W) at integer rows y and columns x (R, ...) of the
    images img (R,): (R, C, ...)."""
    n, c, h, w = feat.shape
    flat = feat.transpose(0, 1).reshape(c, n * h * w)
    idx = img.view((-1,) + (1,) * (y.dim() - 1)) * (h * w) + y * w + x
    return flat[:, idx].transpose(0, 1)


def _bilinear_at(feat, img, y, x):
    """The reference's `_bilinear_at` for every RoI at once: feat (N, C, H,
    W), img (R,), float coordinates y, x (R, ...) -> (R, C, ...)."""
    h, w = feat.shape[2:]
    y0 = y.floor().clamp(0, h - 1)
    x0 = x.floor().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy1 = (y - y0).clamp(0.0, 1.0).unsqueeze(1)
    wx1 = (x - x0).clamp(0.0, 1.0).unsqueeze(1)
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, y1, x0, x1 = (v.long() for v in (y0, y1, x0, x1))
    return (_gather(feat, img, y0, x0) * (wy0 * wx0)
            + _gather(feat, img, y0, x1) * (wy0 * wx1)
            + _gather(feat, img, y1, x0) * (wy1 * wx0)
            + _gather(feat, img, y1, x1) * (wy1 * wx1))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """x (N, C, H, W); boxes (R, 4) as [x1, y1, x2, y2]; boxes_num (N,)
    RoIs per image -> (R, C, oh, ow): each bin the mean of sr x sr bilinear
    samples (sr = sampling_ratio, or 2 when it is not positive)."""
    oh, ow = _pair(output_size)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    r = boxes.shape[0]
    img = _roi_images(boxes_num, r, x.device)
    off = 0.5 if aligned else 0.0
    b = boxes * spatial_scale - off
    x1, y1, x2, y2 = b.unbind(1)
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    gy = (torch.arange(oh * sr, device=x.device) + 0.5) / sr
    gx = (torch.arange(ow * sr, device=x.device) + 0.5) / sr
    ys = y1[:, None] + gy * (rh / oh)[:, None]
    xs = x1[:, None] + gx * (rw / ow)[:, None]
    vals = _bilinear_at(x, img, ys[:, :, None].expand(-1, -1, ow * sr),
                        xs[:, None, :].expand(-1, oh * sr, -1))
    return vals.reshape(r, -1, oh, sr, ow, sr).mean(dim=(3, 5))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max pooling of each bin over the integer pixels it covers, read by
    the reference's nearest-pixel sampling, dense enough (ceil(H / oh) + 1
    samples a bin a dim) to visit every pixel of the largest bin."""
    oh, ow = _pair(output_size)
    r = boxes.shape[0]
    h, w = x.shape[2:]
    img = _roi_images(boxes_num, r, x.device)
    b = torch.round(boxes * spatial_scale)
    x1, y1 = b[:, 0], b[:, 1]
    x2 = torch.maximum(b[:, 2], x1 + 1)
    y2 = torch.maximum(b[:, 3], y1 + 1)
    sr_h = math.ceil(h / oh) + 1
    sr_w = math.ceil(w / ow) + 1
    gy = (torch.arange(oh * sr_h, device=x.device) + 0.5) / sr_h
    gx = (torch.arange(ow * sr_w, device=x.device) + 0.5) / sr_w
    ys = torch.round(y1[:, None] + gy * ((y2 - y1) / oh)[:, None] - 0.5)
    xs = torch.round(x1[:, None] + gx * ((x2 - x1) / ow)[:, None] - 0.5)
    ys = ys.clamp(0, h - 1).long()[:, :, None]
    xs = xs.clamp(0, w - 1).long()[:, None, :]
    vals = _gather(x, img, ys.expand(-1, -1, xs.shape[2]),
                   xs.expand(-1, ys.shape[1], -1))
    return vals.reshape(r, -1, oh, sr_h, ow, sr_w).amax(dim=(3, 5))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): the channels split into
    oh * ow groups, bin (i, j) read from group i * ow + j of roi_align's
    result (sampling ratio 2, not aligned)."""
    oh, ow = _pair(output_size)
    c = x.shape[1]
    if c % (oh * ow):
        raise ValueError("channels must divide output_size^2")
    cg = c // (oh * ow)
    pooled = roi_align(x, boxes, boxes_num, (oh, ow), spatial_scale, 2,
                       False)
    r = pooled.shape[0]
    grouped = pooled.reshape(r, oh * ow, cg, oh * ow)
    return torch.diagonal(grouped, dim1=1, dim2=3).reshape(r, cg, oh, ow)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# -- the NMS family (host) ----------------------------------------------------

def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    union = areas[:, None] + areas[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def _nms_keep(b, s, iou_threshold):
    order = np.argsort(-s) if s is not None else np.arange(len(b))
    iou = _iou_matrix(b)
    keep = []
    suppressed = np.zeros(len(b), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS on the host: the kept indices, highest score first (the
    input order without scores), int64 on the boxes' device. With
    `category_idxs` each category's boxes are shifted apart so that they
    never suppress another category's."""
    b = _np(boxes)
    s = _np(scores) if scores is not None else None
    if category_idxs is not None:
        cat = _np(category_idxs).astype(np.int64)
        b = b + (b.max() + 1.0) * cat[:, None]
    keep = _nms_keep(b, s, iou_threshold)
    if top_k is not None:
        keep = keep[:top_k]
    return torch.as_tensor(keep, device=_device(boxes))


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2) on the host: each score decayed by its overlap
    with higher-scored boxes of its class. Rows (class, score, x1, y1, x2,
    y2), float32 on the boxes' device; with `return_index` the boxes'
    indices and with `return_rois_num` the rows per image, int64."""
    bx = _np(bboxes)
    sc = _np(scores)
    n_img, n_cls = sc.shape[0], sc.shape[1]
    all_out, all_idx, rois_num = [], [], []
    for n in range(n_img):
        dets = []
        for c in range(n_cls):
            if c == background_label:
                continue
            idxs = np.nonzero(sc[n, c] > score_threshold)[0]
            if idxs.size == 0:
                continue
            s_c = sc[n, c, idxs]
            order = np.argsort(-s_c)[:nms_top_k]
            idxs = idxs[order]
            s_c = s_c[order]
            b_c = bx[n, idxs]
            iou = np.triu(_iou_matrix(b_c), 1)
            max_iou = iou.max(axis=0, initial=0.0)
            tri = np.triu(np.ones_like(iou, bool), 1)
            if use_gaussian:
                comp = np.exp(-(iou ** 2 - max_iou[:, None] ** 2)
                              / gaussian_sigma)
            else:
                comp = (1 - iou) / np.maximum(1 - max_iou[:, None], 1e-10)
            comp = np.where(tri, comp, 1.0)
            decay = np.minimum(comp.min(axis=0, initial=1.0), 1.0)
            s_dec = s_c * decay
            for j in range(len(idxs)):
                if s_dec[j] >= post_threshold:
                    dets.append((c, s_dec[j], *b_c[j], idxs[j]))
        dets.sort(key=lambda d: -d[1])
        dets = dets[:keep_top_k]
        rois_num.append(len(dets))
        for d in dets:
            all_out.append(d[:-1])
            all_idx.append(d[-1])
    device = _device(bboxes)
    out = torch.as_tensor(np.asarray(all_out, np.float32).reshape(
        -1, 2 + bx.shape[-1]), device=device)
    res = [out]
    if return_index:
        res.append(torch.as_tensor(np.asarray(all_idx, np.int64),
                                   device=device))
    if return_rois_num:
        res.append(torch.as_tensor(np.asarray(rois_num, np.int64),
                                   device=device))
    return tuple(res) if len(res) > 1 else out


# -- deformable convolution ---------------------------------------------------

def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1, or v2 with `mask`: each kernel point k
    samples the zero-padded input bilinearly at its place plus offset
    (channels 2k and 2k + 1 of `offset`: y, then x), scaled by mask
    channel k, and the samples are contracted with the weight in one
    product. groups and deformable_groups other than 1 raise, as in the
    reference. A padding (ph, pw) pads the rows by ph and the columns by
    pw on both sides (the reference pads each dim by (ph, pw) as (before,
    after), which agrees where ph == pw)."""
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d: groups/deformable_groups > 1 not supported")
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    oh = (h + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    ow = (w + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    padded = TF.pad(x, (pd[1], pd[1], pd[0], pd[0]))
    off = offset.reshape(n, kh * kw, 2, oh, ow)
    dev = x.device
    ki = torch.arange(kh, device=dev).repeat_interleave(kw) * dl[0]
    kj = torch.arange(kw, device=dev).repeat(kh) * dl[1]
    sy = ((torch.arange(oh, device=dev) * st[0])[None, None, :, None]
          + ki[None, :, None, None] + off[:, :, 0])
    sx = ((torch.arange(ow, device=dev) * st[1])[None, None, None, :]
          + kj[None, :, None, None] + off[:, :, 1])
    cols = _bilinear_at(padded, torch.arange(n, device=dev), sy, sx)
    if mask is not None:                    # (n, cin, k, oh, ow)
        cols = cols * mask.reshape(n, 1, kh * kw, oh, ow)
    dt = torch.promote_types(cols.dtype, weight.dtype)
    out = torch.matmul(weight.reshape(cout, -1).to(dt),
                       cols.reshape(n, cin * kh * kw, oh * ow).to(dt))
    out = out.reshape(n, cout, oh, ow)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(Layer):
    """The weight (out, in, kh, kw) from Uniform(+-sqrt(6 / fan_in)), fan_in
    = in * kh * kw, and a zero bias (none when bias_attr is False), built
    on `device`. groups and deformable_groups are accepted and not used,
    as in the reference."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        ks = _pair(kernel_size)
        bound = math.sqrt(6.0 / (in_channels * ks[0] * ks[1]))
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels) + ks, dtype=dtype,
            device=device).uniform_(-bound, bound,
                                    generator=get_generator(device)))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_channels, dtype=dtype, device=device))
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation, mask=mask)


# -- YOLO, anchors and proposals ----------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head (N, na * (5 + classes), H, W), with na IoU
    channels first when `iou_aware`, into boxes (N, na * H * W, 4) in the
    image's pixels and scores (N, na * H * W, classes), both zero where the
    objectness is not above conf_thresh."""
    na = len(anchors) // 2
    anc = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                          device=x.device)
    n, _, h, w = x.shape
    feat = x
    iou_pred = None
    if iou_aware:
        iou_pred = torch.sigmoid(feat[:, :na].reshape(n, na, h, w))
        feat = feat[:, na:]
    feat = feat.reshape(n, na, -1, h, w)
    tx, ty, tw, th = feat[:, :, 0], feat[:, :, 1], feat[:, :, 2], \
        feat[:, :, 3]
    obj = torch.sigmoid(feat[:, :, 4])
    if iou_pred is not None:
        obj = obj ** (1.0 - iou_aware_factor) * \
            iou_pred ** iou_aware_factor
    cls = torch.sigmoid(feat[:, :, 5:5 + class_num])
    cols = torch.arange(w, device=x.device)[None, None, None, :]
    rows = torch.arange(h, device=x.device)[None, None, :, None]
    gx = (torch.sigmoid(tx) * scale_x_y - (scale_x_y - 1) / 2 + cols) / w
    gy = (torch.sigmoid(ty) * scale_x_y - (scale_x_y - 1) / 2 + rows) / h
    bw = torch.exp(tw) * anc[None, :, None, None, 0] / (downsample_ratio * w)
    bh = torch.exp(th) * anc[None, :, None, None, 1] / (downsample_ratio * h)
    imsz = torch.as_tensor(img_size, device=x.device).float()
    im_h = imsz[:, 0][:, None, None, None]
    im_w = imsz[:, 1][:, None, None, None]
    x1 = (gx - bw / 2) * im_w
    y1 = (gy - bh / 2) * im_h
    x2 = (gx + bw / 2) * im_w
    y2 = (gy + bh / 2) * im_h
    if clip_bbox:
        x1 = torch.minimum(x1.clamp(min=0), im_w - 1)
        y1 = torch.minimum(y1.clamp(min=0), im_h - 1)
        x2 = torch.minimum(x2.clamp(min=0), im_w - 1)
        y2 = torch.minimum(y2.clamp(min=0), im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    score = (obj[..., None] * cls.permute(0, 1, 3, 4, 2)).reshape(
        n, -1, class_num)
    keep = (obj.reshape(n, -1) > conf_thresh)[..., None]
    return boxes * keep, score * keep


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The reference's YOLOv3 loss: every ground-truth box (centre x, y,
    width, height, as fractions of the image; width or height 0 means
    none) matched to its best anchor of `anchor_mask` by width-height IoU
    at the cell holding its centre; squared errors of the centre and the
    log size, binary cross-entropy of the objectness over every cell and
    of the classes (label-smoothed) at the matched cells; the sum over the
    batch divided by its size."""
    na = len(anchor_mask)
    anc_all = np.asarray(anchors, np.float32).reshape(-1, 2)
    anc = torch.as_tensor(anc_all[np.asarray(anchor_mask)], device=x.device)
    n, _, h, w = x.shape
    feat = x.reshape(n, na, 5 + class_num, h, w)
    input_size = downsample_ratio * h
    tx = torch.sigmoid(feat[:, :, 0])
    ty = torch.sigmoid(feat[:, :, 1])
    obj_logit = feat[:, :, 4]
    cls_logit = feat[:, :, 5:]
    gx = gt_box[..., 0] * w
    gy = gt_box[..., 1] * h
    gw = gt_box[..., 2]
    gh = gt_box[..., 3]
    ci = gx.to(torch.int32).clamp(0, w - 1).long()
    cj = gy.to(torch.int32).clamp(0, h - 1).long()
    wh = torch.stack([gw * input_size, gh * input_size], -1)
    inter = torch.minimum(wh[..., None, 0], anc[None, None, :, 0]) * \
        torch.minimum(wh[..., None, 1], anc[None, None, :, 1])
    union = wh[..., 0:1] * wh[..., 1:2] + anc[None, None, :, 0] \
        * anc[None, None, :, 1] - inter
    best_a = torch.argmax(inter / union.clamp(min=1e-10), -1)
    valid = (gw > 0) & (gh > 0)
    bidx = torch.arange(n, device=x.device)[:, None].expand_as(ci)
    lam = valid.float()
    flat = ((bidx * na + best_a) * h + cj) * w + ci
    t_obj = torch.zeros(n * na * h * w, device=x.device).scatter_reduce(
        0, flat.reshape(-1), lam.reshape(-1), "amax").reshape(n, na, h, w)
    sel = (bidx, best_a, cj, ci)
    lx = torch.sum(lam * (tx[sel] - (gx - torch.floor(gx))) ** 2)
    ly = torch.sum(lam * (ty[sel] - (gy - torch.floor(gy))) ** 2)
    tw_t = torch.log((gw * input_size).clamp(min=1e-9)
                     / anc[best_a][..., 0].clamp(min=1e-9))
    th_t = torch.log((gh * input_size).clamp(min=1e-9)
                     / anc[best_a][..., 1].clamp(min=1e-9))
    lw = torch.sum(lam * (feat[:, :, 2][sel] - tw_t) ** 2)
    lh = torch.sum(lam * (feat[:, :, 3][sel] - th_t) ** 2)

    def bce(lg, t):
        return lg.clamp(min=0) - lg * t + torch.log1p(torch.exp(-lg.abs()))
    lobj = torch.sum(bce(obj_logit, t_obj))
    t_cls = TF.one_hot(gt_label.long(), class_num).float()
    if use_label_smooth:
        delta = 1.0 / class_num
        t_cls = t_cls * (1 - delta) + delta / class_num
    lcls = torch.sum(lam[..., None]
                     * bce(cls_logit.movedim(2, -1)[sel], t_cls))
    return (lx + ly + lw + lh + lobj + lcls) / n


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD priors: boxes (H, W, priors, 4) as fractions of the image and
    their variances, float32 on the input's device."""
    h, w = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sh = steps[1] or ih / h
    sw = steps[0] or iw / w
    ars = list(aspect_ratios)
    if flip:
        ars = ars + [1.0 / a for a in ars if a != 1.0]
    boxes = []
    for ms in min_sizes:
        boxes.append((ms, ms))
        if max_sizes:
            for mx in max_sizes:
                s = float(np.sqrt(ms * mx))
                boxes.append((s, s))
        for a in ars:
            if abs(a - 1.0) < 1e-6:
                continue
            boxes.append((ms * float(np.sqrt(a)), ms / float(np.sqrt(a))))
    nb = len(boxes)
    dev = input.device
    f32 = dict(dtype=torch.float32, device=dev)
    bw = torch.tensor([b[0] for b in boxes], **f32) / iw
    bh = torch.tensor([b[1] for b in boxes], **f32) / ih
    cx = (torch.arange(w, **f32) + offset) * sw / iw
    cy = (torch.arange(h, **f32) + offset) * sh / ih
    gcx = cx[None, :, None].expand(h, w, 1)
    gcy = cy[:, None, None].expand(h, w, 1)
    out = torch.stack([gcx - bw / 2, gcy - bh / 2, gcx + bw / 2,
                       gcy + bh / 2], -1)
    if clip:
        out = out.clamp(0.0, 1.0)
    var = torch.tensor(variance, **f32).expand(h, w, nb, 4)
    return out, var


def box_coder(prior_box_t, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode target boxes against priors (centre offsets over the prior's
    size and log size ratios, over the variances), or decode them back."""
    if isinstance(prior_box_var, torch.Tensor):
        var = prior_box_var
    else:
        var = torch.as_tensor(prior_box_var if prior_box_var is not None
                              else [1.0, 1.0, 1.0, 1.0],
                              dtype=torch.float32,
                              device=prior_box_t.device)
    pb, tb = prior_box_t, target_box
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        enc = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log((tw / pw).clamp(min=1e-10)),
                           torch.log((th / ph).clamp(min=1e-10))], -1)
        return enc / var.reshape(-1, 4) if var.dim() else enc / var
    d = tb * (var.reshape(-1, 4) if var.dim() > 1 else var)
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    ww = torch.exp(d[..., 2]) * pw
    hh = torch.exp(d[..., 3]) * ph
    return torch.stack([cx - ww / 2, cy - hh / 2,
                        cx + ww / 2 - norm, cy + hh / 2 - norm], -1)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Each RoI to its FPN level, floor(log2(scale / refer_scale)) +
    refer_level clipped to the levels (the FPN paper's eq. 1), on the
    host: the RoIs of each level, the (R, 1) index that restores the input
    order from their concatenation, and with `rois_num` each level's
    count (int32, shape (1,))."""
    rois = _np(fpn_rois)
    device = _device(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum(rois[:, 2] - rois[:, 0] + off, 0)
                    * np.maximum(rois[:, 3] - rois[:, 1] + off, 0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, restore = [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        outs.append(torch.as_tensor(rois[idx], device=device))
        restore.extend(idx.tolist())
    restore_ind = np.empty(len(rois), np.int64)
    restore_ind[np.asarray(restore, np.int64)] = np.arange(len(rois))
    result = [outs, torch.as_tensor(restore_ind.reshape(-1, 1),
                                    device=device)]
    if rois_num is not None:
        result.append([torch.as_tensor(np.asarray(
            [np.count_nonzero(lvl == level)], np.int32), device=device)
            for level in range(min_level, max_level + 1)])
    return tuple(result)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals on the host, image by image: the pre_nms_top_n best
    anchors decoded by their deltas (log sizes capped at 10), clipped to
    the image, those smaller than min_size dropped, NMS, the
    post_nms_top_n best kept. float32 RoIs and scores on the scores'
    device, and with return_rois_num the count per image (int32)."""
    sc, bd, im = _np(scores), _np(bbox_deltas), _np(img_size)
    an = _np(anchors).reshape(-1, 4)
    va = _np(variances).reshape(-1, 4)
    all_rois, all_probs, rois_num = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for b in range(sc.shape[0]):
        s = sc[b].transpose(1, 2, 0).reshape(-1)
        d = bd[b].transpose(1, 2, 0).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        ww = np.exp(np.minimum(v[:, 2] * d[:, 2], 10)) * aw
        hh = np.exp(np.minimum(v[:, 3] * d[:, 3], 10)) * ah
        boxes = np.stack([cx - ww / 2, cy - hh / 2,
                          cx + ww / 2 - off, cy + hh / 2 - off], -1)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, im[b, 1] - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, im[b, 0] - off)
        keep_sz = ((boxes[:, 2] - boxes[:, 0] + off >= min_size)
                   & (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes, s = boxes[keep_sz], s[keep_sz]
        keep = _nms_keep(boxes, s, nms_thresh)[:post_nms_top_n]
        all_rois.append(boxes[keep])
        all_probs.append(s[keep])
        rois_num.append(len(keep))
    device = _device(scores)
    rois = torch.as_tensor(np.concatenate(all_rois, 0).astype(np.float32),
                           device=device)
    probs = torch.as_tensor(np.concatenate(all_probs, 0).astype(np.float32),
                            device=device)
    if return_rois_num:
        return rois, probs, torch.as_tensor(np.asarray(rois_num, np.int32),
                                            device=device)
    return rois, probs


# -- file IO (host) -----------------------------------------------------------

def read_file(filename, name=None):
    """The file's bytes as a 1-D uint8 host tensor."""
    with open(filename, "rb") as f:
        return torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)


def decode_jpeg(x, mode="unchanged", name=None):
    """An encoded image's bytes -> (C, H, W) uint8 on x's device, decoded
    by PIL; mode "gray" or "rgb" converts, "unchanged" keeps its
    channels."""
    from PIL import Image
    img = Image.open(io.BytesIO(bytes(_np(x).astype(np.uint8))))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.as_tensor(np.array(arr), device=_device(x))
