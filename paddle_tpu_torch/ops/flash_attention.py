"""Flash attention: the forward (kernel K1), the backward (kernels K3 and
K4), and the autograd Function around them.

reference: paddle_tpu/ops/pallas/flash_attention.py — `_fa_fwd_kernel`
(:116) launched by `_flash_fwd_bhsd` (:445); `_fa_dq_kernel` (:198) and
`_fa_dkv_kernel` (:249) launched by `_flash_bwd_bhsd` (:539); the
`custom_vjp` `_flash_attention_bhsd` (:688-767); `flash_attention_bshd`
(:770).

The kernels are hand-written CUDA C++ for Hopper
(paddle_tpu_torch/csrc/flash_attention_fwd.cu and flash_attention_bwd.cu),
built by `ops/_build.py`. `_flash_fwd_bhsd_plain` and
`_flash_bwd_bhsd_plain` are the same functions in dense torch math. The
wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernels or raise. On CUDA the backward is always
K3 then K4: the reference's `FLAGS_flash_attention_bwd` and its dense
rematerialised backward are not ported.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

__all__ = ["flash_attention_bshd", "NEG_INF"]

NEG_INF = -1e30

# kernel launches since the last reset; chip_smoke.py reads them to show
# that a run went through the kernels
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_HEAD_DIMS = (64, 128)


def _causal_keep(sq, sk, device):
    """(sq, sk) bool: True where query row i may see key j, aligned
    bottom-right (j <= i + sk - sq)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv=1):
    """Dense torch version of K1: q (BH, Sq, D), k/v (BH // q_per_kv, Sk, D)
    -> (out (BH, Sq, D) in q's dtype, lse (BH, Sq) f32). Scores in f32, the
    bottom-right causal mask with the finite -1e30, P rounded to v's dtype
    before P V (as the kernel does)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qg = q.float().reshape(bh // q_per_kv, q_per_kv, sq, d)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgqk,bkd->bgqd", p.float(), v.float())
    return (out.reshape(bh, sq, d).to(q.dtype), lse.reshape(bh, sq))


def _flash_bwd_bhsd_plain(q, k, v, o, lse, g, causal, scale, q_per_kv=1):
    """Dense torch version of K3 and K4, in the math of the reference's
    `_flash_bwd_bhsd`: q, o, g (BH, Sq, D), k/v (BH // q_per_kv, Sk, D), lse
    (BH, Sq) f32 -> (dq, dk, dv) in the inputs' dtypes, dk and dv summed
    over each kv head's query heads. delta = rowsum(dO * O) and
    P = exp(scale Q K^T - lse) in f32 under the -1e30 causal mask; P is
    rounded to the input dtype before P^T dO, and dS = P (dO V^T - delta)
    before dS K and dS^T Q; every product sums in f32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    shape = (bh // q_per_kv, q_per_kv, sq, d)
    qg = q.float().reshape(shape)
    gg = g.float().reshape(shape)
    delta = (gg * o.float().reshape(shape)).sum(-1, keepdim=True)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(shape[:3])[..., None])
    dp = torch.einsum("bgqd,bkd->bgqk", gg, v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dv = torch.einsum("bgqk,bgqd->bkd", p.to(q.dtype).float(), gg)
    dk = torch.einsum("bgqk,bgqd->bkd", ds, qg) * scale
    dq = torch.einsum("bgqk,bkd->bgqd", ds, k.float()) * scale
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_inputs(name, tensors, d):
    if tensors[0].dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes bfloat16 or float16, got "
                        f"{tensors[0].dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dim 64 or 128, got {d}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous 16-byte "
                             f"aligned inputs")


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.cuda_error_string(err).decode())


def _flash_fwd_cuda(q, k, v, causal, scale, q_per_kv):
    global flash_fwd_launches
    from ._build import library
    bh, sq, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs("flash_fwd", (q, k, v), d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                        q_per_kv, int(causal), float(scale),
                        int(q.dtype == torch.bfloat16), q.device.index,
                        stream)
    _raise_on(lib, err, "flash_fwd")
    flash_fwd_launches += 1
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, q_per_kv):
    """K3: dq (BH, Sq, D) from q, k, v, dO, lse and delta."""
    global flash_bwd_dq_launches
    from ._build import library
    bh, sq, d = q.shape
    _check_kernel_inputs("flash_bwd_dq", (q, k, v, g, lse, delta), d)
    dq = torch.empty_like(q)
    lib = library()
    err = lib.flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
        d, q_per_kv, int(causal), float(scale),
        int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_bwd_dq")
    flash_bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, q_per_kv):
    """K4: dk, dv (BH // q_per_kv, Sk, D), summed over each kv head's query
    heads in the kernel."""
    global flash_bwd_dkv_launches
    from ._build import library
    bh, sq, d = q.shape
    _check_kernel_inputs("flash_bwd_dkv", (q, k, v, g, lse, delta), d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = library()
    err = lib.flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, k.shape[1], d, q_per_kv, int(causal), float(scale),
        int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv_launches += 1
    return dk, dv


def _device_of(*tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash attention inputs lie on different devices: "
                         f"{devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention does not run on {device}")
    return device


def _check_shapes(q, k, v, q_per_kv):
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] * q_per_kv != bh or k.shape[2] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} for q_per_kv={q_per_kv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")


def _flash_fwd_bhsd(q, k, v, causal, scale, q_per_kv=1):
    """K1: q (BH, Sq, D), k/v (BH // q_per_kv, Sk, D) -> (out, lse).

    CPU tensors take `_flash_fwd_bhsd_plain`; CUDA tensors launch the kernel
    (bf16/fp16, D in {64, 128}) or raise. Query head b reads kv head
    b // q_per_kv (batch-major b). The causal mask is aligned bottom-right.
    A row with no admissible key (causal, sq > sk) has no defined result:
    the kernel and the plain version give different finite values there,
    and such rows are not compared.
    """
    _check_shapes(q, k, v, q_per_kv)
    if _device_of(q, k, v).type == "cpu":
        return _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv)
    return _flash_fwd_cuda(q, k, v, causal, scale, q_per_kv)


def _flash_bwd_bhsd(q, k, v, o, lse, g, causal, scale, q_per_kv=1):
    """K3 and K4: the FlashAttention-2 backward -> (dq, dk, dv) in the
    inputs' dtypes, dk/dv (BH // q_per_kv, Sk, D) already summed over each
    kv head's query heads. delta = rowsum(dO * O) is taken in f32 with
    torch ops, outside the kernels, as the reference takes it outside
    Pallas.

    CPU tensors take `_flash_bwd_bhsd_plain`; CUDA tensors launch K3 then K4
    or raise, for the dtypes and head dims K1 takes. Rows with no admissible
    key (causal, sq > sk) are undefined in the forward; the kernels let
    them contribute nothing, so dk and dv then differ from the plain
    version's.
    """
    _check_shapes(q, k, v, q_per_kv)
    if o.shape != q.shape or g.shape != q.shape or \
            lse.shape != q.shape[:2]:
        raise ValueError(f"bad shapes o {tuple(o.shape)} dO {tuple(g.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if not (o.dtype == g.dtype == q.dtype) or lse.dtype != torch.float32:
        raise TypeError(f"o and dO must have q's dtype {q.dtype} and lse "
                        f"float32; got {o.dtype}, {g.dtype}, {lse.dtype}")
    if _device_of(q, k, v, o, lse, g).type == "cpu":
        return _flash_bwd_bhsd_plain(q, k, v, o, lse, g, causal, scale,
                                     q_per_kv)
    delta = (g.float() * o.float()).sum(-1)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, q_per_kv)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale,
                                 q_per_kv)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K3/K4 backward: the counterpart of the reference's
    `custom_vjp` `_flash_attention_bhsd`. The backward is first-order only
    (`once_differentiable`); the reference's higher-order path is not
    ported. Under `torch.utils.checkpoint` the forward runs again in the
    backward pass, which launches K1 again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_per_kv):
        out, lse = _flash_fwd_bhsd(q, k, v, causal, scale, q_per_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.q_per_kv = causal, scale, q_per_kv
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_bhsd(q, k, v, out, lse, g.contiguous(),
                                     ctx.causal, ctx.scale, ctx.q_per_kv)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Paddle's flash_attention layout: q (b, sq, h, d), k/v (b, sk, kvh, d)
    with kvh dividing h (GQA: kv heads are never expanded) -> (b, sq, h, d).
    Differentiable in q, k and v (first order).

    The softmax scale defaults to 1/sqrt(d) of the true d. The head dim is
    zero-padded to the kernel's sizes (d <= 64 -> 64, d <= 128 -> 128; so
    d96 -> 128): zero columns change neither Q K^T nor P V, the pad is
    sliced off the output, and the gradients of the pad columns are sliced
    off by the pad's own backward."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"num_heads {h} not divisible by kv heads {kvh}")
    if d > 128:
        raise ValueError(f"head dim {d} > 128 is not supported")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dp = 64 if d <= 64 else 128
    if dp != d:
        pad = (0, dp - d)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    qt = q.transpose(1, 2).reshape(b * h, sq, dp).contiguous()
    kt = k.transpose(1, 2).reshape(b * kvh, sk, dp).contiguous()
    vt = v.transpose(1, 2).reshape(b * kvh, sk, dp).contiguous()
    out = _FlashAttention.apply(qt, kt, vt, causal, scale, h // kvh)
    out = out.reshape(b, h, sq, dp).transpose(1, 2)
    return out[..., :d] if dp != d else out
