"""Flash-attention forward (kernel K1) and its wrapper.

reference: paddle_tpu/ops/pallas/flash_attention.py — `_fa_fwd_kernel` (:116)
launched by `_flash_fwd_bhsd` (:445), and `flash_attention_bshd` (:770).

The kernel is hand-written CUDA C++ for Hopper
(paddle_tpu_torch/csrc/flash_attention_fwd.cu), built by `ops/_build.py`.
`_flash_fwd_bhsd_plain` is the same function in dense torch math. The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The backward (the reference's
K3/K4) is not ported yet, so the wrapper refuses a gradient request.
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_bshd", "NEG_INF"]

NEG_INF = -1e30

# kernel launches since the last reset; chip_smoke.py reads it to show that
# a run went through the kernel
flash_fwd_launches = 0

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_HEAD_DIMS = (64, 128)


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
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgqk,bkd->bgqd", p.float(), v.float())
    return (out.reshape(bh, sq, d).to(q.dtype), lse.reshape(bh, sq))


def _flash_fwd_cuda(q, k, v, causal, scale, q_per_kv):
    global flash_fwd_launches
    from ._build import library
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_fwd kernel takes bfloat16 or float16, got "
                        f"{q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dim 64 or 128, got {d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_fwd kernel needs contiguous 16-byte "
                             "aligned q/k/v")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                        q_per_kv, int(causal), float(scale),
                        int(q.dtype == torch.bfloat16), q.device.index,
                        stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.cuda_error_string(err).decode())
    flash_fwd_launches += 1
    return out, lse


def _flash_fwd_bhsd(q, k, v, causal, scale, q_per_kv=1):
    """K1: q (BH, Sq, D), k/v (BH // q_per_kv, Sk, D) -> (out, lse).

    CPU tensors take `_flash_fwd_bhsd_plain`; CUDA tensors launch the kernel
    (bf16/fp16, D in {64, 128}) or raise. Query head b reads kv head
    b // q_per_kv (batch-major b). The causal mask is aligned bottom-right.
    A row with no admissible key (causal, sq > sk) has no defined result:
    the kernel and the plain version give different finite values there,
    and such rows are not compared.
    """
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] * q_per_kv != bh or k.shape[2] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} for q_per_kv={q_per_kv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward in paddle_tpu_torch yet (the "
            "reference's dQ/dKV kernels are a later slice); run it under "
            "torch.no_grad() or torch.inference_mode()")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv)
    if device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale, q_per_kv)
    raise ValueError(f"flash attention does not run on {device}")


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Paddle's flash_attention layout: q (b, sq, h, d), k/v (b, sk, kvh, d)
    with kvh dividing h (GQA: kv heads are never expanded) -> (b, sq, h, d).

    The softmax scale defaults to 1/sqrt(d) of the true d. The head dim is
    zero-padded to the kernel's sizes (d <= 64 -> 64, d <= 128 -> 128; so
    d96 -> 128): zero columns change neither Q K^T nor P V, and the pad is
    sliced off the output."""
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
    out, _ = _flash_fwd_bhsd(qt, kt, vt, causal, scale, h // kvh)
    out = out.reshape(b, h, sq, dp).transpose(1, 2)
    return out[..., :d] if dp != d else out
