"""Flash attention: the forward (kernel K1), its fused RMSNorm epilogue
(kernel K2), the backward (kernels K3 and K4), the dense backend, and the
autograd Function around them.

reference: paddle_tpu/ops/pallas/flash_attention.py — `_fa_fwd_kernel`
(:116) launched by `_flash_fwd_bhsd` (:445), with `epilogue=True` (K2)
through `flash_attention_rms_epilogue_bshd` (:803); `_fa_dq_kernel` (:198)
and `_fa_dkv_kernel` (:249) launched by `_flash_bwd_bhsd` (:539);
`_xla_attention_bhsd` (:664); `_dense_remat_bwd` (:703); the `custom_vjp`
`_flash_attention_bhsd` with `FLAGS_flash_attention_bwd` (:688-767);
`flash_attention_bshd` (:770).

The kernels are hand-written CUDA C++ for Hopper
(paddle_tpu_torch/csrc/flash_attention_fwd.cu and flash_attention_bwd.cu),
built by `ops/_build.py`. `_flash_fwd_bhsd_plain` and
`_flash_bwd_bhsd_plain` are the same functions in dense torch math. The
wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernels or raise. K1 and K2 are registered
operators (`torch.ops.paddle_tpu_torch.flash_fwd` and
`flash_fwd_rms_epilogue`, `torch.library.custom_op`), so torch.export
records them and an exported program launches them. The backward is K3 then K4, or
the dense rematerialised backward, as `FLAGS_flash_attention_bwd` (or, in
its 'auto' mode, ops/attention_router) picks.
"""

from __future__ import annotations

import torch

from ..framework import flags as _flags

__all__ = ["flash_attention_bshd", "flash_attention_bshd_higher_order",
           "flash_attention_rms_epilogue_bshd", "kernel_takes", "NEG_INF"]

NEG_INF = -1e30

# kernel launches since the last reset; chip_smoke.py reads them to show
# that a run went through the kernels
flash_fwd_launches = 0
flash_fwd_rms_epilogue_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_HEAD_DIMS = (64, 128)
# the (query rows, keys) tile the kernels are compiled for
# (csrc/flash_attention_fwd.cu BM/BN, templated on D, BF16 and EPI only):
# one, so there is nothing for ops/autotune to choose among yet
TILE_CANDIDATES = ((128, 128),)


def kernel_takes(dtype, head_dim) -> bool:
    """Whether the flash kernels take this dtype and (true) head dim: bf16
    or fp16, d <= 128 (padded to 64 or 128)."""
    return dtype in _KERNEL_DTYPES and head_dim <= 128


def _padded_dim(d):
    """The kernels' head dim for a true head dim d: 64 or 128. A head dim
    above 128 is kept as it is: the kernels do not take it, and the
    callers send it to the dense path."""
    if d > 128:
        return d
    return 64 if d <= 64 else 128


def _causal_keep(sq, sk, device):
    """(sq, sk) bool: True where query row i may see key j, aligned
    bottom-right (j <= i + sk - sq)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def _grouped_scores(q, k, causal, scale, q_per_kv):
    """f32 scores (BH // q_per_kv, q_per_kv, Sq, Sk) of q (BH, Sq, D)
    against k (BH // q_per_kv, Sk, D): scale Q K^T under the bottom-right
    causal mask with the finite -1e30."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qg = q.float().reshape(bh // q_per_kv, q_per_kv, sq, d)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device), NEG_INF)
    return s


def _rms_epilogue(h, rms_weight, rms_eps, rms_d):
    """K2's epilogue in f32: h * rsqrt(sum(h^2) / rms_d + eps) * weight."""
    ms = (h * h).sum(-1, keepdim=True) / rms_d
    return h * torch.rsqrt(ms + rms_eps) * rms_weight.float()


def _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv=1, residual=None,
                          rms_weight=None, rms_eps=1e-6, rms_d=None):
    """Dense torch version of K1 and K2: q (BH, Sq, D), k/v (BH // q_per_kv,
    Sk, D) -> (out (BH, Sq, D) in q's dtype, lse (BH, Sq) f32). Scores in
    f32, the bottom-right causal mask with the finite -1e30, P rounded to
    v's dtype before P V (as the kernel does). With `residual` (BH, Sq, D)
    and `rms_weight` (D,), K2: out = rmsnorm(attn + residual) * weight over
    the head dim in f32, the attention output not rounded before the add,
    the mean taken over `rms_d` (default D) columns."""
    bh, sq, d = q.shape
    s = _grouped_scores(q, k, causal, scale, q_per_kv)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgqk,bkd->bgqd", p.float(), v.float())
    out = out.reshape(bh, sq, d)
    if residual is not None:
        out = _rms_epilogue(out + residual.float(), rms_weight, rms_eps,
                            rms_d or d)
    return out.to(q.dtype), lse.reshape(bh, sq)


def _flash_bwd_bhsd_plain(q, k, v, o, lse, g, causal, scale, q_per_kv=1):
    """Dense torch version of K3 and K4, in the math of the reference's
    `_flash_bwd_bhsd`: q, o, g (BH, Sq, D), k/v (BH // q_per_kv, Sk, D), lse
    (BH, Sq) f32 -> (dq, dk, dv) in the inputs' dtypes, dk and dv summed
    over each kv head's query heads. delta = rowsum(dO * O) and
    P = exp(scale Q K^T - lse) in f32 under the -1e30 causal mask; P is
    rounded to the input dtype before P^T dO, and dS = P (dO V^T - delta)
    before dS K and dS^T Q; every product sums in f32. A masked entry's P
    is 0, as in the kernels: exp(-1e30 - lse) is 0 wherever a row admits a
    key, and on a row that admits none (causal, sq > sk) lse is itself
    about -1e30, so the difference could round to anything."""
    bh, sq, d = q.shape
    shape = (bh // q_per_kv, q_per_kv, sq, d)
    qg = q.float().reshape(shape)
    gg = g.float().reshape(shape)
    delta = (gg * o.float().reshape(shape)).sum(-1, keepdim=True)
    s = _grouped_scores(q, k, causal, scale, q_per_kv)
    p = torch.exp(s - lse.reshape(shape[:3])[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(sq, k.shape[1], q.device), 0.0)
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
    """K1: (out, lse)."""
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


def _flash_fwd_rms_epilogue_cuda(q, k, v, residual, rms_weight, causal,
                                 scale, q_per_kv, rms_eps, rms_d):
    """K2: (rmsnorm(attn + residual) * weight, lse); rms_weight f32 (D,)."""
    global flash_fwd_rms_epilogue_launches
    from ._build import library
    bh, sq, d = q.shape
    _check_kernel_inputs("flash_fwd_rms_epilogue", (q, k, v, residual), d)
    if rms_weight.dtype != torch.float32 or not rms_weight.is_contiguous() \
            or rms_weight.data_ptr() % 16:
        raise TypeError("flash_fwd_rms_epilogue kernel takes a contiguous, "
                        "16-byte aligned float32 rms_weight")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = library()
    err = lib.flash_fwd_rms_epilogue(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), residual.data_ptr(),
        rms_weight.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, sq,
        k.shape[1], d, q_per_kv, int(causal), float(scale), float(rms_eps),
        int(rms_d), int(q.dtype == torch.bfloat16), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_fwd_rms_epilogue")
    flash_fwd_rms_epilogue_launches += 1
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


# K1 and K2 as registered operators, so that torch.export records each as
# one node (a FakeTensor has no storage, so the ctypes launch itself cannot
# be traced): the CPU implementation is the plain version, the CUDA one
# launches the kernel, and the fake one gives the (out, lse) shapes.
# _FlashAttention stays around the forward operator for the backward.
@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
           "int q_per_kv) -> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, causal, scale, q_per_kv):
    return _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv)


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd_rms_epilogue", mutates_args=(),
    device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor residual, "
           "Tensor rms_weight, bool causal, float scale, int q_per_kv, "
           "float rms_eps, int rms_d) -> (Tensor, Tensor)")
def flash_fwd_rms_epilogue_op(q, k, v, residual, rms_weight, causal, scale,
                              q_per_kv, rms_eps, rms_d):
    return _flash_fwd_bhsd_plain(q, k, v, causal, scale, q_per_kv, residual,
                                 rms_weight, rms_eps, rms_d)


flash_fwd_op.register_kernel("cuda")(_flash_fwd_cuda)
flash_fwd_rms_epilogue_op.register_kernel("cuda")(
    _flash_fwd_rms_epilogue_cuda)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, q_per_kv):
    return torch.empty_like(q), q.new_empty(q.shape[:2],
                                            dtype=torch.float32)


@flash_fwd_rms_epilogue_op.register_fake
def _flash_fwd_rms_epilogue_fake(q, k, v, residual, rms_weight, causal,
                                 scale, q_per_kv, rms_eps, rms_d):
    return _flash_fwd_fake(q, k, v, causal, scale, q_per_kv)


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


def _flash_fwd_bhsd(q, k, v, causal, scale, q_per_kv=1, residual=None,
                    rms_weight=None, rms_eps=1e-6, rms_d=None):
    """K1: q (BH, Sq, D), k/v (BH // q_per_kv, Sk, D) -> (out, lse).

    residual (BH, Sq, D) in q's dtype and rms_weight (D,), both given or
    neither: K2, out = rmsnorm(attn + residual) * rms_weight over the head
    dim, in f32 inside the flush, the mean taken over `rms_d` columns (the
    true head dim when D is zero-padded; default D). Forward only.

    Both go through the registered operators (`flash_fwd_op`,
    `flash_fwd_rms_epilogue_op`): CPU tensors take
    `_flash_fwd_bhsd_plain`; CUDA tensors launch the kernel (bf16/fp16, D
    in {64, 128}) or raise. Query head b reads kv head
    b // q_per_kv (batch-major b). The causal mask is aligned bottom-right.
    A row with no admissible key (causal, sq > sk) has no defined result:
    the kernel and the plain version both give it finite values (a uniform
    average of the keys each visits, lse about -1e30), but not the same
    ones, and such rows are not compared.
    """
    _check_shapes(q, k, v, q_per_kv)
    if (residual is None) != (rms_weight is None):
        raise ValueError("residual and rms_weight are given together")
    tensors = (q, k, v)
    if residual is not None:
        if residual.shape != q.shape or residual.dtype != q.dtype:
            raise ValueError(f"residual {tuple(residual.shape)} "
                             f"{residual.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
        if rms_weight.shape != (q.shape[2],):
            raise ValueError(f"rms_weight {tuple(rms_weight.shape)} must be "
                             f"({q.shape[2]},)")
        tensors += (residual, rms_weight)
    _device_of(*tensors)
    if residual is None:
        return flash_fwd_op(q, k, v, bool(causal), float(scale),
                            int(q_per_kv))
    return flash_fwd_rms_epilogue_op(
        q, k, v, residual, rms_weight.float().contiguous(), bool(causal),
        float(scale), int(q_per_kv), float(rms_eps), int(rms_d or q.shape[2]))


def _flash_bwd_bhsd(q, k, v, o, lse, g, causal, scale, q_per_kv=1):
    """K3 and K4: the FlashAttention-2 backward -> (dq, dk, dv) in the
    inputs' dtypes, dk/dv (BH // q_per_kv, Sk, D) already summed over each
    kv head's query heads. delta = rowsum(dO * O) is taken in f32 with
    torch ops, outside the kernels, as the reference takes it outside
    Pallas.

    CPU tensors take `_flash_bwd_bhsd_plain`; CUDA tensors launch K3 then K4
    or raise, for the dtypes and head dims K1 takes. Rows with no admissible
    key (causal, sq > sk) are undefined in the forward; the kernels and the
    plain version let them contribute nothing (their P is 0), where the
    reference's Pallas backward takes exp(-1e30 - lse) at face value.
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


def _xla_attention_bhsd(q, k, v, causal, scale, q_per_kv=1):
    """The dense backend (O(S^2) memory), differentiable through torch
    autograd: q (BH, Sq, D), k/v (BH // q_per_kv, Sk, D) -> (BH, Sq, D) in
    v's dtype. Scores in f32 (the products run in f32 on f32 copies of the
    inputs), the -1e30 causal mask, P rounded to v's dtype before P V.
    GQA-grouped: query head b reads kv head b // q_per_kv."""
    bh, sq, d = q.shape
    p = torch.softmax(_grouped_scores(q, k, causal, scale, q_per_kv),
                      dim=-1).to(v.dtype)
    out = torch.einsum("bgqk,bkd->bgqd", p.float(), v.float())
    return out.reshape(bh, sq, d).to(v.dtype)


def _dense_remat_bwd(q, k, v, causal, scale, q_per_kv, g):
    """The backward by dense rematerialisation (GQA-grouped): the dense
    forward runs again under torch autograd and is differentiated against
    dO = g. -> (dq, dk, dv) in the inputs' dtypes, dk/dv summed over each
    kv head's query heads. Selected by FLAGS_flash_attention_bwd=xla (or
    by the router in 'auto' mode)."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = _xla_attention_bhsd(qd, kd, vd, causal, scale, q_per_kv)
        return torch.autograd.grad(out, (qd, kd, vd), g)


def _bwd_mode(q, k, causal):
    """FLAGS_flash_attention_bwd, with 'auto' resolved by the router for
    this shape on the tensors' device. If the router itself fails (a
    measurement on a ledger miss that does not run, say), the backward
    takes the kernels, as the reference's `_fa_bwd` does (:751-759)."""
    mode = _flags.flag_value("flash_attention_bwd")
    if mode == "auto":
        try:
            from .attention_router import route
            mode = route(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                         q.dtype, causal, platform=q.device.type).bwd
        except Exception:  # noqa: BLE001 - the reference's fallback
            mode = "pallas"
    if mode not in ("pallas", "xla"):
        raise ValueError(f"FLAGS_flash_attention_bwd={mode!r}; pick "
                         f"'pallas', 'xla' or 'auto'")
    return mode


_TWICE = (b"flash_attention_bshd: trying to differentiate twice through "
          b"K3/K4, whose backward is first order only. For higher-order "
          b"gradients call nn.functional.scaled_dot_product_attention, whose "
          b"kernel branch differentiates a dense forward again, or set "
          b"FLAGS_flash_attention_backend=xla")


def _first_order_only(bwd):
    """torch's `once_differentiable` with a message that names the way
    out: the backward runs without a graph, and under create_graph=True its
    gradients carry a node that raises when they are differentiated
    again, as the reference's engine raises (framework/core.py:444-450)."""
    def wrapper(ctx, *grads):
        with torch.no_grad():
            outs = bwd(ctx, *grads)
        if not torch.is_grad_enabled() or not any(
                g.requires_grad for g in grads):
            return outs
        err = torch._C._functions.DelayedError(_TWICE, len(outs))
        return err(*[None if o is None else o.detach().requires_grad_()
                     for o in outs])
    return wrapper


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal, scale, q_per_kv = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale, ctx.q_per_kv = causal, scale, q_per_kv
    ctx.mark_non_differentiable(lse)


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K3/K4 or the dense rematerialised backward: the
    counterpart of the reference's `custom_vjp` `_flash_attention_bhsd`.
    The backward is first-order only: its gradients, taken with
    create_graph=True, raise when differentiated again. Under
    `torch.utils.checkpoint` the forward runs again in the backward pass,
    which launches K1 again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_per_kv):
        out, lse = _flash_fwd_bhsd(q, k, v, causal, scale, q_per_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.q_per_kv = causal, scale, q_per_kv
        return out

    @staticmethod
    def first_order(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if _bwd_mode(q, k, ctx.causal) == "xla":
            dq, dk, dv = _dense_remat_bwd(q, k, v, ctx.causal, ctx.scale,
                                          ctx.q_per_kv, g)
        else:
            dq, dk, dv = _flash_bwd_bhsd(q, k, v, out, lse, g, ctx.causal,
                                         ctx.scale, ctx.q_per_kv)
        return dq, dk, dv, None, None, None

    backward = staticmethod(_first_order_only(first_order.__func__))


# K1's operator differentiates through K3/K4 (or the dense rematerialised
# backward, as routed), first order only: _FlashAttention's backward. A
# program that holds the bare operator (a captured to_static program)
# trains through the backward kernels; lse is not differentiable. Eager
# calls go through _FlashAttention, whose forward runs with autograd off,
# so this formula never runs there.
flash_fwd_op.register_autograd(
    _first_order_only(lambda ctx, g, _g_lse:
                      _FlashAttention.first_order(ctx, g)),
    setup_context=_flash_fwd_setup)


class _FlashAttentionHigherOrder(_FlashAttention):
    """The same forward (K1, the same saved tensors); a backward that can
    be differentiated again: the counterpart of the reference's
    `_ho_fwd`, the dense forward that its sdpa kernel branch records
    (nn/functional/attention.py:105-120) and its engine differentiates
    under create_graph=True (framework/core.py:396-450). Without
    create_graph the backward is `_FlashAttention`'s, bit for bit (K3/K4
    or the dense remat, as routed); with it, torch.autograd.grad of the
    dense forward `_xla_attention_bhsd`, recomputed from the saved q, k
    and v with its graph kept, so no K3/K4 launch."""

    @staticmethod
    def backward(ctx, g):
        if not torch.is_grad_enabled():
            return _FlashAttention.first_order(ctx, g)
        q, k, v, _, _ = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        out = _xla_attention_bhsd(q, k, v, ctx.causal, ctx.scale,
                                  ctx.q_per_kv)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip((q, k, v), need) if n], g,
            create_graph=True))
        return tuple(next(grads) if n else None for n in need) + (None,) * 3


def _to_bhsd(x, dp):
    """(b, s, heads, d) -> (b * heads, s, dp), zero-padded to dp columns."""
    b, s, h, d = x.shape
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    return x.transpose(1, 2).reshape(b * h, s, dp).contiguous()


def _check_heads(h, kvh):
    if h % kvh:
        raise ValueError(f"num_heads {h} not divisible by kv heads {kvh}")


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Paddle's flash_attention layout: q (b, sq, h, d), k/v (b, sk, kvh, d)
    with kvh dividing h (GQA: kv heads are never expanded) -> (b, sq, h, d).
    Differentiable in q, k and v (first order: a second order raises).

    The softmax scale defaults to 1/sqrt(d) of the true d. The head dim is
    zero-padded to the kernel's sizes (d <= 64 -> 64, d <= 128 -> 128; so
    d96 -> 128): zero columns change neither Q K^T nor P V, the pad is
    sliced off the output, and the gradients of the pad columns are sliced
    off by the pad's own backward.

    CUDA tensors of a dtype or head dim the kernels do not take (float32,
    d > 128) take the dense backend, differentiated by torch autograd, as
    the reference takes any dtype and head dim; CPU tensors take the
    kernels' plain versions at any head dim."""
    return _bshd(_FlashAttention, q, k, v, causal, scale)


def flash_attention_bshd_higher_order(q, k, v, causal=False, scale=None):
    """flash_attention_bshd whose gradients can be differentiated again
    (`_FlashAttentionHigherOrder`): the forward and the first order are
    flash_attention_bshd's; under create_graph=True the backward is the
    dense forward's. scaled_dot_product_attention's kernel branch calls
    it, as the reference's sdpa alone registers the dense higher-order
    forward; flash_attention_bshd itself stays first order."""
    return _bshd(_FlashAttentionHigherOrder, q, k, v, causal, scale)


def _bshd(fn, q, k, v, causal, scale):
    """flash_attention_bshd through the autograd Function `fn`."""
    b, sq, h, d = q.shape
    _check_heads(h, k.shape[2])
    dp = _padded_dim(d)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cuda" and not kernel_takes(q.dtype, d):
        out = _xla_attention_bhsd(_to_bhsd(q, d), _to_bhsd(k, d),
                                  _to_bhsd(v, d), causal, scale,
                                  h // k.shape[2])
        return out.reshape(b, h, sq, d).transpose(1, 2)
    out = fn.apply(_to_bhsd(q, dp), _to_bhsd(k, dp), _to_bhsd(v, dp),
                   causal, scale, h // k.shape[2])
    out = out.reshape(b, h, sq, dp).transpose(1, 2)
    return out[..., :d] if dp != d else out


def flash_attention_rms_epilogue_bshd(q, k, v, residual, rms_weight,
                                      causal=True, scale=None, eps=1e-6):
    """Flash attention with the rmsnorm(attn + residual) * weight epilogue
    fused into the kernel's flush (K2): the attention output is written
    once, already normalized.

    Layout as flash_attention_bshd: q (b, sq, h, d), k/v GQA-native
    (b, sk, kvh, d); residual (b, sq, h, d) in q's dtype; rms_weight (d,).
    The norm axis is the head dim, with the mean over the true d (pad
    columns are zero in the attention output, the residual and the
    weight). Forward only, as the reference's: with autograd on and an
    input that requires grad it raises. CUDA tensors of a dtype or head
    dim the kernels do not take get the same function in dense torch math
    (`_flash_fwd_bhsd_plain`'s, which runs on any device)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, residual, rms_weight)):
        raise RuntimeError("flash_attention_rms_epilogue_bshd is forward "
                           "only: it has no backward")
    b, sq, h, d = q.shape
    _check_heads(h, k.shape[2])
    if residual.shape != q.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != q "
                         f"{tuple(q.shape)}")
    if rms_weight.shape != (d,):
        raise ValueError(f"rms_weight shape {tuple(rms_weight.shape)} != "
                         f"({d},)")
    dp = _padded_dim(d)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    w = rms_weight.float()
    if dp != d:
        w = torch.nn.functional.pad(w, (0, dp - d))
    dense = q.device.type == "cuda" and not kernel_takes(q.dtype, d)
    fwd = _flash_fwd_bhsd_plain if dense else _flash_fwd_bhsd
    out, _ = fwd(_to_bhsd(q, dp), _to_bhsd(k, dp), _to_bhsd(v, dp), causal,
                 scale, h // k.shape[2], residual=_to_bhsd(residual, dp),
                 rms_weight=w, rms_eps=eps, rms_d=d)
    out = out.reshape(b, h, sq, dp).transpose(1, 2)
    return out[..., :d] if dp != d else out
