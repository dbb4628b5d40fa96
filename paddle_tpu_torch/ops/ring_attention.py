"""Ring attention: exact attention over sequence shards (context
parallelism). reference: paddle_tpu/ops/ring_attention.py
(`_partial_attention` :30, `_ring_flash` :47, `_ring_flash_diff` :126,
`ring_attention` :148, `_ring_dense` :171).

The reference runs inside shard_map: each device holds one sequence shard
of q, k and v, and K/V shards rotate around the ring with ppermute while
each step's partial attention merges into the running result by the
log-sum-exp recurrence. The port keeps the global view of
distributed/placement.py: q, k and v hold the whole (batch, seq, heads,
head_dim) value and carry a `process_mesh` whose `axis_name` axis shards
the sequence (Shard(1)); the axis's size n is read from that mesh. Shard i
owns rows [i * s, (i + 1) * s) of the sequence, as `chunk_map` says, and
the ring's ppermute becomes index arithmetic over those blocks: at step t
shard i holds K/V block (i - t) mod n, a roll of the stacked blocks.

- The dense ring (`_ring_dense`) runs each shard's program in turn, step
  by step, in plain torch: its partials are the reference's einsums.
- The flash ring (`_ring_flash`) launches K1 through
  ops/flash_attention._flash_fwd_bhsd once a ring step with the n shards
  stacked into the kernel's batch, so a call makes n launches where the
  reference's n devices make n each. The kernel roles stay static as in
  the reference: step 0 is every shard's own diagonal block, run causal;
  every later step runs non-causal, and under causal attention its lse is
  set to -1e30 where the visiting block is not before the shard's own, so
  the logaddexp merge drops it.
- The flash ring's backward (`_RingFlash`) differentiates the dense ring,
  recomputed from the saved q, k and v, as the reference's
  `_ring_flash_bwd` does.
"""

from __future__ import annotations

import torch

from .flash_attention import _flash_fwd_bhsd, _padded_dim, kernel_takes

__all__ = ["ring_attention"]

NEG_INF = -1e30


def _partial_attention(q, k, v, scale, mask=None):
    """Unnormalised (acc, m, l) for merging. q/k/v: (B, S, H, D); the
    scores and acc in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                  # (B, H, Q, 1)
    # guard all-masked rows
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return acc, m_safe, l


def _ring_axis(q, axis_name):
    """(mesh, n): the mesh q carries (or the default mesh) and the size of
    its `axis_name` axis, which must shard q's sequence dim."""
    from ..distributed.placement import _default_mesh
    mesh = getattr(q, "process_mesh", None) or _default_mesh[0]
    if mesh is None or axis_name not in mesh.dim_names:
        raise ValueError(
            f"ring_attention: q carries no process_mesh with an axis "
            f"{axis_name!r} (shard_tensor q, k and v with Shard(1) on it)")
    placements = getattr(q, "placements", None)
    axis = mesh.dim_names.index(axis_name)
    if placements is not None and not placements[axis].is_shard(1):
        raise ValueError(f"ring_attention: mesh axis {axis_name!r} must "
                         f"shard the sequence dim (Shard(1)), not "
                         f"{placements[axis]}")
    n = mesh.get_dim_size(axis_name)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} does not divide into the "
                         f"{n} shards of axis {axis_name!r}")
    return mesh, n


def _mark(out, q):
    if hasattr(q, "process_mesh"):
        out.process_mesh = q.process_mesh
        out.placements = list(getattr(q, "placements", []))
    return out


def _ring_dense(q, k, v, n, causal, scale):
    """The reference's dense ring, shard by shard: shard i starts from its
    own block and merges block (i - t) mod n at step t."""
    b, s_total, h, d = q.shape
    s = s_total // n
    rows = torch.arange(s, device=q.device)
    outs = []
    for i in range(n):
        qi = q[:, i * s:(i + 1) * s]
        acc = torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(b, h, s, 1, dtype=torch.float32, device=q.device)
        for t in range(n):
            j = (i - t) % n
            mask = None
            if causal:
                mask = ((i * s + rows)[:, None]
                        >= (j * s + rows)[None, :])[None, None]
            acc_j, m_j, l_j = _partial_attention(
                qi, k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s], scale,
                mask)
            m_new = torch.maximum(m, m_j)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_j - m_new)
            acc = acc * alpha + acc_j * beta
            l = l * alpha + l_j * beta
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=2)                         # (B, H, S, D)
    return out.transpose(1, 2).to(q.dtype)


def _blocks(x, n, dp):
    """(B, S, H, D) -> (n, B * H, S / n, dp): the shards' blocks in K1's
    (BH, S, D) layout, the head dim zero-padded to dp."""
    b, s_total, h, d = x.shape
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    x = x.reshape(b, n, s_total // n, h, dp).permute(1, 0, 3, 2, 4)
    return x.reshape(n, b * h, s_total // n, dp).contiguous()


def _ring_flash(q, k, v, n, causal, scale):
    """K1 once a ring step over the n shards stacked into its batch."""
    b, s_total, h, d = q.shape
    s = s_total // n
    dp = _padded_dim(d)
    qb, kb, vb = (_blocks(x, n, dp) for x in (q, k, v))
    bh = b * h

    def flash(t, block_causal):
        # shard i holds K/V block (i - t) mod n: a roll of the blocks
        k_cur = torch.roll(kb, t, dims=0) if t else kb
        v_cur = torch.roll(vb, t, dims=0) if t else vb
        out, lse = _flash_fwd_bhsd(qb.reshape(n * bh, s, dp),
                                   k_cur.reshape(n * bh, s, dp),
                                   v_cur.reshape(n * bh, s, dp),
                                   block_causal, scale)
        return (out.float().reshape(n, bh, s, dp),
                lse[:, :s].reshape(n, bh, s))

    out, lse = flash(0, causal)
    my_idx = torch.arange(n, device=q.device)
    for t in range(1, n):
        out_t, lse_t = flash(t, False)
        if causal:
            # only blocks strictly before the shard's own contribute
            kv_idx = (my_idx - t) % n
            dead = (kv_idx >= my_idx)[:, None, None]
            lse_t = torch.where(dead, torch.full_like(lse_t, NEG_INF), lse_t)
        lse_new = torch.logaddexp(lse, lse_t)
        out = (out * torch.exp(lse - lse_new)[..., None]
               + out_t * torch.exp(lse_t - lse_new)[..., None])
        lse = lse_new
    out = out[..., :d].reshape(n, b, h, s, d).permute(1, 0, 3, 2, 4)
    return out.reshape(b, s_total, h, d).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring forward; its backward differentiates the dense ring
    recomputed from the saved inputs (the reference's `_ring_flash_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.ring = (n, causal, scale)
        return _ring_flash(q, k, v, n, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        n, causal, scale = ctx.ring
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = _ring_dense(*inputs, n, causal, scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, axis_name, causal=False, scale=None,
                   use_flash=None):
    """Exact attention over q, k and v (batch, seq, heads, head_dim) whose
    sequence is sharded on the `axis_name` axis of the mesh they carry
    (`process_mesh`, Shard(1) there). Returns the (batch, seq, heads,
    head_dim) output in q's dtype, marked with q's mesh and placements.

    use_flash: each ring step through K1 (`_ring_flash`) instead of the
    dense partials; None picks it on the card, for the dtypes and head
    dims K1 takes. On the CPU K1 is its plain version. Both paths are
    differentiable: the flash path's backward differentiates the dense
    ring."""
    _, n = _ring_axis(q, axis_name)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if use_flash is None:
        use_flash = q.is_cuda and kernel_takes(q.dtype, d)
    if use_flash:
        out = _RingFlash.apply(q, k, v, n, bool(causal), float(scale))
    else:
        out = _ring_dense(q, k, v, n, bool(causal), float(scale))
    return _mark(out, q)
