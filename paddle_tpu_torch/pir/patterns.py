"""DRR-lite pattern rewriting over captured torch programs.

reference: paddle_tpu/pir/patterns.py (after paddle/fluid/pir/drr/): a
source pattern (a small graph of ops with constraints) and a result pattern
(one `pt.*` op whose callable routes between a hand-written kernel and an
exact replay of the matched region). The matchers here walk the aten ops
the port's own programs are captured as, not the reference's jax
primitives.

* `sdpa_route` (`SdpaRoutePattern`): attention written out densely,
  Q K^T -> scale -> a causal mask -> softmax -> P V, becomes one `pt.sdpa`
  op. It anchors on `aten._softmax` over the last dim, walks the score
  chain up (layout ops, a scalar scale, one `masked_fill`/`where` with a
  constant mask) to a `bmm`, walks the probabilities down (layout ops,
  dtype casts) to the second `bmm`, and walks each product operand up
  through layout ops (view, permute, expand, clone, `_to_copy`, ...) to
  q, k and v in the (batch, seq, heads, head_dim) layout, and the output
  down to the same layout. Where eager attention would take the flash
  kernels at the shape (`_use_pallas`: on the card, under
  FLAGS_flash_attention_backend and, under 'auto', ops/attention_router),
  `pt.sdpa` calls `flash_attention_bshd` (K1, with K3/K4 as its
  backward); elsewhere it replays the region.
* `rms_epilogue` (`RmsEpiloguePattern`): rmsnorm(pt.sdpa + residual) *
  gamma over the head dim becomes `pt.sdpa_rms_epilogue`, which calls
  `flash_attention_rms_epilogue_bshd` (K2) where the router's ledger
  marks the fused epilogue a winner at the shape (`epilogue_fusion_wins`)
  and no gradient is wanted (K2 is forward only); elsewhere it replays
  the region.

Constraint discipline: a pattern fires only when it can prove the
structure. The mask must be a constant (the fold pass runs first and turns
`ones(...).tril()` into one) equal to the bottom-right causal mask, with a
fill at or below -1e9; a padding-style mask is never claimed causal. The
index structure of every layout chain is proven exactly by replaying it on
integer labels: each element of q, k, v and of the two products is tagged
with its flat index, the chain's layout ops move the tags as they move the
data (casts and the elementwise scale and mask leave them in place), and
the tags that reach each product must be exactly the ones attention
reads: Q[b, i, h, :] against K[b, :, h // (H / KVH), :] per batch-head,
the scores' last two dims the (query, key) positions, P against
V[b, :, h // (H / KVH), :], and the output back in (b, i, h, :) order.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from ..framework import flags as _flags
from .ir import Operation, Program, Ref
from .passes import Pass, PassResult

__all__ = ["RewritePattern", "PatternRewriter", "SdpaRoutePattern",
           "RmsEpiloguePattern", "region_replay"]

# ops that move elements without changing them (casts included): the
# matcher walks through them and the label proofs replay them
_LAYOUT = frozenset({"view", "_unsafe_view", "reshape", "permute",
                     "transpose", "t", "unsqueeze", "squeeze", "expand",
                     "clone", "contiguous", "_to_copy", "alias", "detach",
                     "_reshape_alias"})
_CASTS = frozenset({"_to_copy"})
_FILL_LIMIT = -1e9


def _pname(op) -> Optional[str]:
    """The overload packet name of a captured op ("bmm"), None for pt ops."""
    return op.target.overloadpacket.__name__ if op.target is not None \
        else None


def region_replay(prog, region_ops, boundary_in, out_value):
    """A callable replaying `region_ops` from the boundary values: the
    pt op's exact fallback. Ops run in program order; constants are
    snapshotted now (a later DCE of the originals must not break it)."""
    rid = set(map(id, region_ops))
    ordered = [op for op in prog.ops if id(op) in rid]
    const_env = {id(v): c for v, c in prog.constants.items()}

    def replay(*args):
        env = dict(const_env)
        for v, a in zip(boundary_in, args):
            env[id(v)] = a
        for op in ordered:
            for v, o in zip(op.outputs,
                            op.evaluate([env[id(v)] for v in op.inputs])):
                env[id(v)] = o
        return env[id(out_value)]

    used = {id(v) for op in ordered for v in op.inputs}
    replay.body = (list(boundary_in), ordered, [out_value],
                   {v: c for v, c in prog.constants.items()
                    if id(v) in used})
    return replay


class RewritePattern:
    name = "pattern"

    def match(self, prog: Program, op: Operation, users: dict):
        raise NotImplementedError

    def rewrite(self, prog: Program, m: dict) -> Operation:
        raise NotImplementedError


# --------------------------------------------------------------------------
# matching helpers
# --------------------------------------------------------------------------

def _const(prog, v):
    return prog.constants.get(v)


def _arg(op, i, default=None):
    args = op.spec[0]
    return args[i] if i < len(args) else default


def _scalar(prog, op, a):
    """A Python number argument, or a 0-d constant operand, as float;
    None otherwise."""
    if isinstance(a, Ref):
        c = _const(prog, op.inputs[a.i])
        if c is not None and c.dim() == 0:
            return float(c)
        return None
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return float(a)
    return None


def _sole_user(users, v):
    us = users.get(v, [])
    return us[0] if len(us) == 1 and us[0] is not None else None


def _layout_chain_up(v):
    """[(value, ops-below-it)] walking up from `v` through single-tensor
    layout ops: each entry is a candidate anchor and the chain ops between
    it and `v` (program order)."""
    out = [(v, [])]
    ops: list = []
    while v.op is not None and _pname(v.op) in _LAYOUT \
            and len(v.op.inputs) == 1:
        ops = [v.op] + ops
        v = v.op.inputs[0]
        out.append((v, list(ops)))
    return out


def _replay_labels(chain_ops, start, labels):
    """Labels at the end of `chain_ops` given `labels` at `start`: layout
    ops replay on the label tensor, casts and the elementwise ops of a
    score chain (a scale, a mask) leave the labels in place. Returns
    {id(Value): labels} for every value along the chain."""
    env = {id(start): labels}
    cur = start
    for op in chain_ops:
        main = next(v for v in op.inputs if id(v) in env)
        if _pname(op) in _LAYOUT and _pname(op) not in _CASTS:
            lab = op.evaluate([env[id(main)]])[0]
        else:
            lab = env[id(main)]
        env[id(op.outputs[0])] = lab
        cur = op.outputs[0]
    return env, cur


def _labels(shape, device):
    n = 1
    for s in shape:
        n *= s
    dt = torch.int32 if n < 2 ** 31 else torch.int64
    return torch.arange(n, dtype=dt, device=device).view(shape)


def _ar(n, device, dt):
    return torch.arange(n, device=device, dtype=dt)


def _rows_cols_ok(lab, rows, cols, stride_r, stride_c, base_mod):
    """lab[..., r, c] == base[...] + r * stride_r + c * stride_c with
    base[...] = lab[..., 0, 0] a multiple of base_mod. Returns base (the
    leading-index labels) or None."""
    if tuple(lab.shape[-2:]) != (rows, cols):
        return None
    base = lab[..., :1, :1]
    if bool((base % base_mod != 0).any()):
        return None
    want = (base + _ar(rows, lab.device, lab.dtype)[:, None] * stride_r
            + _ar(cols, lab.device, lab.dtype)[None, :] * stride_c)
    if not torch.equal(lab, want):
        return None
    return base[..., 0, 0]


def _on_cuda(v) -> bool:
    return v.device is not None and v.device.type == "cuda"


def _region_closed(users, region_ops, outs_allowed):
    """Every value produced inside the region is consumed only inside it,
    except the designated outputs."""
    rid = set(map(id, region_ops))
    allowed = set(map(id, outs_allowed))
    for op in region_ops:
        for o in op.outputs:
            if id(o) in allowed:
                continue
            for u in users.get(o, []):
                if u is None or id(u) not in rid:
                    return False
    return True


# --------------------------------------------------------------------------
# sdpa -> the routed attention backend
# --------------------------------------------------------------------------

def _score_chain(prog, s_in):
    """Walk up from the softmax input to the QK bmm through layout ops, a
    scalar scale and at most one constant mask. Returns (bmm, chain ops in
    program order, scale, mask info) or None. mask info: (op, mask const
    (True where the score is kept), fill value)."""
    chain: list = []
    scale = 1.0
    mask = None
    v = s_in
    while v.op is not None:
        op, name = v.op, _pname(v.op)
        if name == "bmm":
            return op, chain, scale, mask
        args = op.spec[0] if op.target is not None else ()
        if name in _LAYOUT and len(op.inputs) == 1:
            nxt = op.inputs[0]
        elif name in ("mul", "div") and len(op.inputs) >= 1:
            live = [x for x in op.inputs if _const(prog, x) is None]
            if len(live) != 1 or not isinstance(args[0], Ref) \
                    or op.inputs[args[0].i] is not live[0]:
                return None
            s = _scalar(prog, op, args[1])
            if s is None or s == 0.0:
                return None
            scale *= s if name == "mul" else 1.0 / s
            nxt = live[0]
        elif name == "masked_fill" and mask is None:
            if not (isinstance(args[0], Ref) and isinstance(args[1], Ref)):
                return None
            m = _const(prog, op.inputs[args[1].i])
            fill = _scalar(prog, op, args[2])
            if m is None or m.dtype != torch.bool or fill is None \
                    or fill > _FILL_LIMIT:
                return None
            mask = (op, ~m, fill)
            nxt = op.inputs[args[0].i]
        elif name == "where" and mask is None and len(args) == 3:
            cond = _const(prog, op.inputs[args[0].i]) \
                if isinstance(args[0], Ref) else None
            if cond is None or cond.dtype != torch.bool:
                return None
            f1, f2 = _scalar(prog, op, args[1]), _scalar(prog, op, args[2])
            if f2 is not None and f2 <= _FILL_LIMIT \
                    and isinstance(args[1], Ref):
                mask, nxt = (op, cond, f2), op.inputs[args[1].i]
            elif f1 is not None and f1 <= _FILL_LIMIT \
                    and isinstance(args[2], Ref):
                mask, nxt = (op, ~cond, f1), op.inputs[args[2].i]
            else:
                return None
        else:
            return None
        chain.insert(0, op)
        v = nxt
    return None


def _causal_mask_ok(keep, lab_at_mask, sq, sk):
    """The constant `keep` mask is exactly the bottom-right causal mask
    over (query, key) positions, and the masked tensor's last two dims are
    those positions (proven by its labels)."""
    if keep.dim() < 2 or any(s != 1 for s in keep.shape[:-2]) \
            or tuple(keep.shape[-2:]) != (sq, sk):
        return False
    if _rows_cols_ok(lab_at_mask, sq, sk, sk, 1, sq * sk) is None:
        return False
    want = torch.ones(sq, sk, dtype=torch.bool,
                      device=keep.device).tril(sk - sq)
    return torch.equal(keep.reshape(sq, sk), want)


class SdpaRoutePattern(RewritePattern):
    name = "sdpa_route"

    def match(self, prog, op, users):
        if _pname(op) != "_softmax" or len(op.inputs) != 1:
            return None
        s_in = op.inputs[0]
        nd = len(s_in.shape)
        dim = _arg(op, 1)
        if nd < 3 or not isinstance(dim, int) or dim % nd != nd - 1 \
                or _arg(op, 2) is not False:
            return None
        got = _score_chain(prog, s_in)
        if got is None:
            return None
        qk, s_chain, scale, mask = got
        a_val, b_val = qk.inputs[0], qk.inputs[1]
        if len(qk.inputs) != 2 or len(a_val.shape) != 3:
            return None
        g, sq, d = a_val.shape
        sk = b_val.shape[2]
        if b_val.shape != (g, d, sk):
            return None
        dev = a_val.device if _on_cuda(a_val) else torch.device("cpu")

        # the probabilities down to the PV bmm
        p_chain: list = []
        pv_in = op.outputs[0]
        u = _sole_user(users, pv_in)
        while u is not None and _pname(u) in _LAYOUT \
                and len(u.inputs) == 1:
            p_chain.append(u)
            pv_in = u.outputs[0]
            u = _sole_user(users, pv_in)
        if u is None or _pname(u) != "bmm":
            return None
        pv = u
        p_lhs = pv.inputs[0] is pv_in
        if not p_lhs and pv.inputs[1] is not pv_in:
            return None
        y_val = pv.inputs[1] if p_lhs else pv.inputs[0]

        # labels of the QK product through the score chain
        lab1 = _labels((g, sq, sk), dev)
        s_env, s_end = _replay_labels(s_chain, qk.outputs[0], lab1)
        if s_end is not s_in:
            return None
        lead = _rows_cols_ok(s_env[id(s_in)], sq, sk, sk, 1, sq * sk)
        if lead is None:
            return None
        causal = False
        if mask is not None:
            mop, keep, _fill = mask
            at = next(x for x in mop.inputs if id(x) in s_env)
            if not _causal_mask_ok(keep, s_env[id(at)], sq, sk):
                return None
            causal = True
        # the probabilities into the PV product
        p_env, p_end = _replay_labels(p_chain, op.outputs[0],
                                      s_env[id(s_in)])
        lx = p_env[id(pv_in)]
        if p_lhs:
            g_of_g2 = _rows_cols_ok(lx, sq, sk, sk, 1, sq * sk)
        else:
            g_of_g2 = _rows_cols_ok(lx, sk, sq, 1, sk, sq * sk)
        if g_of_g2 is None or g_of_g2.dim() != 1:
            return None
        g_of_g2 = g_of_g2 // (sq * sk)
        g2 = g_of_g2.shape[0]
        dv = y_val.shape[2] if p_lhs else y_val.shape[1]

        for q_cand, q_ops in reversed(_layout_chain_up(a_val)):
            qm = self._q_map(q_cand, q_ops, a_val, g, sq, d, dev)
            if qm is None:
                continue
            b, h, gb, gh = qm
            for k_cand, k_ops in reversed(_layout_chain_up(b_val)):
                if not self._k_ok(k_cand, k_ops, b_val, b, h, sk, d, gb,
                                  gh, dev):
                    continue
                hk = k_cand.shape[2]
                for v_cand, v_ops in reversed(_layout_chain_up(y_val)):
                    if not self._v_ok(v_cand, v_ops, y_val, b, h, hk, sk,
                                      dv, gb[g_of_g2], gh[g_of_g2],
                                      p_lhs, dev):
                        continue
                    outs = self._out_candidates(pv, users, b, sq, h, dv,
                                                gb[g_of_g2], gh[g_of_g2],
                                                p_lhs, dev)
                    for out_val, o_ops in outs:
                        region = list({id(x): x for x in itertools.chain(
                            q_ops, k_ops, [qk], s_chain, [op], p_chain,
                            v_ops, [pv], o_ops)}.values())
                        if _region_closed(users, region, [out_val]):
                            return {"region": region, "q": q_cand,
                                    "k": k_cand, "v": v_cand,
                                    "out": out_val, "causal": causal,
                                    "scale": scale,
                                    "shape": (b, sq, sk, h, d)}
        return None

    @staticmethod
    def _q_map(q, ops, a_val, g, sq, d, dev):
        """q (b, sq, h, d) reaching A [b*h, sq, d] row-for-row: returns
        (b, h, batch of each g, head of each g) or None."""
        if len(q.shape) != 4 or q.shape[1] != sq or q.shape[3] != d:
            return None
        b, _, h, _ = q.shape
        if b * h != g:
            return None
        env, end = _replay_labels(ops, q, _labels(q.shape, dev))
        if end is not a_val:
            return None
        base = _rows_cols_ok(env[id(a_val)], sq, d, h * d, 1, d)
        if base is None:
            return None
        gb = base // (sq * h * d)
        gh = (base // d) % h
        if torch.unique(gb * h + gh).numel() != g:
            return None
        return b, h, gb.long(), gh.long()

    @staticmethod
    def _k_ok(k, ops, b_val, b, h, sk, d, gb, gh, dev):
        """k (b, sk, kvh, d) reaching B [b*h, d, sk] transposed, batch-head
        g reading kv head gh // (h / kvh) of batch gb."""
        if len(k.shape) != 4 or k.shape[0] != b or k.shape[1] != sk \
                or k.shape[3] != d or h % k.shape[2]:
            return False
        hk = k.shape[2]
        env, end = _replay_labels(ops, k, _labels(k.shape, dev))
        if end is not b_val:
            return False
        lab = env[id(b_val)]
        kbase = (gb * sk * hk * d + (gh // (h // hk)) * d).to(lab.dtype)
        want = (kbase[:, None, None] + _ar(d, dev, lab.dtype)[None, :, None]
                + _ar(sk, dev, lab.dtype)[None, None, :] * (hk * d))
        return torch.equal(lab, want)

    @staticmethod
    def _v_ok(v, ops, y_val, b, h, hk, sk, dv, gb2, gh2, p_lhs, dev):
        """v (b, sk, kvh, dv) reaching the PV product's other operand:
        [G2, sk, dv] when P is its lhs, [G2, dv, sk] when P is its rhs."""
        if len(v.shape) != 4 or v.shape != (b, sk, hk, dv):
            return False
        env, end = _replay_labels(ops, v, _labels(v.shape, dev))
        if end is not y_val:
            return False
        lab = env[id(y_val)]
        vbase = (gb2 * sk * hk * dv + (gh2 // (h // hk)) * dv).to(lab.dtype)
        j = _ar(sk, dev, lab.dtype) * (hk * dv)
        c = _ar(dv, dev, lab.dtype)
        if p_lhs:
            want = vbase[:, None, None] + j[None, :, None] + c[None, None, :]
        else:
            want = vbase[:, None, None] + c[None, :, None] + j[None, None, :]
        return lab.shape == want.shape and torch.equal(lab, want)

    @staticmethod
    def _out_candidates(pv, users, b, sq, h, dv, gb2, gh2, p_lhs, dev):
        """[(out value (b, sq, h, dv), chain ops)] down from the PV product
        through layout ops whose labels put each product element at its
        (batch, query, head, channel) place."""
        g2 = gb2.shape[0]
        shape = tuple(pv.outputs[0].shape)
        want_shape = (g2, sq, dv) if p_lhs else (g2, dv, sq)
        if shape != want_shape:
            return []
        lab = _labels(shape, dev)
        inv = torch.empty(b * h, dtype=lab.dtype, device=dev)
        inv[gb2 * h + gh2] = _ar(g2, dev, lab.dtype)
        inv = inv.view(b, h)
        i = _ar(sq, dev, lab.dtype)
        c = _ar(dv, dev, lab.dtype)
        if p_lhs:
            want = (inv[:, None, :, None] * (sq * dv)
                    + i[None, :, None, None] * dv + c[None, None, None, :])
        else:
            want = (inv[:, None, :, None] * (dv * sq)
                    + c[None, None, None, :] * sq + i[None, :, None, None])
        found = []
        ops: list = []
        v = pv.outputs[0]
        while True:
            u = _sole_user(users, v)
            if u is None or _pname(u) not in _LAYOUT or len(u.inputs) != 1:
                break
            ops.append(u)
            v = u.outputs[0]
            if v.shape == (b, sq, h, dv):
                env, _ = _replay_labels(ops, pv.outputs[0], lab)
                if torch.equal(env[id(v)], want):
                    found.append((v, list(ops)))
        return found

    def rewrite(self, prog, m):
        b, sq, sk, h, d = m["shape"]
        q, k, v, out = m["q"], m["k"], m["v"], m["out"]
        causal, scale = m["causal"], m["scale"]
        route_fwd, source = _route(b, sq, h, d, q, causal)
        replay = region_replay(prog, m["region"], [q, k, v], out)
        attrs = {"causal": causal, "scale": scale, "route_fwd": route_fwd,
                 "route_source": source, "shape": (b, sq, sk, h, d),
                 "out_dtype": out.dtype}
        new_op = Operation("pt.sdpa", [q, k, v], [out], attrs=attrs,
                           fn=make_sdpa_fn(attrs, replay))
        prog.replace_region(m["region"], new_op)
        return new_op


def _route(b, sq, h, d, q, causal):
    """(route_fwd, source) for a pt.sdpa at this shape: the decision eager
    attention makes (`nn.functional.attention._use_pallas`: the tensor's
    device, the kernels' dtypes and head dims, FLAGS_flash_attention_backend
    and, under 'auto', ops/attention_router), so a program takes K1 exactly
    where the eager layer would. A router error propagates."""
    from ..nn.functional.attention import _use_pallas
    flash = _use_pallas((b, sq, h, d), d, False, dtype=q.dtype,
                        causal=causal, device=q.device)
    backend = _flags.flag_value("flash_attention_backend")
    return ("flash" if flash else "replay"), f"backend={backend}"


def make_sdpa_fn(attrs, replay):
    """pt.sdpa's callable: K1 (flash_attention_bshd, K3/K4 backward) on
    CUDA tensors where routed, else the exact region replay."""
    causal, scale = attrs["causal"], attrs["scale"]
    out_dtype = attrs["out_dtype"]
    flash = attrs["route_fwd"] == "flash"

    def sdpa(q_, k_, v_):
        if flash and q_.is_cuda:
            from ..ops.flash_attention import flash_attention_bshd
            return flash_attention_bshd(q_, k_, v_, causal=causal,
                                        scale=scale).to(out_dtype)
        return replay(q_, k_, v_)

    sdpa.body = replay.body
    return sdpa


# --------------------------------------------------------------------------
# rmsnorm(sdpa + residual) * gamma -> the fused epilogue
# --------------------------------------------------------------------------

class RmsEpiloguePattern(RewritePattern):
    """Anchors on a `pt.sdpa` produced by SdpaRoutePattern (pattern over
    pattern: result ops are legal source ops)."""

    name = "rms_epilogue"

    def match(self, prog, op, users):
        if op.name != "pt.sdpa":
            return None
        att = op.outputs[0]
        add = _sole_user(users, att)
        if add is None or _pname(add) != "add" or len(add.inputs) != 2 \
                or _scalar(prog, add, _arg(add, 2, 1)) not in (None, 1.0):
            return None
        residual = add.inputs[1] if add.inputs[0] is att else add.inputs[0]
        if residual.shape != att.shape:
            return None
        region = [op, add]
        hh = add.outputs[0]
        cv = _sole_user(users, hh)
        if cv is not None and _pname(cv) in _CASTS:
            region.append(cv)
            hh = cv.outputs[0]
        if None in users.get(hh, []):
            return None
        hh_users = list({id(u): u for u in users.get(hh, [])}.values())
        if len(hh_users) != 2:
            return None
        sq_op = next((u for u in hh_users if _pname(u) == "mul"
                      and u.inputs == [hh, hh]), None)
        if sq_op is None:
            sq_op = next((u for u in hh_users if _pname(u) == "pow"
                          and _scalar(prog, u, _arg(u, 1)) == 2.0), None)
        if sq_op is None:
            return None
        region.append(sq_op)
        d = hh.shape[-1]
        red = _sole_user(users, sq_op.outputs[0])
        if red is None or _pname(red) not in ("mean", "sum"):
            return None
        dims = _arg(red, 1)
        if not isinstance(dims, (list, tuple)) or len(dims) != 1 \
                or dims[0] % len(hh.shape) != len(hh.shape) - 1 \
                or _arg(red, 2) is not True:
            return None               # the norm axis must be the head dim
        region.append(red)
        saw_mean = _pname(red) == "mean"
        eps = None
        cur = _sole_user(users, red.outputs[0])
        while cur is not None and _pname(cur) in ("div", "mul", "add"):
            s = _scalar(prog, cur, _arg(cur, 1))
            if s is None or not isinstance(_arg(cur, 0), Ref):
                return None
            if _pname(cur) == "div" and abs(s - d) < 0.5 and not saw_mean:
                saw_mean = True
            elif _pname(cur) == "mul" and abs(s - 1.0 / d) < 1e-12 \
                    and not saw_mean:
                saw_mean = True
            elif _pname(cur) == "add" and eps is None:
                eps = s
            else:
                return None
            region.append(cur)
            cur = _sole_user(users, cur.outputs[0])
        if cur is None or _pname(cur) != "rsqrt" or not saw_mean \
                or eps is None:
            return None
        region.append(cur)
        norm = _sole_user(users, cur.outputs[0])
        if norm is None or _pname(norm) != "mul" \
                or hh not in norm.inputs:
            return None
        region.append(norm)
        wmul = _sole_user(users, norm.outputs[0])
        if wmul is None or _pname(wmul) != "mul":
            return None
        wside = (wmul.inputs[1] if wmul.inputs[0] is norm.outputs[0]
                 else wmul.inputs[0])
        w_chain = _layout_chain_up(wside)
        w_val, w_ops = w_chain[-1]
        if len(w_val.shape) != 1 or w_val.shape[0] != d:
            return None
        region += w_ops + [wmul]
        out_val = wmul.outputs[0]
        u = _sole_user(users, out_val)
        if u is not None and _pname(u) in _CASTS:
            region.append(u)
            out_val = u.outputs[0]
        if not _region_closed(users, region, [out_val]):
            return None
        return {"region": region, "q": op.inputs[0], "k": op.inputs[1],
                "v": op.inputs[2], "residual": residual, "w": w_val,
                "out": out_val, "eps": eps, "sdpa": op}

    def rewrite(self, prog, m):
        sdpa = m["sdpa"]
        b, sq, sk, h, d = sdpa.attrs["shape"]
        q = m["q"]
        fused = "replay"
        if sdpa.attrs["route_fwd"] == "flash":
            from ..ops.attention_router import epilogue_fusion_wins
            if epilogue_fusion_wins(b * h, sq, sk, d, q.dtype,
                                    sdpa.attrs["causal"]):
                fused = "flash"
        attrs = {"causal": sdpa.attrs["causal"],
                 "scale": sdpa.attrs["scale"], "eps": m["eps"],
                 "route_fwd": fused,
                 "route_source": sdpa.attrs["route_source"],
                 "shape": (b, sq, sk, h, d), "out_dtype": m["out"].dtype}
        boundary = [q, m["k"], m["v"], m["residual"], m["w"]]
        replay = region_replay(prog, m["region"], boundary, m["out"])
        new_op = Operation("pt.sdpa_rms_epilogue", boundary, [m["out"]],
                           attrs=attrs, fn=make_epilogue_fn(attrs, replay))
        prog.replace_region(m["region"], new_op)
        return new_op


def make_epilogue_fn(attrs, replay):
    """pt.sdpa_rms_epilogue's callable: K2 on CUDA tensors where routed
    and no gradient is wanted (K2 is forward only), else the replay."""
    causal, scale, eps = attrs["causal"], attrs["scale"], attrs["eps"]
    out_dtype = attrs["out_dtype"]
    fused = attrs["route_fwd"] == "flash"

    def sdpa_rms_epilogue(q_, k_, v_, res_, w_):
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_, k_, v_, res_, w_))
        if fused and q_.is_cuda and not grad and res_.dtype == q_.dtype:
            from ..ops.flash_attention import \
                flash_attention_rms_epilogue_bshd
            return flash_attention_rms_epilogue_bshd(
                q_, k_, v_, res_, w_, causal=causal, scale=scale,
                eps=eps).to(out_dtype)
        return replay(q_, k_, v_, res_, w_)

    sdpa_rms_epilogue.body = replay.body
    return sdpa_rms_epilogue


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------

_MAX_REWRITES = 256


class PatternRewriter(Pass):
    """Apply the patterns to fixpoint (bounded). Each rewrite is one edit;
    per-pattern counts go in the notes ("no-match" when none fired)."""

    name = "pattern"

    def __init__(self, patterns: Optional[list] = None):
        self.patterns = (list(patterns) if patterns is not None
                         else [SdpaRoutePattern(), RmsEpiloguePattern()])

    def run(self, prog: Program) -> PassResult:
        counts: dict[str, int] = {}
        total = 0
        from .passes import mutated_storage
        for pat in self.patterns:
            users, touches = prog.users(), mutated_storage(prog)
            i = 0
            while i < len(prog.ops) and total < _MAX_REWRITES:
                m = pat.match(prog, prog.ops[i], users)
                if m is None or any(touches(op) for op in m["region"]
                                    if op.target is not None):
                    i += 1
                    continue
                new_op = pat.rewrite(prog, m)
                counts[pat.name] = counts.get(pat.name, 0) + 1
                total += 1
                users, touches = prog.users(), mutated_storage(prog)
                i = prog.ops.index(new_op) + 1
        notes = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        return PassResult(total, notes or "no-match")
