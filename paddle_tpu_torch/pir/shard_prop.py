"""GSPMD-style sharding propagation over pir programs.

reference: paddle_tpu/pir/shard_prop.py (GSPMD, arXiv:2105.04663, and the
SNIPPETS.md `match_partition_rules` idiom). The user annotates program
inputs sparsely (regex rules over the argument tree's paths, as
parallel/spmd.py's rule tables do); this pass pushes `Value.sharding`
forward and backward through the dataflow to a fixpoint. Where operand
annotations legitimately diverge (a contracting product, a permute, two
user annotations meeting at an add) it derives the op's result sharding
or resolves the conflict by the CostModel's reshard price, stamps the op
with an `attrs["sharding_rule"]` contract, and the consistency analysis
(analysis.ShardingConsistency, the verifier's sharding-conflict rule) then
checks the assignment. Interior annotations the pass did not derive are
never resolved away.

The derivation rules are the reference's, over the aten ops a captured
port program holds:

* the products: `mm`, `bmm`, `addmm` and `baddbmm` (the bias is operand 0
  and broadcasts to the result) for the reference's `dot_general`;
* `permute`, `t` and `transpose.int` for `transpose`; `expand` for
  `broadcast_in_dim`;
* `sum`, `mean`, `amax` and `amin` over dims for the rank-dropping
  `reduce_*` (with keepdim the reduced dims stay, unsharded);
* `pt.sdpa`/`pt.sdpa_rms_epilogue`: a batch- or head-sharded q/k/v (b, s,
  h, d) maps onto the result's batch and head dims;
* `view`/`_unsafe_view`/`reshape`/`squeeze`/`unsqueeze`: make_fx lowers
  `x @ w` for a 3-d `x` to view + mm + view, where the reference's
  dot_general takes the 3-d operand as it is, so a dim whose size survives
  a view keeps its spec (a merged group keeps its outermost non-trivial
  dim's spec if the others are unsharded; a split dim gives its spec to
  the outermost new dim);
* `pt.fused_region`: derived through its member ops;
* the join rule for the rest: annotated operands agree (or are resolved)
  and every result of their shape, or of the joined rank, inherits. A
  pointwise op's operands that broadcast to its result are joined
  right-aligned (analysis.join_broadcast): aten broadcasts inside `add`
  and `mul`, where the reference's jaxpr spells the broadcast out.

Replay on one card: `apply_constraint` is a hint and never a change of
numerics (reference :208-225). The reference re-asserts every annotated
value through `with_sharding_constraint`; the port's meshes are logical
(their process ids lie on the one card: distributed/placement.py), so
there is nothing to redistribute. The replay hook stays where the
reference has it (ir.py `_constrained`), called for the tensors the
program returns: each gets the DTensor marks (`process_mesh`,
`placements`) of its spec. Interior values are left alone, so an
annotated program replays at the same host cost per op as an unannotated
one; placement over several cards (ROADMAP Queue 1 item 4) can put a real
redistribution in the hook.

Fixpoint bound: `MAX_SWEEPS` (8) forward and backward sweeps; facts are
monotone (a value is annotated once, never overwritten).
"""

from __future__ import annotations

import hashlib
import re
from contextlib import contextmanager
from typing import Optional

from torch.utils import _pytree as pytree

from .analysis import (CONFLICT, CostModel, FlatLattice, aligned_spec,
                       broadcast_result_shape, join_broadcast)
from .ir import Operation, Program, Ref
from .passes import Pass, PassResult

__all__ = ["ShardingPropagation", "mesh_scope", "current_mesh",
           "current_search", "match_partition_rules", "flat_input_specs",
           "annotate_inputs", "apply_constraint", "propagate_facts",
           "sharding_cache_tag", "MAX_SWEEPS"]

MAX_SWEEPS = 8

# the active mesh (a distributed.ProcessMesh) and the optional search
# space of pir/shard_search.py
_SCOPE: list = [None, None]


@contextmanager
def mesh_scope(mesh, search=None):
    """Activate a mesh for the pipeline: the propagation and search passes
    pick it up, and the pass pins it on the programs it annotates, whose
    evaluator replays under it. `search` optionally carries the strategy
    space of pir/shard_search.py: [(name, flat input specs)]."""
    prev = list(_SCOPE)
    _SCOPE[0], _SCOPE[1] = mesh, search
    try:
        yield mesh
    finally:
        _SCOPE[0], _SCOPE[1] = prev


def current_mesh():
    return _SCOPE[0]


def current_search():
    return _SCOPE[1]


# --------------------------------------------------------------------------
# the user annotation front door
# --------------------------------------------------------------------------

def _path_name(path) -> str:
    parts = []
    for p in path:
        key = getattr(p, "key", None)
        if key is None:
            key = getattr(p, "name", None)
        if key is None:
            key = getattr(p, "idx", None)
        parts.append(str(p) if key is None else str(key))
    return "/".join(parts)


def match_partition_rules(rules, tree, *, default="raise"):
    """The first rule whose regex `re.search`-matches the '/'-joined tree
    path wins; scalars replicate to (). Returns [(name, spec)] in
    tree_flatten leaf order; unmatched leaves get `default` (the
    exemplar's raise by default)."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        name = _path_name(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            out.append((name, ()))
            continue
        for pat, spec in rules:
            if re.search(pat, name):
                out.append((name, None if spec is None else tuple(spec)))
                break
        else:
            if default == "raise":
                raise ValueError(
                    f"no sharding rule matches param {name!r}")
            out.append((name, default))
    return out


def flat_input_specs(args, rules, *, default=None):
    """Specs in `tree_flatten(args)` leaf order, what compile_flat's
    `input_shardings=` takes; unmatched leaves get `default` (None:
    unannotated)."""
    return [spec for _, spec in
            match_partition_rules(rules, args, default=default)]


def annotate_inputs(prog: Program, specs) -> int:
    """Stamp sanitized specs on `prog.inputs` (None entries skip; the list
    may be shorter than the inputs). Returns the number annotated."""
    mesh_axes = _mesh_axis_sizes(current_mesh())
    n = 0
    for v, spec in zip(prog.inputs, specs):
        if spec is None:
            continue
        v.sharding = _sanitize(spec, v.shape, mesh_axes)
        n += 1
    return n


def sharding_cache_tag(specs) -> str:
    """Compile-cache key tag of an annotated compile: the input specs and
    the scope mesh's axis sizes (artifacts are never shared across
    meshes)."""
    mesh = current_mesh()
    axes = sorted(_mesh_axis_sizes(mesh).items()) if mesh else []
    text = repr([None if s is None else tuple(s) for s in specs]) \
        + repr(axes)
    return "spec:" + hashlib.sha256(text.encode()).hexdigest()[:16]


def _mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ProcessMesh, whose `shape` is a list beside
    `dim_names` (the reference reads a jax Mesh's shape mapping)."""
    if mesh is None:
        return {}
    return {str(k): int(v) for k, v in zip(mesh.dim_names, mesh.shape)}


# --------------------------------------------------------------------------
# spec plumbing
# --------------------------------------------------------------------------

def _pad(spec, ndim):
    if spec is None:
        return None
    spec = tuple(spec)[:ndim]
    return spec + (None,) * (ndim - len(spec))


def _sanitize(spec, shape, mesh_axes: Optional[dict] = None):
    """Full-rank spec with duplicate axes dropped and (when the mesh is
    known) axes that are absent or do not divide the dim dropped, as
    parallel/spmd.py's shard_params_by_rules does."""
    if spec is None:
        return None
    spec = _pad(spec, len(shape))
    seen: set = set()
    out = []
    for d, a in enumerate(spec):
        if a is None or a in seen:
            out.append(None)
            continue
        if mesh_axes:
            size = mesh_axes.get(a)
            if size is None or int(shape[d]) % int(size) != 0:
                out.append(None)
                continue
        seen.add(a)
        out.append(a)
    return tuple(out)


def _spec_str(spec) -> str:
    if spec is None:
        return "?"
    return "<" + ",".join("*" if a is None else str(a) for a in spec) + ">"


def apply_constraint(x, spec):
    """The replay hint for the active mesh scope: `x` with the DTensor
    marks of `spec` (each mesh axis that shards a dim is Shard(dim), the
    others Replicate()). Unknown or non-dividing axes are dropped, and any
    failure returns x unchanged: a hint never changes numerics or breaks
    a replay."""
    mesh = current_mesh()
    if mesh is None or spec is None:
        return x
    try:
        from ..distributed.api import _attach_dist
        from ..distributed.placement import Replicate, Shard
        clean = _sanitize(spec, tuple(x.shape), _mesh_axis_sizes(mesh))
        if clean is None:
            return x
        placements = [Shard(clean.index(a)) if a in clean else Replicate()
                      for a in mesh.dim_names]
        return _attach_dist(x, mesh, placements)
    except Exception:  # noqa: BLE001 — hints degrade, never break
        return x


# --------------------------------------------------------------------------
# per-op derivation rules (the decision half of GSPMD)
# --------------------------------------------------------------------------

_PRODUCTS = {
    # name: (operand index of lhs, of rhs, of the bias or None)
    "mm": (0, 1, None), "bmm": (0, 1, None),
    "addmm": (1, 2, 0), "baddbmm": (1, 2, 0),
}
_PERMUTES = ("permute", "t", "transpose")
_VIEWS = ("view", "_unsafe_view", "reshape", "squeeze", "unsqueeze")
_REDUCES = ("sum", "mean", "amax", "amin")


def _kind(op: Operation) -> str:
    if op.target is None:
        return op.name
    return op.target.overloadpacket.__name__


def _operand(op: Operation, k: int):
    """The Value of the op's k-th positional argument (None if it is not
    a tensor operand)."""
    args = op.spec[0]
    if k < len(args) and isinstance(args[k], Ref):
        return op.inputs[args[k].i]
    return None


def _dot_dims(op: Operation):
    """(lc, rc, lb, rb, lfree, rfree, lhs_nd, rhs_nd) of a product."""
    li, ri, _ = _PRODUCTS[_kind(op)]
    lhs, rhs = _operand(op, li), _operand(op, ri)
    lnd, rnd = len(lhs.shape), len(rhs.shape)
    if lnd == 3:                         # bmm / baddbmm
        lc, rc, lb, rb = (2,), (1,), (0,), (0,)
    else:
        lc, rc, lb, rb = (1,), (0,), (), ()
    lfree = [d for d in range(lnd) if d not in lc and d not in lb]
    rfree = [d for d in range(rnd) if d not in rc and d not in rb]
    return lc, rc, lb, rb, lfree, rfree, lnd, rnd


def _dot_forward(op, ls, rs):
    lc, rc, lb, rb, lfree, rfree, lnd, rnd = _dot_dims(op)
    ls = _pad(ls, lnd) or (None,) * lnd
    rs = _pad(rs, rnd) or (None,) * rnd
    out = [ls[bl] if ls[bl] is not None else rs[br]
           for bl, br in zip(lb, rb)]
    out += [ls[d] for d in lfree]
    out += [rs[d] for d in rfree]
    return tuple(out)


def _dot_backward(op, ospec):
    lc, rc, lb, rb, lfree, rfree, lnd, rnd = _dot_dims(op)
    nb = len(lb)
    ospec = _pad(ospec, nb + len(lfree) + len(rfree))
    ls: list = [None] * lnd
    rs: list = [None] * rnd
    for i, (bl, br) in enumerate(zip(lb, rb)):
        ls[bl] = rs[br] = ospec[i]
    for j, d in enumerate(lfree):
        ls[d] = ospec[nb + j]
    for j, d in enumerate(rfree):
        rs[d] = ospec[nb + len(lfree) + j]
    return tuple(ls), tuple(rs)


def dot_operands(op: Operation):
    """(lhs, rhs, contracting dims of lhs, of rhs) of a matrix-product op,
    or None: what shard_search.predict_seconds reads for the implied
    all-reduce of a sharded contraction."""
    if op.target is None or _kind(op) not in _PRODUCTS:
        return None
    li, ri, _ = _PRODUCTS[_kind(op)]
    lc, rc, *_ = _dot_dims(op)
    return _operand(op, li), _operand(op, ri), lc, rc


def _perm(op: Operation):
    """The permutation a permute/t/transpose applies (result dim i is
    operand dim perm[i])."""
    nd = len(op.inputs[0].shape)
    kind = _kind(op)
    if kind == "permute":
        return [int(d) % nd for d in op.spec[0][1]]
    perm = list(range(nd))
    if kind == "transpose":
        a, b = (int(d) % nd for d in op.spec[0][1:3])
        perm[a], perm[b] = perm[b], perm[a]
    elif nd == 2:                        # t
        perm = [1, 0]
    return perm


def _expand_dims(op: Operation):
    """For expand: [(operand dim, result dim)] of the dims the result
    keeps (the right-aligned dims whose size did not grow)."""
    ishape, oshape = op.inputs[0].shape, op.outputs[0].shape
    off = len(oshape) - len(ishape)
    return [(d, d + off) for d in range(len(ishape))
            if ishape[d] == oshape[d + off]]


def _reduce_axes(op: Operation):
    """(reduced dims, keepdim) of a single-input reduction over dims, or
    None."""
    if op.target is None or _kind(op) not in _REDUCES \
            or len(op.outputs) != 1:
        return None
    x = _operand(op, 0)
    if x is None:
        return None
    nd = len(x.shape)
    named = op.named_args()
    dims = named.get("dim")
    keep = bool(named.get("keepdim", False))
    if dims is None or dims == [] or dims == ():
        dims = range(nd)
    elif isinstance(dims, int):
        dims = [dims]
    axes = tuple(sorted({int(d) % nd for d in dims})) if nd else ()
    want = nd if keep else nd - len(axes)
    if len(op.outputs[0].shape) != want:
        return None
    return axes, keep


def _view_groups(src, dst):
    """[(src dims, dst dims)] pairing the dims of two shapes of one element
    count whose products agree, or None."""
    groups = []
    i = j = 0
    while i < len(src) or j < len(dst):
        gi, gj, pi, pj = [], [], 1, 1
        if i < len(src):
            gi.append(i)
            pi *= src[i]
            i += 1
        if j < len(dst):
            gj.append(j)
            pj *= dst[j]
            j += 1
        while pi != pj:
            if pi < pj and i < len(src):
                gi.append(i)
                pi *= src[i]
                i += 1
            elif pj < pi and j < len(dst):
                gj.append(j)
                pj *= dst[j]
                j += 1
            else:
                return None
        groups.append((gi, gj))
    return groups


def _view_map(spec, src, dst):
    """`spec` of shape `src` carried through a view to shape `dst`."""
    groups = _view_groups(src, dst)
    if groups is None:
        return None
    spec = _pad(spec, len(src))
    out: list = [None] * len(dst)
    for gi, gj in groups:
        big_i = [d for d in gi if src[d] != 1]
        big_j = [d for d in gj if dst[d] != 1]
        if not big_i or not big_j:
            continue
        if len(big_i) > 1 and len(big_j) > 1:
            continue                      # many to many: unknown
        if any(spec[d] is not None for d in big_i[1:]):
            continue                      # an inner merged dim is sharded
        out[big_j[0]] = spec[big_i[0]]
    return tuple(out)


def _region(op: Operation):
    """The member ops of a pt.fused_region, or None."""
    if op.name != "pt.fused_region":
        return None
    body = getattr(op.fn, "body", None)
    return None if body is None else body[1]


def _sdpa_forward(op, s):
    """q/k/v (b, s, h, d) spec -> the result's: batch and head only."""
    s = _pad(s, 4)
    o = op.outputs[0].shape
    if op.name == "pt.sdpa" and len(o) == 4:
        return (s[0], None, s[2], None)
    return (s[0],) + (None,) * (len(o) - 1)


def _sdpa_backward(op, o):
    o = _pad(o, len(op.outputs[0].shape))
    head = o[2] if op.name == "pt.sdpa" and len(o) == 4 else None
    return [(o[0], None, head, None) if len(v.shape) == 4 else None
            for v in op.inputs[:3]] + [None] * (len(op.inputs) - 3)


class _Deriver:
    """Forward/backward per-op spec derivation with CostModel conflict
    resolution, pure over a facts dict keyed by id(Value): the search
    pass prices candidate strategies through it without touching the
    program."""

    def __init__(self, cost_model: Optional[CostModel] = None):
        self.cost = cost_model or CostModel()
        self.lattice = FlatLattice()
        self.resolved: list = []

    def _resolve(self, op: Operation, annotated, shape=None):
        """The clashing operand spec with the cheapest reshard (bytes of
        the operands that would move to agree), ties broken textually.
        With `shape`, the specs are right-aligned to it first."""
        if shape is not None:
            annotated = [(v, aligned_spec(s, v.shape, shape)[0])
                         for v, s in annotated]
        candidates = sorted({spec for _, spec in annotated}, key=repr)

        def reshard_bytes(c):
            return sum(CostModel._value_bytes([v])
                       for v, s in annotated if s != c)
        win = min(candidates, key=lambda c: (reshard_bytes(c), repr(c)))
        self.resolved.append((op, win))
        return win

    def join(self, op: Operation, annotated, resolve=True):
        """The joined spec of [(Value, spec)] operands of `op` (right-
        aligned where a pointwise op broadcasts), CONFLICT resolved by
        price unless `resolve` is False."""
        bshape = broadcast_result_shape(op)
        if bshape is not None:
            joined = join_broadcast(annotated, bshape)
        else:
            joined = None
            for _, s in annotated:
                joined = self.lattice.join(joined, s)
        if joined is CONFLICT and resolve:
            joined = self._resolve(op, annotated, bshape)
        return joined

    def forward(self, op: Operation, facts: dict) -> bool:
        if all(facts.get(id(o)) is not None for o in op.outputs):
            return False
        kind = _kind(op)
        specs = None
        if op.target is not None and kind in _PRODUCTS:
            li, ri, bi = _PRODUCTS[kind]
            ls = facts.get(id(_operand(op, li)))
            rs = facts.get(id(_operand(op, ri)))
            if ls is not None or rs is not None:
                specs = [_dot_forward(op, ls, rs)]
            elif bi is not None and facts.get(id(_operand(op, bi))):
                b = _operand(op, bi)
                specs = [aligned_spec(facts[id(b)], b.shape,
                                      op.outputs[0].shape)[0]]
        elif op.target is not None and kind in _PERMUTES:
            s = facts.get(id(op.inputs[0]))
            if s is not None:
                s = _pad(s, len(op.inputs[0].shape))
                specs = [tuple(s[p] for p in _perm(op))]
        elif op.target is not None and kind == "expand":
            s = facts.get(id(op.inputs[0]))
            if s is not None:
                s = _pad(s, len(op.inputs[0].shape))
                out: list = [None] * len(op.outputs[0].shape)
                for d, od in _expand_dims(op):
                    out[od] = s[d]
                specs = [tuple(out)]
        elif op.target is not None and kind in _VIEWS:
            s = facts.get(id(op.inputs[0]))
            if s is not None:
                m = _view_map(s, op.inputs[0].shape, op.outputs[0].shape)
                specs = None if m is None else [m]
        elif _reduce_axes(op) is not None:
            s = facts.get(id(op.inputs[0]))
            if s is not None:
                axes, keep = _reduce_axes(op)
                s = _pad(s, len(op.inputs[0].shape))
                specs = [tuple(None if d in axes else a
                               for d, a in enumerate(s)) if keep else
                         tuple(a for d, a in enumerate(s) if d not in axes)]
        elif op.name.startswith("pt.sdpa"):
            s = facts.get(id(op.inputs[0]))
            if s is not None:
                specs = [_sdpa_forward(op, s)]
        elif _region(op) is not None:
            # a fused region is its members: derive through them (they
            # share the region's boundary and result Values)
            changed = False
            for sub in _region(op):
                changed |= self.forward(sub, facts)
            return changed
        else:
            annotated = [(v, facts[id(v)]) for v in op.inputs
                         if facts.get(id(v)) is not None]
            if annotated:
                joined = self.join(op, annotated)
                in_shapes = {tuple(v.shape) for v, _ in annotated}
                specs = [joined if tuple(o.shape) in in_shapes
                         or len(joined) == len(o.shape) else None
                         for o in op.outputs]
        if specs is None:
            return False
        if len(specs) == 1 and len(op.outputs) > 1:
            specs = specs * len(op.outputs)
        changed = False
        for o, s in zip(op.outputs, specs):
            if s is None or facts.get(id(o)) is not None:
                continue
            facts[id(o)] = _sanitize(s, o.shape)
            changed = True
        return changed

    def backward(self, op: Operation, facts: dict) -> bool:
        outs = [facts.get(id(o)) for o in op.outputs]
        if all(s is None for s in outs):
            return False
        kind = _kind(op)
        o0 = outs[0]
        ins = None
        if op.target is not None and kind in _PRODUCTS:
            if o0 is not None:
                li, ri, bi = _PRODUCTS[kind]
                ls, rs = _dot_backward(op, o0)
                by_pos = {li: ls, ri: rs}
                if bi is not None:
                    b = _operand(op, bi)
                    by_pos[bi] = _unalign(o0, b.shape, op.outputs[0].shape)
                ins = [None] * len(op.inputs)
                for pos, s in by_pos.items():
                    v = _operand(op, pos)
                    if v is not None:
                        ins[op.inputs.index(v)] = s
        elif op.target is not None and kind in _PERMUTES:
            if o0 is not None:
                perm = _perm(op)
                s = _pad(o0, len(op.outputs[0].shape))
                inv: list = [None] * len(perm)
                for i, p in enumerate(perm):
                    inv[p] = s[i]
                ins = [tuple(inv)]
        elif op.target is not None and kind == "expand":
            if o0 is not None:
                s = _pad(o0, len(op.outputs[0].shape))
                inv = [None] * len(op.inputs[0].shape)
                for d, od in _expand_dims(op):
                    inv[d] = s[od]
                ins = [tuple(inv)]
        elif op.target is not None and kind in _VIEWS:
            if o0 is not None:
                m = _view_map(o0, op.outputs[0].shape, op.inputs[0].shape)
                ins = None if m is None else [m]
        elif _reduce_axes(op) is not None:
            if o0 is not None:
                axes, keep = _reduce_axes(op)
                s = list(_pad(o0, len(op.outputs[0].shape)))
                if keep:
                    s = [None if d in axes else a for d, a in enumerate(s)]
                else:
                    for d in axes:
                        s.insert(d, None)
                ins = [tuple(s)]
        elif op.name.startswith("pt.sdpa"):
            if o0 is not None:
                ins = _sdpa_backward(op, o0)
        elif _region(op) is not None:
            changed = False
            for sub in reversed(_region(op)):
                changed |= self.backward(sub, facts)
            return changed
        else:
            bshape = broadcast_result_shape(op)
            if bshape is not None and o0 is not None:
                ins = [_unalign(o0, v.shape, bshape) for v in op.inputs]
            else:
                # same-shape mirror of the join rule
                by_shape = {tuple(o.shape): s
                            for o, s in zip(op.outputs, outs)
                            if s is not None}
                ins = [by_shape.get(tuple(v.shape)) for v in op.inputs]
        if ins is None:
            return False
        changed = False
        for v, s in zip(op.inputs, ins):
            if s is None or facts.get(id(v)) is not None:
                continue
            facts[id(v)] = _sanitize(s, v.shape)
            changed = True
        return changed


def _unalign(ospec, shape, out_shape):
    """The spec an operand of `shape` broadcast to `out_shape` takes from
    the result's spec."""
    off = len(out_shape) - len(shape)
    ospec = _pad(ospec, len(out_shape))
    return tuple(ospec[d + off] if shape[d] == out_shape[d + off] else None
                 for d in range(len(shape)))


def propagate_facts(prog: Program, seed: dict,
                    cost_model: Optional[CostModel] = None):
    """Run the forward+backward fixpoint over a facts dict (the program is
    not mutated). Returns (facts, stamps, resolved, sweeps): stamps is
    {id(op): rule text} for every op whose operand and result specs
    legitimately diverge and so needs a `sharding_rule` contract."""
    deriver = _Deriver(cost_model)
    facts = dict(seed)
    sweeps = 0
    for sweeps in range(1, MAX_SWEEPS + 1):
        changed = False
        for op in prog.ops:
            changed |= deriver.forward(op, facts)
        for op in reversed(prog.ops):
            changed |= deriver.backward(op, facts)
        if not changed:
            break
    stamps: dict = {}
    for op in prog.ops:
        outs = [facts.get(id(o)) for o in op.outputs]
        annotated = [(v, facts[id(v)]) for v in op.inputs
                     if facts.get(id(v)) is not None]
        if not annotated or all(s is None for s in outs):
            continue
        joined = deriver.join(op, annotated, resolve=False)
        if joined is CONFLICT:
            win = deriver._resolve(op, annotated,
                                   broadcast_result_shape(op))
            stamps[id(op)] = f"reshard{_spec_str(win)}"
        elif joined is not None and any(
                s is not None and s != joined for s in outs):
            stamps[id(op)] = f"{_kind(op)}{_spec_str(outs[0])}"
    return facts, stamps, list(deriver.resolved), sweeps


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------

class ShardingPropagation(Pass):
    """Fill `Value.sharding` from the program-input annotations and stamp
    `sharding_rule` contracts where operand specs legitimately diverge;
    pin the scope mesh on the program for the replay hint. No annotation
    anywhere is a no-op (one scan of the inputs). The `compile.shard_prop`
    fault site wraps the entry: an injected failure propagates to
    pipeline.compile_flat, which runs that compile as written under
    `pir_fallback_total{stage="passes"}`."""

    name = "shard_prop"

    def run(self, prog: Program) -> PassResult:
        from ..resilience.faults import fault_point
        fault_point("compile.shard_prop", program=prog.name)
        mesh_axes = _mesh_axis_sizes(current_mesh())
        seed: dict = {}
        pinned: set = set()
        for v in list(prog.inputs) + list(prog.constants):
            if v.sharding is not None:
                seed[id(v)] = _sanitize(v.sharding, v.shape, mesh_axes)
        for op in prog.ops:
            for o in op.outputs:
                if o.sharding is not None:
                    # an interior pre-stamp: a source for propagation but
                    # never ours to resolve or rule-stamp over; if it
                    # contradicts the flow, the verifier rejects it
                    seed[id(o)] = _sanitize(o.sharding, o.shape, mesh_axes)
                    pinned.add(id(op))
        if not seed:
            return PassResult(0, "no-annotations")
        facts, stamps, resolved, sweeps = propagate_facts(prog, seed)
        values = 0
        for v in self._all_values(prog):
            s = facts.get(id(v))
            if s is not None and v.sharding is None:
                v.sharding = s
                values += 1
        rules = 0
        for op in prog.ops:
            rule = stamps.get(id(op))
            if rule is None or id(op) in pinned \
                    or "sharding_rule" in op.attrs:
                continue
            op.attrs["sharding_rule"] = rule
            rules += 1
            for o in op.outputs:     # a contract op declares every output
                if o.sharding is None:
                    o.sharding = (None,) * len(o.shape)
                    values += 1
        mesh = current_mesh()
        if mesh is not None and (values or seed):
            prog._mesh = mesh        # the evaluator replays under it
        if values:
            try:
                from ..observability.catalog import metric as _metric
                _metric("pir_sharding_annotations_total",
                        program=prog.name).inc(values)
            except Exception:  # noqa: BLE001 — metrics never cost a compile
                pass
        return PassResult(
            values + rules,
            f"values={values} rules={rules} resolved={len(resolved)} "
            f"sweeps={sweeps}")

    @staticmethod
    def _all_values(prog: Program):
        yield from prog.inputs
        yield from prog.constants
        for op in prog.ops:
            yield from op.outputs
