"""Carry weights from the JAX package's Llama to the port's.

Parameter names and layouts are the same in both packages, so a reference
state dict, as numpy arrays, maps onto the port key for key:

    np_state = {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}
    load_reference_state(port_model, np_state)

Both functions raise on a missing or an unexpected key and on a shape
mismatch. `tree_from_reference` carries a nested dict of arrays across as
it is: the scanned params tree of `build_scanned_llama`, its grads, or an
optimizer-state tree of `Optimizer.tree_init`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .framework.device import resolve_device
from .framework.dtypes import convert_dtype

__all__ = ["state_from_reference", "load_reference_state",
           "tree_from_reference", "tensor_from_bytes"]

_LAYER = re.compile(r"^llama\.layers\.(\d+)\.(.+)$")


def _llama_shapes(np_state) -> dict:
    """The key -> shape map of a complete Llama state with the vocabulary,
    widths and depth that `np_state` itself shows."""
    try:
        vocab, hidden = np_state["llama.embed_tokens.weight"].shape
        ffn = np_state["llama.layers.0.mlp.gate_proj.weight"].shape[1]
        kv = np_state["llama.layers.0.self_attn.k_proj.weight"].shape[1]
    except KeyError as e:
        raise KeyError(f"reference state lacks {e.args[0]!r}") from None
    depth = 1 + max(int(m.group(1)) for m in map(_LAYER.match, np_state)
                    if m)
    layer = {"self_attn.q_proj.weight": (hidden, hidden),
             "self_attn.k_proj.weight": (hidden, kv),
             "self_attn.v_proj.weight": (hidden, kv),
             "self_attn.o_proj.weight": (hidden, hidden),
             "mlp.gate_proj.weight": (hidden, ffn),
             "mlp.up_proj.weight": (hidden, ffn),
             "mlp.down_proj.weight": (ffn, hidden),
             "input_layernorm.weight": (hidden,),
             "post_attention_layernorm.weight": (hidden,)}
    shapes = {"llama.embed_tokens.weight": (vocab, hidden),
              "llama.norm.weight": (hidden,)}
    for i in range(depth):
        shapes.update({f"llama.layers.{i}.{k}": s for k, s in layer.items()})
    if "lm_head.weight" in np_state:   # absent when embeddings are tied
        shapes["lm_head.weight"] = (hidden, vocab)
    return shapes


def _check(np_state, shapes: dict) -> None:
    missing = sorted(set(shapes) - set(np_state))
    unexpected = sorted(set(np_state) - set(shapes))
    if missing or unexpected:
        raise KeyError(f"state keys differ: missing {missing}, unexpected "
                       f"{unexpected}")
    for k, shape in shapes.items():
        if tuple(np.shape(np_state[k])) != tuple(shape):
            raise ValueError(f"{k}: reference shape "
                             f"{tuple(np.shape(np_state[k]))} != {tuple(shape)}")


def tensor_from_bytes(raw, dtype_name, shape) -> torch.Tensor:
    """A CPU tensor of torch dtype `dtype_name` ("bfloat16",
    "float8_e4m3fn", "float8_e5m2", ...) and `shape` from its raw bytes:
    how the port reads dtypes numpy has no type for, without ml_dtypes."""
    dtype = getattr(torch, dtype_name)
    flat = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    if not flat.size:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.from_numpy(flat.copy()).view(dtype).reshape(tuple(shape))


def _tensor(a) -> torch.Tensor:
    """A torch copy of an array (JAX hands out read-only arrays)."""
    a = np.asarray(a)
    if a.dtype.kind == "V":   # ml_dtypes' bf16/fp8, which torch can't read
        return tensor_from_bytes(a, a.dtype.name, a.shape)
    return torch.tensor(a)


def state_from_reference(np_state: dict, device, dtype=None) -> dict:
    """The port's Llama state dict (torch tensors on `device`, in `dtype` or
    the arrays' own dtype) from a reference state of numpy arrays."""
    _check(np_state, _llama_shapes(np_state))
    device = resolve_device(device)
    dt = None if dtype is None else convert_dtype(dtype)
    return {k: _tensor(v).to(device=device, dtype=dt)
            for k, v in np_state.items()}


@torch.no_grad()
def load_reference_state(model: torch.nn.Module, np_state: dict) -> None:
    """Copy a reference state of numpy arrays into `model` in place, each
    array cast to its parameter's dtype and device."""
    params = model.state_dict()
    _check(np_state, {k: tuple(v.shape) for k, v in params.items()})
    for k, p in params.items():
        p.copy_(_tensor(np_state[k]))


def tree_from_reference(np_tree, device, dtype=None):
    """A nested dict of numpy arrays -> the same nested dict of torch tensors
    on `device`, in `dtype` or each array's own dtype."""
    device = resolve_device(device)
    dt = None if dtype is None else convert_dtype(dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x).to(device=device, dtype=dt)
    return conv(np_tree)
