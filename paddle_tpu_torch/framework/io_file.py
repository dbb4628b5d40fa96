"""paddle.save / paddle.load. reference: paddle_tpu/framework/io_file.py
(:1-55; python/paddle/framework/io.py:773).

The reference's pickle format: every tensor of the (nested) object becomes
{"__tensor__": True, "data": <numpy array>, "stop_gradient", "name"}, so a
`.pdparams` or `.pdopt` written by either package loads in the other.
numpy has no bfloat16 without ml_dtypes, which the port does not import,
so the port writes a bfloat16 tensor's data as float32 (exact) with
"dtype": "bfloat16" beside it, and restores the dtype on load; the
reference reads such an entry as float32. A reference file's bfloat16 data
(an ml_dtypes array, which pickle imports to read) is read from its bytes.
`load` puts every tensor on the CPU; moving it to the card is the
caller's job, or `set_state_dict`'s.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _to_savable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        entry = {"__tensor__": True, "stop_gradient": not obj.requires_grad,
                 "name": getattr(obj, "param_name", None)}
        if t.dtype == torch.bfloat16:
            entry.update(data=t.float().numpy(), dtype="bfloat16")
        else:
            entry["data"] = t.numpy()
        return entry
    if isinstance(obj, dict):
        return {k: _to_savable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_savable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.kind == "V":     # ml_dtypes' bfloat16 / float8 from the JAX side
        flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy()
        return torch.from_numpy(flat).view(getattr(torch, a.dtype.name)) \
            .reshape(a.shape)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _from_savable(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return _tensor(obj["data"], obj.get("dtype"))
        return {k: _from_savable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_savable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_savable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return _from_savable(pickle.load(f))
