"""paddle.static. reference: paddle_tpu/static/__init__.py (and
nn_builders.py as `static.nn`), after python/paddle/static/.

The port runs eagerly, as the reference's static layer does: a `Program`
is the name-keyed registry of the parameters its `static.nn` builders
made (`program_guard` makes a Program's registry the active one), and a
builder runs its op where it is called. `cond`, `while_loop` and `scan`
are Python control flow on tensors with the reference's return shapes:
`cond` reads its predicate on the host (one device-to-host copy on the
card; the reference stages a `lax.cond`), `while_loop` reads its
condition once a trip and returns a list, and `scan` returns the carry
and the stacked ys. A Program has no captured IR until the PIR slice, so
`to_string` prints the registry.

Serialization is the reference's: `serialize_program`/`serialize_
persistables` write the registry as npz bytes (no pickle), so bytes one
package writes load in the other. numpy has no bfloat16 without ml_dtypes,
which the port does not import, so the port writes a bfloat16 tensor as
float32 (exact) and `set_state_dict` casts it back to the parameter's
dtype. `save`/`load` write `.pdparams` through `framework/io_file.py`, the
reference's pickle format. `save_inference_model(..., layer=)` goes
through the port's `jit.save`/`jit.load`.
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import os
import warnings

import numpy as np
import torch

from ..jit import InputSpec  # noqa: F401

__all__ = ["InputSpec", "data", "Program", "program_guard",
           "default_main_program", "default_startup_program", "name_scope",
           "nn", "cond", "while_loop", "scan"]


def _name(t):
    return getattr(t, "param_name", None)


def data(name, shape, dtype="float32", lod_level=0):
    """A zero tensor standing for a feed of `shape` (-1 or None as 1) on
    the default device, named `name` (its `param_name`)."""
    from ..framework.device import resolve_device
    from ..framework.dtypes import convert_dtype
    t = torch.zeros([1 if s in (None, -1) else s for s in shape],
                    dtype=convert_dtype(dtype), device=resolve_device(None))
    t.param_name = name
    return t


def _as_tensor(v, like):
    """`v` as a tensor (a number on `like`'s device)."""
    if isinstance(v, torch.Tensor):
        return v
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, device=device)


def _copy_into(t, v):
    """Write `v` (a tensor or array) into `t` in place, cast to t's dtype;
    the element counts must agree."""
    from ..convert import _tensor
    src = v if isinstance(v, torch.Tensor) else _tensor(v)
    if src.numel() != t.numel():
        raise ValueError(f"set_state_dict: {tuple(src.shape)} has "
                         f"{src.numel()} elements, the parameter "
                         f"{tuple(t.shape)} {t.numel()}")
    with torch.no_grad():
        t.copy_(src.reshape(t.shape).to(device=t.device, dtype=t.dtype))


class Program:
    """The name-keyed registry of the parameters and buffers its
    `static.nn` builders made (reference: Program.all_parameters /
    state_dict)."""

    def __init__(self):
        self._params: dict = {}

    def global_block(self):
        return self

    def clone(self, for_test=False):
        p = Program()
        p._params = dict(self._params)
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        """The registry: one line per parameter with its shape."""
        lines = [f"program (no captured IR; {len(self._params)} "
                 "registered parameters) {"]
        for k, v in self._params.items():
            lines.append(f"  param {k}: {tuple(v.shape)}")
        lines.append("}")
        return "\n".join(lines)

    def __str__(self):
        return self.to_string()

    def all_parameters(self):
        return [p for p in self._params.values() if p.requires_grad]

    def state_dict(self, mode="all"):
        """name -> tensor. mode 'param': the trainable ones; 'opt': the
        optimizer state, none of which lives on a program; 'all':
        everything."""
        if mode == "param":
            return {k: v for k, v in self._params.items() if v.requires_grad}
        if mode == "opt":
            return {}
        if mode != "all":
            raise ValueError(
                f"state_dict mode must be 'param', 'opt' or 'all', got "
                f"{mode!r}")
        return dict(self._params)

    def set_state_dict(self, state_dict):
        """Write values into the registered tensors IN PLACE, so every
        builder holding them sees the restored weights. Unknown keys are
        skipped with a warning, as the reference's lenient load does."""
        for k, v in state_dict.items():
            t = self._params.get(k)
            if t is None:
                warnings.warn(f"set_state_dict: skipping unknown "
                              f"parameter {k!r}")
                continue
            _copy_into(t, v)


@contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    """Route static.nn builders' parameters into main_program's registry
    for the duration of the block."""
    if main_program is None:
        yield
        return
    from . import nn_builders
    prev = nn_builders._param_registry
    nn_builders._param_registry = main_program._params
    try:
        yield
    finally:
        nn_builders._param_registry = prev


_main = Program()
_startup = Program()


def default_main_program():
    return _main


def default_startup_program():
    return _startup


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


# -- control flow: Python on tensors ---------------------------------------


def _flag(pred):
    """A predicate's truth, read on the host."""
    if isinstance(pred, torch.Tensor):
        return bool(pred.reshape(()).item())
    return bool(pred)


def _tensors(out, like):
    if isinstance(out, (list, tuple)):
        return type(out)(_tensors(o, like) for o in out)
    if out is None:
        return None
    return _as_tensor(out, like)


def cond(pred, true_fn, false_fn, name=None):
    """true_fn() if pred else false_fn(), pred read on the host."""
    out = true_fn() if _flag(pred) else false_fn()
    return _tensors(out, pred)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Run body_fn over loop_vars while cond_fn holds; the final loop
    variables as a list."""
    like = next((v for v in loop_vars if isinstance(v, torch.Tensor)), None)
    vals = [_as_tensor(v, like) for v in loop_vars]
    while _flag(cond_fn(*vals)):
        out = body_fn(*vals)
        if not isinstance(out, (list, tuple)):
            out = [out]
        vals = [_as_tensor(o, like) for o in out]
    return vals


def scan(body_fn, init, xs, name=None):
    """carry, y = body_fn(carry, x) over xs' first axis; (the last carry,
    the ys stacked on a new first axis)."""
    carry, ys = init, []
    for x in xs.unbind(0):
        carry, y = body_fn(carry, x)
        ys.append(_as_tensor(y, xs))
    return _as_tensor(carry, xs), torch.stack(ys)


from . import nn_builders as nn  # noqa: E402  (the static-graph builders)

# the default main program IS the registry the builders write to outside
# any program_guard
_main._params = nn._param_registry
nn.cond = cond
nn.while_loop = while_loop
import sys as _sys  # noqa: E402
_sys.modules[__name__ + ".nn"] = nn  # importable as paddle_tpu_torch.static.nn


# -- the rest of the reference's surface ------------------------------------

# the port's tensor is torch.Tensor, unpatched (ROADMAP Queue 3), so
# Variable is that class and stays out of __all__ as paddle.Tensor does
Variable = torch.Tensor


class Executor:
    """A thin runner: each callable of fetch_list is called with the feed
    as keywords, each tensor is fetched as a numpy array."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kw):
        outs = []
        for f in fetch_list or []:
            if callable(f):
                outs.append(f(**(feed or {})))
            elif isinstance(f, torch.Tensor):
                outs.append(f.detach().cpu().numpy())
            else:
                outs.append(f)
        return outs

    def close(self):
        pass


class CompiledProgram:
    """The program and its build strategy, recorded."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def to_string(self, throw_on_error=False, with_details=False):
        if hasattr(self._program, "to_string"):
            return self._program.to_string()
        return repr(self._program)

    def __str__(self):
        return self.to_string()


class BuildStrategy:
    """The reference's build knobs, recorded."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_optimizer_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True


class IpuStrategy:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU is not a target of this build")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU is not a target of this build")


@contextlib.contextmanager
def device_guard(device=None):
    yield


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise NotImplementedError("IPU is not a target of this build")
    yield  # pragma: no cover


class _Scope:
    def find_var(self, name):
        return None

    def var(self, name):
        return None


_global_scope = _Scope()


def global_scope():
    return _global_scope


def scope_guard(scope):
    return contextlib.nullcontext(scope)


def cpu_places(device_count=None):
    from ..framework.device import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace()] * n


def cuda_places(device_ids=None):
    """The CUDA cards' places (all of them by default)."""
    from ..framework.device import CUDAPlace
    ids = device_ids if device_ids is not None else range(
        torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..framework.device import resolve_device
    from ..framework.dtypes import convert_dtype
    t = torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                   device="cpu" if force_cpu else resolve_device(None))
    t.persistable = persistable
    t.param_name = name
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..nn.layer.layers import create_parameter as _cp
    return _cp(shape, dtype=dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def Print(input, first_n=-1, message=None, summarize=20, **kw):
    """Print the first `summarize` values of `input` (all of them at
    -1) on the host, and return it."""
    prefix = message or "var"
    arr = input.detach().cpu().numpy()
    if arr.ndim == 0 or summarize < 0:
        shown = arr if arr.ndim == 0 else arr.reshape(-1)
    else:
        shown = arr.reshape(-1)[:summarize]
    print(f"{prefix}: {shown}")
    return input


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    xs = x if isinstance(x, (list, tuple)) else [x]
    return func(*xs)


def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """The batch's ROC AUC by ranks, on the host; (auc, batch auc, state),
    the state empty, as the reference's stateless version."""
    x = input.detach().cpu().numpy()
    probs = x[:, 1] if x.ndim == 2 else x
    y = label.detach().cpu().numpy().reshape(-1)
    order = np.argsort(-probs)
    y_sorted = y[order]
    n_pos = max(int(y_sorted.sum()), 0)
    n_neg = len(y_sorted) - n_pos
    if n_pos == 0 or n_neg == 0:
        val = 0.0
    else:
        ranks = np.empty(len(probs))
        ranks[np.argsort(probs)] = np.arange(1, len(probs) + 1)
        val = float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                    / (n_pos * n_neg))
    t = torch.tensor(val, dtype=torch.float32, device=input.device)
    return t, t, []


def _graph_leaves(loss):
    """The leaf tensors requiring grad that `loss` depends on, in the order
    the graph first reaches them."""
    seen, leaves, stack = set(), [], [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(f for f, _ in reversed(fn.next_functions))
    return leaves


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Run the backward of `loss`; (parameter, gradient) pairs of
    `parameter_list`, or of every parameter the loss depends on."""
    params = parameter_list
    if params is None:
        params = _graph_leaves(loss)
    loss.backward()
    return [(p, p.grad) for p in params if getattr(p, "grad", None)
            is not None]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..autograd import grad as _grad
    return _grad(targets, inputs, grad_outputs=target_gradients,
                 allow_unused=True)


class ExponentialMovingAverage:
    """EMA shadow weights with apply/restore. `update()` without
    parameters tracks the default main program's trainable parameters."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._params = []

    @torch.no_grad()
    def update(self, parameters=None):
        params = parameters
        if params is None:
            params = default_main_program().all_parameters()
        for p in params:
            if id(p) not in self._shadow:
                self._shadow[id(p)] = p.detach().clone()
                self._params.append(p)
            else:
                self._shadow[id(p)] = (self._decay * self._shadow[id(p)]
                                       + (1 - self._decay) * p.detach())

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            for p in self._params:
                self._backup[id(p)] = p.detach().clone()
                p.copy_(self._shadow[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))


class WeightNormParamAttr:
    """Recorded; nn.utils.weight_norm does the reparameterization."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name


def _npz_array(t):
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()     # exact; set_state_dict casts it back
    return t.numpy()


def _state_to_npz_bytes(state):
    """name -> tensor as in-memory npz bytes (no pickle)."""
    buf = _io.BytesIO()
    np.savez(buf, **{k: _npz_array(v) for k, v in state.items()})
    return buf.getvalue()


def _npz_bytes_to_params(data):
    """npz bytes -> name -> CPU tensor."""
    from ..convert import _tensor
    out = {}
    if data:
        with np.load(_io.BytesIO(data), allow_pickle=False) as z:
            for k in z.files:
                out[k] = _tensor(z[k])
    return out


def serialize_program(program=None, **kw):
    """The program's registry as npz bytes (its structure is the user's
    builder code)."""
    prog = program or default_main_program()
    return _state_to_npz_bytes(prog.state_dict()
                               if hasattr(prog, "state_dict") else {})


def deserialize_program(data):
    prog = Program()
    prog._params = _npz_bytes_to_params(data)
    return prog


def serialize_persistables(program=None, executor=None, **kw):
    prog = program or default_main_program()
    return _state_to_npz_bytes(prog.state_dict()
                               if hasattr(prog, "state_dict") else {})


def deserialize_persistables(program, data, executor=None):
    state = _npz_bytes_to_params(data)
    if program is not None and hasattr(program, "set_state_dict"):
        program.set_state_dict(state)
    return state


def save(program, model_path, protocol=4, **configs):
    from ..framework.io_file import save as _save
    state = program.state_dict() if hasattr(program, "state_dict") else {}
    _save(state, model_path + ".pdparams", protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    from ..framework.io_file import load as _load
    state = _load(model_path + ".pdparams")
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)
    return state


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feeds, fetches, **kw):
    return program


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """Two forms. `layer=<nn.Layer>`: `jit.save(layer, path_prefix,
    input_spec=)`, the parameters, and the program exported at the specs'
    shapes when `input_spec=` is given (the reference takes no specs here
    and writes the parameters only: the model class rebuilds the program,
    as it must here without specs). Otherwise the
    program's registry as npz bytes (`.pdmodel`) and a feed/fetch
    manifest (`.pdmodel.json`); the program's structure is the user's
    builder code, run again at load."""
    layer = kwargs.get("layer")
    if layer is not None and hasattr(layer, "state_dict") and not isinstance(
            layer, Program):
        from ..jit import save as _jsave
        _jsave(layer, path_prefix, input_spec=kwargs.get("input_spec"))
        return
    prog = kwargs.get("program") or default_main_program()
    save_to_file(path_prefix + ".pdmodel", serialize_program(prog))
    meta = {"format": "paddle_tpu.static", "version": 1,
            "feed": [_name(v) for v in (feed_vars or [])],
            "fetch": [_name(v) for v in (fetch_vars or [])]}
    save_to_file(path_prefix + ".pdmodel.json", json.dumps(meta).encode())


def load_inference_model(path_prefix, executor=None, **kwargs):
    """[program, feed names, fetch names] of the program form (the
    registry written into `program=` when given), or [Program(), [],
    [TranslatedLayer]] of the layer form, loaded on `device=` (the
    package's default, CUDA, unless given)."""
    if os.path.exists(path_prefix + ".pdmodel.json"):
        prog = deserialize_program(load_from_file(path_prefix + ".pdmodel"))
        meta = json.loads(
            load_from_file(path_prefix + ".pdmodel.json").decode())
        target = kwargs.get("program")
        if target is not None and hasattr(target, "set_state_dict"):
            target.set_state_dict(prog.state_dict())
        return [prog, meta.get("feed", []), meta.get("fetch", [])]
    from ..jit import load as _jload
    tl = _jload(path_prefix, device=kwargs.get("device"))
    return [Program(), [], [tl]]


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    raise NotImplementedError(
        "ctr_metric_bundle belongs to the parameter-server stack, which "
        "the reference does not have either")


def set_program_state(program, state):
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)


def load_program_state(model_path, var_list=None):
    from ..framework.io_file import load as _load
    return _load(model_path + ".pdparams")


def xpu_places(device_ids=None):
    raise NotImplementedError("XPU is not a target of this build")


def set_ipu_shard(call_func, index=-1, stage=-1):
    raise NotImplementedError("IPU is not a target of this build")


__all__ += [
    "Executor", "CompiledProgram", "BuildStrategy",
    "IpuStrategy", "IpuCompiledProgram", "device_guard", "ipu_shard_guard",
    "global_scope", "scope_guard", "cpu_places", "cuda_places",
    "create_global_var", "create_parameter", "Print", "py_func", "accuracy",
    "auc", "append_backward", "gradients", "ExponentialMovingAverage",
    "WeightNormParamAttr", "serialize_program", "deserialize_program",
    "serialize_persistables", "deserialize_persistables", "save", "load",
    "save_to_file", "load_from_file", "normalize_program",
    "save_inference_model", "load_inference_model", "ctr_metric_bundle",
    "set_program_state", "load_program_state", "xpu_places",
    "set_ipu_shard",
]
