"""jit: to_static and the inference artifact (jit.save / jit.load).

reference: paddle_tpu/jit/__init__.py — `to_static`, `StaticFunction`,
`enable_to_static`, `not_to_static` (:58-380), `InputSpec` (:43-51),
`save`, `load`, `TranslatedLayer`, `FORMAT_VERSION` and the npz parameter
codec `_encode_param` / `_decode_param` (:367-512).

`to_static(fn)` compiles `fn` through the PIR pipeline
(pir/pipeline.compile_flat) once per input signature: the function is
captured on fake tensors into a pir.Program with the layer's parameters
and buffers as program inputs (closed over through
`torch.func.functional_call`, as `jit.save` exports), verified, rewritten
by the passes (dense causal attention to K1, its RMSNorm epilogue to K2)
and replayed as torch calls on every call, so `loss.backward()` after a
to_static forward runs torch autograd through the replayed program: K3/K4
are the backward of the K1 operator the program holds. A data-dependent
Python branch is a graph break: the signature then runs as staged
segments (framework/staging.py), or raises with `full_graph=True`.

An artifact is two files at one prefix:

  - `.pdiparams`: the state dict as an npz (no pickle on the load path),
    the reference's format. A dtype numpy has no type for (bfloat16,
    float8_*) is stored as uint8 bytes with a trailing item-size axis and
    a dtype descriptor in the meta; the port reads it back through
    `convert.tensor_from_bytes`, without ml_dtypes. Arrays are written and
    read one at a time, so a 13.5 GB model is never held twice on the
    host.
  - `.pdmodel`: the pickled meta dict. Where the reference keeps a
    StableHLO program under "stablehlo", the port keeps under
    "torch_export" the bytes of `torch.export.save` of the functional
    program `functional_call(layer, params, inputs)`, exported with the
    params as a pytree INPUT: the program carries no weights, as the
    reference's carries none. The flash-attention kernels K1 and K2 are
    registered operators (`paddle_tpu_torch::flash_fwd`, ...), so the
    program holds them as nodes and runs them wherever it is loaded.

The program runs on the device the layer lived on when it was saved.
"""

from __future__ import annotations

import functools
import io
import os
import pickle
import warnings
import zipfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..convert import tensor_from_bytes
from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype

__all__ = ["to_static", "not_to_static", "ignore_module", "enable_to_static",
           "StaticFunction", "save", "load", "TranslatedLayer", "InputSpec",
           "FORMAT_VERSION", "set_code_level", "set_verbosity"]

FORMAT_VERSION = 2  # v1: pickled params dict; v2: npz params + version field


class InputSpec:
    """reference: python/paddle/static/input.py:InputSpec."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient


class TranslatedLayer:
    """Loaded inference artifact."""

    def __init__(self, fn, state, program=None):
        self._fn = fn
        self._state = state
        self.program = program      # the exported module; None: params only

    def __call__(self, *args):
        return self._fn(*args)


class _Functional(torch.nn.Module):
    """forward(params, *inputs) = functional_call(layer, params, inputs).
    The layer is held outside the module's registry, so its own weights
    are not lifted into the exported program."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, params, *inputs):
        return torch.func.functional_call(self._layer, params, inputs)


def _encode_param(t):
    """(npz-safe array, dtype descriptor) of a tensor. Dtypes numpy has
    (float32, int64, ...) pass through; bfloat16 and float8 become uint8
    bytes with a trailing item-size axis, as the reference writes them."""
    t = t.detach().contiguous().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        raw = t.reshape(-1).view(torch.uint8).numpy().reshape(
            tuple(t.shape) + (t.element_size(),))
        return raw, {"dtype": name, "encoded": True}
    return t.numpy(), {"dtype": name, "encoded": False}


def _decode_param(arr, desc):
    """A CPU tensor from an npz array and its descriptor."""
    if not desc or not desc.get("encoded"):
        return torch.from_numpy(arr)
    return tensor_from_bytes(arr, desc["dtype"], arr.shape[:-1])


def _write_npz(path, items):
    """np.savez's layout (one stored `<key>.npy` member per array),
    written from an iterator of (key, array) so one array at a time is
    on the host."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def _load_npz_params(path, meta, device):
    """{name: tensor on `device`}, decoded one array at a time."""
    dtypes = meta.get("param_dtypes", {})
    with np.load(path, allow_pickle=False) as z:
        return {k: _decode_param(z[k], dtypes.get(k)).to(device)
                for k in z.files}


def _read_meta(prefix):
    with open(prefix + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    version = meta.get("format_version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"jit artifact {prefix!r} has format version {version}; this "
            f"build reads <= {FORMAT_VERSION}. Load it with a newer "
            "paddle_tpu_torch or re-save with this one.")
    return meta


def _load_params(params_path, meta, device):
    if meta.get("format_version", 1) >= 2:
        return _load_npz_params(params_path, meta, device)
    with open(params_path, "rb") as f:        # v1 pickled dict
        state = pickle.load(f)
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in state.items()}


def _program(meta, prefix):
    """The deserialized program's module, or None for a params-only
    artifact. Raises ValueError for a reference (StableHLO) program."""
    if meta.get("torch_export"):
        ep = torch.export.load(io.BytesIO(meta["torch_export"]))
        return ep.module()
    if meta.get("stablehlo"):
        raise ValueError(
            f"{prefix}.pdmodel holds a StableHLO program (the JAX "
            "package's jit.save), which this package cannot run; re-save "
            "the model with paddle_tpu_torch.jit.save")
    return None


def save(layer, path, input_spec=None, **configs):
    """Serialize an inference program: params (.pdiparams) plus the
    exported program (.pdmodel) when `input_spec` is given (params only
    without it). The program is exported at the specs' shapes, with
    example inputs of zeros on the layer's device, in eval mode (the
    layer's mode is restored after)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = dict(layer.state_dict())
    param_dtypes = {}

    def encoded():
        for k, v in state.items():
            arr, param_dtypes[k] = _encode_param(v)
            yield k, arr

    tmp = path + ".pdiparams.tmp"
    _write_npz(tmp, encoded())
    os.replace(tmp, path + ".pdiparams")

    meta = {"format_version": FORMAT_VERSION,
            "class": type(layer).__name__,
            "param_dtypes": param_dtypes,
            "input_spec": [(tuple(s.shape), str(s.dtype))
                           for s in (input_spec or [])],
            "torch_export": None}
    if input_spec:
        was_training = layer.training
        layer.eval()
        try:
            device = next((v.device for v in state.values()),
                          torch.device("cpu"))
            args = [torch.zeros(tuple(s.shape),
                                dtype=convert_dtype(s.dtype), device=device)
                    for s in input_spec]
            params = {k: v.detach() for k, v in state.items()}
            with torch.no_grad():
                ep = torch.export.export(_Functional(layer),
                                         (params, *args))
            ep.example_inputs = None     # they would hold the weights
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            meta["torch_export"] = buf.getvalue()
        finally:
            if was_training:
                layer.train()
    tmp = path + ".pdmodel.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(meta, f)
    os.replace(tmp, path + ".pdmodel")


def load(path, *, device=None, params_path=None, **configs):
    """Load a jit.save artifact as a callable TranslatedLayer that runs
    the exported program on `device` (default: the package's, CUDA); its
    params come from `params_path` (default: path + ".pdiparams").
    Rejects artifacts from a newer format, and the JAX package's
    StableHLO programs, with a ValueError."""
    device = resolve_device(device)
    meta = _read_meta(path)
    module = _program(meta, path)
    state = _load_params(params_path or path + ".pdiparams", meta, device)
    if module is not None:
        def fn(*args):
            arrs = [torch.as_tensor(a).to(device) for a in args]
            with torch.no_grad():
                return module(state, *arrs)
    else:
        def fn(*args):
            raise RuntimeError(
                "this artifact was saved without input_spec (params only); "
                "re-instantiate the model class and call load_state_dict")
    tl = TranslatedLayer(fn, state, program=module)
    tl.state_dict = lambda: state
    tl._input_spec = meta.get("input_spec", [])
    return tl


_code_level = 0
_verbosity = 0


def set_code_level(level=100, also_to_stdout=False):
    """The transformed-code log level of dy2static, recorded (the port
    captures by tracing and has no transformed code to print)."""
    global _code_level
    _code_level = level


def set_verbosity(level=0, also_to_stdout=False):
    """The dy2static log verbosity, recorded."""
    global _verbosity
    _verbosity = level


# ---------------------------------------------------------------------------
# to_static
# ---------------------------------------------------------------------------

_to_static_enabled = True


def enable_to_static(flag: bool):
    """Globally turn to_static compilation on or off (off: every
    StaticFunction calls its function as written)."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def _leaf_key(a):
    """Signature part of one non-tensor argument leaf: its type and repr
    (1, 1.0 and True key apart)."""
    return (type(a).__name__, repr(a))


class StaticFunction:
    """A compiled wrapper (reference: StaticFunction): one captured,
    rewritten program per input signature, in an LRU of
    FLAGS_jit_signature_cache_size entries."""

    def __init__(self, fn, input_spec=None, build_strategy=None,
                 full_graph=False, layer=None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._cache: dict = {}               # LRU: insertion == recency
        self._fallback_keys: set = set()
        self._staged_jit_cache: dict = {}    # graph-break segments
        self._last_segments = 0
        self._ir_program = None
        self._last_report = None
        functools.update_wrapper(self, fn, updated=())

    @property
    def ir_program(self):
        """The pir.Program of the most recent compile (None when the
        pipeline is off or fell back): print(sf.ir_program)."""
        return self._ir_program

    @property
    def last_report(self):
        """pir.CompileReport of the most recent compile: cache state,
        per-pass edits and seconds, pattern counts, fallback."""
        return self._last_report

    def _state(self):
        if self._layer is None:
            return {}
        state = dict(self._layer.named_parameters())
        state.update((k, b) for k, b in self._layer.named_buffers()
                     if b is not None)
        return state

    def __call__(self, *args, **kwargs):
        from ..pir.capture import GraphBreak, _proxy_graph
        if not _to_static_enabled or getattr(self._fn, "_not_to_static",
                                             False) \
                or _proxy_graph() is not None:
            # disabled, or called inside another capture: the outer
            # program records this function's ops
            return self._fn(*args, **kwargs)
        state = self._state()
        names = list(state)
        flat, spec = pytree.tree_flatten((args, kwargs))
        t_idx = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        tensors = [flat[i] for i in t_idx]
        key = (spec, tuple(names),
               tuple((tuple(t.shape), t.dtype, str(t.device),
                      t.requires_grad) for t in list(state.values())
                     + tensors),
               tuple(_leaf_key(a) for a in flat
                     if not isinstance(a, torch.Tensor)),
               None if self._layer is None else self._layer.training)
        if key in self._fallback_keys:
            return self._run_staged(args, kwargs)
        entry = self._cache.pop(key, None)
        if entry is None:
            from ..framework import flags as _flags
            from ..observability.catalog import metric as _metric
            _metric("jit_retrace_total").inc()
            try:
                entry = self._compile(names, flat, spec, t_idx,
                                      list(state.values()) + tensors)
            except GraphBreak as e:
                if self._full_graph:
                    raise
                warnings.warn(
                    f"to_static: graph break in "
                    f"{getattr(self._fn, '__name__', self._fn)!r} "
                    f"(data-dependent control flow); running this input "
                    f"signature as staged segments around the break. Use "
                    f"full_graph=True to make this an error.\n  cause: {e}",
                    RuntimeWarning, stacklevel=2)
                self._fallback_keys.add(key)
                return self._run_staged(args, kwargs)
            cap = _flags.flag_value("jit_signature_cache_size")
            while cap and len(self._cache) >= cap:
                self._cache.pop(next(iter(self._cache)))
        self._cache[key] = entry
        compiled, out_box = entry
        outs = compiled(*state.values(), *tensors)
        return pytree.tree_unflatten(list(outs), out_box["spec"])

    def _compile(self, names, flat, spec, t_idx, example):
        """compile_flat of fn over (params and buffers, tensor args)."""
        from .. import pir
        from ..framework import flags as _flags
        fn, layer = self._fn, self._layer
        n_state = len(names)
        out_box: dict = {}

        def flat_fn(*tensors):
            leaves = list(flat)
            for i, t in zip(t_idx, tensors[n_state:]):
                leaves[i] = t
            a, k = pytree.tree_unflatten(leaves, spec)
            if layer is not None:
                out = torch.func.functional_call(
                    _Bound(layer, fn),
                    {"layer." + n: t for n, t in zip(names, tensors)},
                    a, k)
            else:
                out = fn(*a, **k)
            out_flat, out_box["spec"] = pytree.tree_flatten(out)
            return tuple(out_flat)

        name = getattr(fn, "__name__", "to_static")
        if not _flags.flag_value("pir"):
            self._last_report = self._ir_program = None
            return flat_fn, out_box
        compiled, report = pir.compile_flat(flat_fn, example, name=name)
        self._last_report = report
        self._ir_program = report.program
        if report.program is not None:
            from .. import static as _static
            _static.default_main_program().attach_ir(report.program)
        if "spec" not in out_box:
            # a fallback never ran flat_fn: learn the output structure
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode(allow_non_fake_inputs=True):
                flat_fn(*example)
        return compiled, out_box

    def _run_staged(self, args, kwargs):
        from ..framework.staging import StagingScope
        scope = StagingScope(jit_cache=self._staged_jit_cache)
        out = scope.run(self._fn, *args, **kwargs)
        self._last_segments = scope.segments
        return out

    @property
    def code(self):
        import inspect
        return inspect.getsource(self._fn)

    def concrete_program_specify_input_spec(self, *a, **k):
        return None


class _Bound(torch.nn.Module):
    """forward = the wrapped function, with the layer registered as the
    submodule "layer", so torch.func.functional_call can put the program's
    parameter and buffer inputs in place of the layer's own."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        object.__setattr__(self, "_fn", fn)

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, **kwargs):
    """reference: python/paddle/jit/api.py:195. A Layer gets its forward
    replaced by a StaticFunction (the Layer is returned); a bound method
    of a Layer or a plain function becomes a StaticFunction. With
    full_graph=False (the reference's SOT default) a graph break runs the
    signature as staged segments; full_graph=True raises
    pir.GraphBreak."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            sf = StaticFunction(layer.forward, input_spec, build_strategy,
                                full_graph, layer=layer)
            layer.forward = sf
            return layer
        owner = getattr(fn, "__self__", None)
        layer = owner if isinstance(owner, torch.nn.Module) else None
        return StaticFunction(fn, input_spec, build_strategy, full_graph,
                              layer=layer)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Mark `fn` so a StaticFunction of it runs it as written."""
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    """Accepted for the reference's API; capture traces every module."""
