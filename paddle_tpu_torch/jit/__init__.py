"""jit.save / jit.load: the inference artifact.

reference: paddle_tpu/jit/__init__.py — `InputSpec` (:43-51), `save`,
`load`, `TranslatedLayer`, `FORMAT_VERSION` and the npz parameter codec
`_encode_param` / `_decode_param` (:367-512).

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
`jit.to_static` waits for the PIR slice (ROADMAP.md, slice 6).
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile

import numpy as np
import torch

from ..convert import tensor_from_bytes
from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype

__all__ = ["save", "load", "TranslatedLayer", "InputSpec", "FORMAT_VERSION"]

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
