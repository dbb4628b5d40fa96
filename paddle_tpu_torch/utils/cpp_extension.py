"""Custom C++ operators. reference: paddle_tpu/utils/cpp_extension.py
(`load`, `CustomOpLibrary.op`, `CppExtension`, `CUDAExtension`, `setup`,
`get_build_directory`), after python/paddle/utils/cpp_extension/.

The op runs on the host, as the reference's does (there through
`jax.pure_callback`): a CUDA input is copied to the host, the C function
runs on contiguous numpy arrays, and each result is copied back to the
first input's device. The build is `g++ -shared` through `subprocess`
(torch's own extension build needs `ninja`), cached by a hash of the
sources and flags, so one user source builds under both packages. The C
ABI is the reference's, for an op named NAME:

    void NAME(const void** inputs, void** outputs,
              const int64_t* const* in_shapes, const int* in_ndims,
              int num_inputs);

Inputs and outputs are contiguous arrays; the caller allocates the outputs
from the declared output spec. `CUDAExtension` builds a host extension, as
the reference's does. Libraries land in `get_build_directory()`:
`PADDLE_EXTENSION_DIR`, else `paddle_tpu_torch/_build/extensions/`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["load", "CustomOpLibrary", "CppExtension", "CUDAExtension",
           "setup", "get_build_directory"]

_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build" / \
    "extensions"


def get_build_directory():
    d = os.environ.get("PADDLE_EXTENSION_DIR") or str(_DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def _compile(name, sources, extra_cxx_cflags=None, extra_ldflags=None,
             verbose=False, build_directory=None):
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    # flags are part of the cache key: a flag change must rebuild
    h.update(repr((sorted(extra_cxx_cflags or []),
                   sorted(extra_ldflags or []))).encode())
    tag = h.hexdigest()[:16]
    out_dir = build_directory or get_build_directory()
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, f"{name}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"]
    cmd += list(extra_cxx_cflags or [])
    cmd += ["-o", tmp] + list(sources) + list(extra_ldflags or [])
    if verbose:
        print("cpp_extension:", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=not verbose)
    if res.returncode != 0:
        diag = (res.stderr or b"").decode(errors="replace") \
            if not verbose else "(see output above)"
        raise RuntimeError(
            f"cpp_extension build of {name} failed "
            f"(command: {' '.join(cmd)}):\n{diag}")
    os.replace(tmp, so_path)      # a reader never sees half a library
    return so_path


def _numpy_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class CustomOpLibrary:
    """A loaded custom-op library; `op` makes a C function a callable on
    tensors."""

    def __init__(self, so_path):
        self._path = so_path
        self._lib = ctypes.CDLL(so_path)

    def _raw(self, symbol):
        fn = getattr(self._lib, symbol)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int]
        return fn

    def op(self, symbol, out_shapes_fn=None, out_dtypes_fn=None):
        """A callable over tensors. out_shapes_fn(*input_shapes) -> list of
        output shapes (default: the first input's); out_dtypes_fn(*input
        numpy dtypes) -> list of output dtypes (default: the first
        input's). One output is returned as a tensor, several as a list."""
        fn = self._raw(symbol)

        def host_call(*arrays):
            arrays = [np.ascontiguousarray(a) for a in arrays]
            in_shapes = [a.shape for a in arrays]
            o_shapes = (out_shapes_fn(*in_shapes) if out_shapes_fn
                        else [in_shapes[0]])
            o_dtypes = (out_dtypes_fn(*[a.dtype for a in arrays])
                        if out_dtypes_fn else [arrays[0].dtype] * len(o_shapes))
            outs = [np.empty(tuple(s), _numpy_dtype(d))
                    for s, d in zip(o_shapes, o_dtypes)]
            n = len(arrays)
            in_ptrs = (ctypes.c_void_p * n)(
                *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
            out_ptrs = (ctypes.c_void_p * len(outs))(
                *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
            shape_arrs = [np.asarray(a.shape, np.int64) for a in arrays]
            shape_ptrs = (ctypes.POINTER(ctypes.c_int64) * n)(
                *[s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                  for s in shape_arrs])
            ndims = (ctypes.c_int * n)(*[a.ndim for a in arrays])
            fn(in_ptrs, out_ptrs, shape_ptrs, ndims, n)
            return outs

        def tensor_fn(*tensors):
            tensors = [t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
                       for t in tensors]
            device = tensors[0].device
            # the explicit host round trip: device -> host, the C call,
            # host -> the first input's device
            arrays = [t.detach().cpu().numpy() for t in tensors]
            outs = [torch.from_numpy(o).to(device) for o in host_call(*arrays)]
            return outs if len(outs) > 1 else outs[0]

        tensor_fn.__name__ = symbol
        tensor_fn.raw = host_call
        return tensor_fn


def load(name, sources, extra_cxx_cflags=None, extra_cuda_cflags=None,
         extra_ldflags=None, extra_include_paths=None, build_directory=None,
         verbose=False):
    """Compile (or reuse) and load a custom-op library."""
    cflags = list(extra_cxx_cflags or [])
    for inc in extra_include_paths or []:
        cflags.append(f"-I{inc}")
    so = _compile(name, sources, cflags, extra_ldflags, verbose,
                  build_directory)
    return CustomOpLibrary(so)


class CppExtension:
    """setup()-style declaration of an extension's sources."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


def CUDAExtension(sources, *args, **kwargs):
    """Accepted for source compatibility: the op builds as a host C++
    extension, as the reference's does."""
    return CppExtension(sources, *args, **kwargs)


def setup(name=None, ext_modules=None, **kwargs):
    """Build the declared extensions now (the reference's setuptools path
    collapses to a direct g++ build)."""
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) else [ext_modules]
    libs = [load(name or f"ext{i}", e.sources, **e.kwargs)
            for i, e in enumerate(exts) if e is not None]
    return libs[0] if len(libs) == 1 else libs
