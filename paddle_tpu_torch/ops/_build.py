"""Build and load the port's CUDA kernels.

Every `paddle_tpu_torch/csrc/*.cu` (with the `*.cuh` headers it includes)
is compiled by `nvcc` for `sm_90a` into one shared library with a plain C
interface, at first use, and loaded with `ctypes`. The library's name
carries a hash of the sources, headers and flags, so an
edited source builds anew and an unchanged one is reused. The objects of
the sources are compiled in parallel, one `nvcc` each. Nothing is
downloaded and no package of finished kernels is used.

The library lives in `paddle_tpu_torch/_build/` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build_log", "BUILD_DIR", "SIGNATURES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every `extern "C"` function of csrc/*.cu. A
# pointer or the stream must be c_void_p: as c_int, ctypes would cut it to
# 32 bits without a word. tests/test_torch_kernel_abi.py holds this table
# against the declarations in the sources.
SIGNATURES = {
    # q, k, v, out, lse; bh, sq, sk, d, q_per_kv, causal; scale; is_bf16,
    # device; stream
    "flash_fwd": ([_P] * 5 + [_I] * 6 + [_F] + [_I] * 2 + [_P], _I),
    # q, k, v, residual, gamma, out, lse; bh, sq, sk, d, q_per_kv, causal;
    # scale, eps; rms_d, is_bf16, device; stream
    "flash_fwd_rms_epilogue": ([_P] * 7 + [_I] * 6 + [_F] * 2 + [_I] * 3
                               + [_P], _I),
    # q, k, v, dout, lse, delta, dq; bh, sq, sk, d, q_per_kv, causal;
    # scale; is_bf16, device; stream
    "flash_bwd_dq": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 2 + [_P], _I),
    # as flash_bwd_dq with dk, dv in place of dq
    "flash_bwd_dkv": ([_P] * 8 + [_I] * 6 + [_F] + [_I] * 2 + [_P], _I),
    "cuda_error_string": ([_I], ctypes.c_char_p),
}

_LIB = [None]
build_log: list = []   # nvcc's messages (registers, spills) per source


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            build_log.append(f"{src.name}:\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp) / target.name
        subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib),
                        *map(str, objs)], check=True, capture_output=True)
        os.replace(lib, target)   # atomic: a reader never sees half a file


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    if _LIB[0] is None:
        target = BUILD_DIR / f"libpaddle_tpu_torch_{_digest()}.so"
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB[0] = lib
    return _LIB[0]
