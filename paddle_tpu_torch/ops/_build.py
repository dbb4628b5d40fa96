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

__all__ = ["library", "build_log", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i,
                                  p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_rms_epilogue.argtypes = [p] * 7 + [i] * 6 + [f, f, i,
                                                                   i, i, p]
        lib.flash_fwd_rms_epilogue.restype = i
        lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, i, i, p]
        lib.flash_bwd_dq.restype = i
        lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, i, i, p]
        lib.flash_bwd_dkv.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIB[0] = lib
    return _LIB[0]
