"""The ctypes signatures of the port's kernel library against its C sources.

`paddle_tpu_torch.ops._build.SIGNATURES` gives ctypes the argument and
result types of every `extern "C"` function in `paddle_tpu_torch/csrc/*.cu`.
A mismatch is silent: a pointer passed as c_int is cut to 32 bits, a float
passed as c_int arrives as garbage. These tests parse the declarations in
the sources and hold the table against them, on the CPU, with no compiler.
"""

import ctypes
import re
from pathlib import Path

import pytest

from paddle_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
DECL = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{',
                  re.S)


def _ctype(c_type):
    """The ctypes type a C parameter or result type must be bound with."""
    c_type = " ".join(c_type.split())
    if c_type == "const char*":
        return ctypes.c_char_p
    if "*" in c_type:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[c_type]


def _param_type(param):
    """'const void* q' -> 'const void*'; 'int bh' -> 'int'."""
    words = param.replace("*", "* ").split()
    return " ".join(words[:-1]).replace(" *", "*")


def _declarations():
    decls = {}
    for src in sorted(CSRC.glob("*.cu")):
        for ret, name, params in DECL.findall(src.read_text()):
            params = [p.strip() for p in params.split(",") if p.strip()]
            decls[name] = (src.name, _ctype(ret),
                           [_ctype(_param_type(p)) for p in params])
    return decls


def test_every_c_function_is_in_the_table():
    assert set(_declarations()) == set(_build.SIGNATURES)


def test_parser_reads_pointer_int_and_float():
    assert _param_type("const void* q") == "const void*"
    assert _param_type("void *stream") == "void*"
    assert _ctype(_param_type("int bh")) is ctypes.c_int
    assert _ctype(_param_type("float scale")) is ctypes.c_float
    assert _ctype(_param_type("const void* q")) is ctypes.c_void_p


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_declaration(name):
    decls = _declarations()
    assert name in decls, f"{name} is not declared extern \"C\" in csrc/"
    src, restype, argtypes = decls[name]
    want_args, want_res = _build.SIGNATURES[name]
    assert len(want_args) == len(argtypes), (
        f"{name} ({src}) takes {len(argtypes)} arguments, the table gives "
        f"{len(want_args)}")
    for i, (got, want) in enumerate(zip(argtypes, want_args)):
        assert got is want, (f"{name} ({src}) argument {i}: the source "
                             f"needs {got.__name__}, the table has "
                             f"{want.__name__}")
    assert restype is want_res
