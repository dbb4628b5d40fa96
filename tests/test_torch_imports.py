"""The port stands alone: importing paddle_tpu_torch, or chip_smoke.py,
loads neither JAX nor any module of the JAX package, and no source of the
port names them in an import. Without a GPU, building on the default
device raises instead of running on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"


def _foreign(name):
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "paddle_tpu"
            or name.startswith("paddle_tpu."))


def _loaded_after(code):
    """The foreign modules in sys.modules after running `code` in a fresh
    interpreter started at the repo root."""
    probe = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("code", [
    "import paddle_tpu_torch",
    # every module of the port
    "import pkgutil, importlib, paddle_tpu_torch\n"
    "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
    "'paddle_tpu_torch.'):\n"
    "    importlib.import_module(m.name)",
    "import chip_smoke",
], ids=["package", "every_module", "chip_smoke"])
def test_import_loads_no_jax_and_no_reference(code):
    assert _loaded_after(code) == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    if "_build" not in p.relative_to(ROOT).parts))   # build outputs
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _foreign(n)], names


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.models.llama_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.nn.Linear(4, 4)


def test_set_device_cpu_is_honoured():
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        model = pt.models.llama_tiny()
        assert {p.device.type for p in model.parameters()} == {"cpu"}
        assert pt.get_device() == "cpu"
    finally:
        pt.set_device(old)
    assert pt.get_device() == old
