"""The port stands alone: importing paddle_tpu_torch, or chip_smoke.py,
loads neither JAX, nor ml_dtypes (the card's machine has none), nor any
module of the JAX package, and no source of the port names them in an
import. Without a GPU, building on the default device, and each entry
point's default (the engine's model, jit.load, Config/Predictor,
Profiler), raises instead of running on the CPU.
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
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"


def _foreign(name):
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "paddle_tpu"
            or name.startswith("paddle_tpu.") or name == "ml_dtypes"
            or name.startswith("ml_dtypes."))


def _loaded_after(code):
    """The foreign modules in sys.modules after running `code` in a fresh
    interpreter started at the repo root."""
    probe = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))))\n")
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


SUBPACKAGES = [
    "observability", "resilience", "profiler", "inference",
    "inference.serving", "inference.drafting", "inference.adapters",
    "inference.scheduler", "inference.prefix_cache", "ops.paged_attention",
    "nn.quant", "inference.loadgen", "jit", "pir", "pir.analysis",
    "tools.loadgen", "models.bert", "models.gpt", "models._init",
    "nn.functional.activation", "nn.functional.common", "nn.layer.norm",
    "tools.train_bert", "generation", "convert", "vision.models",
    "nn.functional.conv", "nn.functional.pooling", "nn.layer.conv",
    "nn.layer.pooling", "tensor", "tools.train_resnet", "quantization",
    "incubate.nn.layer", "incubate.nn.functional", "tools.bench_decode",
    "sparse", "sparse.nn", "geometric", "distribution", "incubate.asp",
    "incubate.autotune", "incubate.distributed.models.moe", "ops.autotune",
    "utils", "utils.unique_name", "utils.cpp_extension", "static",
    "static.nn_builders", "hub", "onnx", "sysconfig", "version",
    "distributed", "distributed.store", "distributed.parallel_env",
    "distributed.collective", "distributed.communication.stream",
    "distributed.launch", "tools.dashboard", "tools.collective_drill",
    "distributed.placement", "distributed.api", "parallel.spmd",
    "distributed.auto_parallel", "distributed.auto_tuner",
    "distributed.fleet", "distributed.fleet.meta_parallel",
    "distributed.fleet.meta_optimizers", "distributed.fleet.utils",
    "distributed.fleet.utils.sequence_parallel_utils",
    "distributed.fleet.elastic", "distributed.checkpoint", "distributed.io",
    "distributed.sharding", "distributed.parallel"]


@pytest.fixture(scope="module")
def first_loads():
    """One fresh interpreter imports each of SUBPACKAGES in turn and
    records, for each, the foreign modules that appeared during its import
    (under "<start>", those loaded before the first): a subpackage is
    charged with what it, or anything it is the first to import, loads."""
    probe = (
        "import importlib, json, sys\n"
        "def foreign():\n"
        "    return {m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'ml_dtypes')) or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')}\n"
        "seen = foreign()\n"
        "out = {'<start>': sorted(seen)}\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    try:\n"
        "        importlib.import_module('paddle_tpu_torch.' + sub)\n"
        "    except Exception as e:\n"
        "        out[sub] = ['import failed: ' + repr(e)]\n"
        "        continue\n"
        "    now = foreign()\n"
        "    out[sub] = sorted(now - seen)\n"
        "    seen = now\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_serving_subpackages_load_no_jax_and_no_reference(sub, first_loads):
    """Each subpackage, imported in turn in one interpreter: copies of
    jax-free reference modules must not reach back into the reference."""
    assert first_loads["<start>"] == []
    assert first_loads[sub] == []


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


def test_entry_points_default_to_cuda(tmp_path):
    """jit.load and Config/Predictor run on CUDA unless asked for the
    CPU, the Profiler traces CUDA unless its targets name only the CPU,
    and the loadgen CLI builds its engine on CUDA unless --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults work")
    from paddle_tpu_torch import inference, jit, profiler
    from paddle_tpu_torch.tools import loadgen as cli
    model = pt.nn.Linear(4, 2, device="cpu")
    prefix = str(tmp_path / "m")
    jit.save(model, prefix, input_spec=[jit.InputSpec([1, 4], "float32")])
    with pytest.raises(RuntimeError, match="CUDA"):
        jit.load(prefix)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.create_predictor(inference.Config(prefix))
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.Profiler()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_engine()
