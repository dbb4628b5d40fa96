"""The port's persistent compile cache (paddle_tpu_torch/pir/cache.py,
serialize.py, pipeline.py) on the CPU: cold then warm, the warm program
equal to the cold one bit for bit (gradients too), a corrupted artifact
caught by its sha256 and recompiled, the LRU cap, the key's inputs, and
injected read/write faults that degrade instead of breaking a compile.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import jit
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import pir
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaDecoderLayer
from paddle_tpu_torch.resilience import faults
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def cache_dir(tmp_path):
    d = str(tmp_path / "pirc")
    prev = _flags.flag_value("compile_cache_dir")
    _flags.set_flags({"compile_cache_dir": d})
    obs.get_registry().reset()
    obs.enable()
    yield d
    obs.disable()
    obs.get_registry().reset()
    _flags.set_flags({"compile_cache_dir": prev})


def _counter(name):
    fam = obs.get_registry().get(name)
    return 0.0 if fam is None else fam.value


def _fn(x, y):
    return (torch.tanh(x @ y).sum(-1) * 2.0,)


def _args():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(4, 8, generator=g), torch.randn(8, 4, generator=g)]


def _block():
    pt.seed(0)
    layer = LlamaDecoderLayer(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        dtype="float32"), device="cpu")
    x = torch.tensor(np.random.RandomState(0).randn(1, 8, 32),
                     dtype=torch.float32)
    return layer, x


def test_cold_miss_then_warm_hit_bit_for_bit(cache_dir):
    layer, x = _block()
    cold_sf = jit.to_static(layer.forward)
    with torch.no_grad():
        cold = cold_sf(x)
    assert cold_sf.last_report.cache == "miss"
    assert len(os.listdir(cache_dir)) == 1
    warm_sf = jit.to_static(layer.forward)      # a new StaticFunction
    with torch.no_grad():
        warm = warm_sf(x)
    rep = warm_sf.last_report
    assert rep.cache == "hit" and rep.fallback is None
    # looked up right after capture: a hit skips verify and the passes
    assert "verify" not in rep.seconds and "passes" not in rep.seconds
    assert rep.pass_report == {}
    assert rep.pattern_counts == cold_sf.last_report.pattern_counts
    assert rep.final_ops == cold_sf.last_report.final_ops
    # the warm program is the artifact's, rebuilt: pt ops included
    assert [op.name for op in rep.program.ops].count("pt.sdpa") == 1
    assert torch.equal(warm, cold)
    assert _counter("compile_cache_hit_total") == 1
    assert _counter("compile_cache_miss_total") == 1
    assert pir.stats_snapshot()["hit"] >= 1


def test_gradients_through_a_warm_hit(cache_dir):
    layer, x = _block()
    jit.to_static(layer.forward)(x)              # seed the artifact
    layer.zero_grad()
    (layer(x) ** 2).sum().backward()
    want = {k: p.grad.clone() for k, p in layer.named_parameters()}
    layer.zero_grad()
    sf = jit.to_static(layer.forward)
    (sf(x) ** 2).sum().backward()
    assert sf.last_report.cache == "hit"
    for k, p in layer.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=1e-6, atol=1e-6,
                                   msg=k)


def test_corrupted_artifact_is_caught_and_recompiled(cache_dir):
    args = _args()
    _, rep0 = pir.compile_flat(_fn, args, name="c")
    assert rep0.cache == "miss"
    path = os.path.join(cache_dir, rep0.key + ".pirc")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    cache = pir.CompileCache(cache_dir)
    with pytest.raises(pir.CompileCacheCorruptionError, match="sha256"):
        cache.get(rep0.key)
    with pytest.warns(RuntimeWarning, match="sha256"):
        fn, rep = pir.compile_flat(_fn, args, name="c")
    assert rep.cache == "miss" and rep.fallback is None
    assert _counter("compile_cache_corrupt_total") == 1
    assert torch.equal(fn(*args)[0], _fn(*args)[0])
    _, rep2 = pir.compile_flat(_fn, args, name="c")
    assert rep2.cache == "hit"


def test_lru_eviction_under_the_size_cap(tmp_path):
    cache = pir.CompileCache(str(tmp_path), max_bytes=3000)
    for i in range(5):
        cache.put(f"k{i}", bytes(1000), meta={"i": i})
        os.utime(cache._path(f"k{i}"), (i, i))   # distinct recency
    assert cache.total_bytes() <= 3000
    assert cache.get("k0") is None and cache.get("k4") is not None


def test_key_depends_on_flags_sharding_and_device():
    base = pir.cache_key("h")
    assert pir.cache_key("h") == base
    assert pir.cache_key("h2") != base
    assert pir.cache_key("h", sharding="dp") != base
    prev = _flags.flag_value("pir_passes")
    try:
        _flags.set_flags({"pir_passes": "fold,dce"})
        assert pir.cache_key("h") != base
    finally:
        _flags.set_flags({"pir_passes": prev})
    assert pir.cache.device_key("cpu") == "cpu"


def test_write_fault_degrades_uncached(cache_dir):
    args = _args()
    with faults.injected_faults("compile.cache_write:1:OSError"):
        with pytest.warns(RuntimeWarning, match="write failed"):
            fn, rep = pir.compile_flat(_fn, args, name="w")
    assert rep.cache.startswith("error:write") and rep.fallback is None
    assert torch.equal(fn(*args)[0], _fn(*args)[0])
    assert os.listdir(cache_dir) == []


def test_read_fault_degrades_to_the_fresh_compile(cache_dir):
    args = _args()
    pir.compile_flat(_fn, args, name="r")
    with faults.injected_faults("compile.cache_read:1:OSError"):
        fn, rep = pir.compile_flat(_fn, args, name="r")
    assert rep.cache.startswith("error:read") and rep.fallback is None
    assert torch.equal(fn(*args)[0], _fn(*args)[0])
    _, rep2 = pir.compile_flat(_fn, args, name="r")
    assert rep2.cache == "hit"


def test_artifact_round_trip_holds_every_op_kind():
    """dumps/loads of a rewritten block (pt.sdpa, pt.fused_region,
    captured ops, constants): the reloaded program is the same program."""
    from paddle_tpu_torch.pir.serialize import dumps, loads
    layer, x = _block()
    names = [k for k, _ in layer.named_parameters()]
    flat = [p.detach() for _, p in layer.named_parameters()] + [x]

    def fn(*leaves):
        return (torch.func.functional_call(
            layer, dict(zip(names, leaves[:-1])), (leaves[-1],)),)

    prog = pir.capture(fn, *flat)[0]
    pir.PassManager.default().run(prog)
    kinds = {op.name for op in prog.ops}
    assert {"pt.sdpa", "pt.fused_region"} <= kinds
    back = loads(dumps(prog))
    assert back.canonical_hash() == prog.canonical_hash()
    assert torch.equal(back.bind(*flat)[0], prog.bind(*flat)[0])


def test_pir_jit_over_pytrees(cache_dir):
    def f(d, scale):
        return {"y": d["a"] @ d["b"] * scale[0], "n": d["a"].sum()}

    pj = pir.pir_jit(f, name="tree")
    a, b = _args()
    out = pj({"a": a, "b": b}, [torch.tensor(2.0)])
    want = f({"a": a, "b": b}, [torch.tensor(2.0)])
    assert pj.report.cache == "miss" and sorted(out) == ["n", "y"]
    assert torch.equal(out["y"], want["y"]) and torch.equal(out["n"],
                                                            want["n"])
