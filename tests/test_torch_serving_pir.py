"""The serving engine compiled through pir_jit, and the mesh's TP replicas,
on the CPU.

The warm-start case is the reference's own (tests/test_pir.py:535-565):
the first engine's prefill.b16 compiles cold ("miss") and its decode
donates the pool ("bypass:donate"); a second engine over the same
FLAGS_compile_cache_dir loads the prefill artifact ("hit"), and both
engines' greedy tokens equal the reference engine's token for token, on
the reference's weights (f32, an exact comparison of token ids).
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.mesh import MeshRouter, ReplicaPool
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.pir.pipeline import CompileReport
from torch_mesh_parity import (dense, no_new_series, pair,  # noqa: F401
                               port_factory, prompts, serve)
from torch_one_thread import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
KNOBS = dict(num_blocks=32, block_size=8, max_batch=2, prefill_buckets=(16,))
_MODELS = []


def _models():
    """(reference model, port model with its weights), as the reference
    test builds it (paddle.seed(0))."""
    if not _MODELS:
        paddle.seed(0)
        ref = JLlama(JConfig(**CFG))
        port = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _MODELS.extend((ref, port))
    return _MODELS


@pytest.fixture
def cache_dir(tmp_path):
    """One compile-cache directory for both packages."""
    from paddle_tpu.framework import flags as jflags
    d = str(tmp_path / "pirc")
    prev, jprev = (_flags.flag_value("compile_cache_dir"),
                   jflags.flag_value("compile_cache_dir"))
    _flags.set_flags({"compile_cache_dir": d})
    paddle.set_flags({"compile_cache_dir": d})
    yield d
    _flags.set_flags({"compile_cache_dir": prev})
    paddle.set_flags({"compile_cache_dir": jprev})


def _run(Engine, model, prompt, n=4, **kw):
    eng = Engine(model, **dict(KNOBS, **kw))
    rid = eng.add_request(prompt, max_new_tokens=n)
    return eng, eng.run()[rid]


def test_engine_prefill_warm_start_and_decode_bypass(cache_dir):
    ref, port = _models()
    prompt = np.arange(6) % 64
    _, want = _run(JEngine, ref, prompt)
    eng1, toks1 = _run(ContinuousBatchingEngine, port, prompt)
    rep_p1 = eng1.compile_reports["prefill.b16"]
    assert isinstance(rep_p1, CompileReport) and rep_p1.cache == "miss"
    assert rep_p1.name == "serving.prefill.b16"
    rep_d = eng1.compile_reports["decode"]
    assert rep_d.cache == "bypass:donate" and rep_d.fallback is None
    eng2, toks2 = _run(ContinuousBatchingEngine, port, prompt)
    assert eng2.compile_reports["prefill.b16"].cache == "hit"
    assert toks1 == toks2 == want


def test_flag_off_runs_the_functions_as_written():
    """With FLAGS_pir off the engine runs its functions as written (no
    capture, no price), as the reference's pir_jit does: same tokens."""
    ref, port = _models()
    prompt = np.arange(11) % 64
    _, want = _run(ContinuousBatchingEngine, port, prompt, n=5)
    _flags.set_flags({"pir": False})
    try:
        eng, got = _run(ContinuousBatchingEngine, port, prompt, n=5)
    finally:
        _flags.set_flags({"pir": True})
    assert got == want
    assert {r.cache for r in eng.compile_reports.values()} == {"disabled"}
    assert eng.predicted_costs() == {}


def test_one_program_per_chunk_width_and_per_decode_family():
    """A chunk's offset, last position and adapter slot are tensors: a
    prompt of several 16-wide chunks compiles one prefill program, and
    the decode step program serves every decode_steps."""
    _, port = _models()
    eng = ContinuousBatchingEngine(port, **dict(KNOBS, num_blocks=64))
    rid = eng.add_request(np.arange(45) % 64, max_new_tokens=6)
    eng.run()
    assert sorted(eng._programs) == [("decode", 0), ("prefill", 16)]
    assert eng._programs[("prefill", 16)].report.captured_ops > 0
    eng._set_decode_steps(1)
    rid2 = eng.add_request(np.arange(9) % 64, max_new_tokens=3)
    out = eng.run()
    assert sorted(eng._programs) == [("decode", 0), ("prefill", 16)]
    assert eng.finished[rid].generated and len(out[rid2]) == 3


def test_compile_reports_feed_the_calibration():
    """compile_reports hold the CompileReports; the calibration reads
    their .cost and predicts once a dispatch measured each kind."""
    _, port = _models()
    eng = ContinuousBatchingEngine(port, **KNOBS)
    for n in (7, 9, 12):
        eng.add_request(np.arange(n) % 64, max_new_tokens=6)
    eng.run()
    costs = eng.predicted_costs()
    assert set(costs) == {"prefill.b16", "decode"}
    assert all(c["raw_seconds"] == eng.compile_reports[k].cost.raw_seconds
               for k, c in costs.items())
    assert eng.predicted_service_seconds(8) > 0


def test_tp_replicas_serve_the_plain_tokens():
    """ReplicaPool(tp=True) serves tp=False's greedy tokens; as in the
    reference, the scope closes before the lazy compiles, so each program
    compiles unannotated (shard_prop declines with no-annotations)."""
    ps = prompts(2)
    got = {}
    for tp in (False, True):
        pool = ReplicaPool(port_factory(), n=2, tp=tp, store_port=0)
        got[tp] = serve(MeshRouter(pool), ps, n=5)
        for rep in pool.replicas:
            for key, report in rep.engine.compile_reports.items():
                notes = report.pass_report["shard_prop"]["notes"]
                assert notes == "no-annotations", (tp, key, notes)
    assert got[True] == got[False] == [dense(pair()[1], p, 5) for p in ps]
