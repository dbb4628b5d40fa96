"""Shared helpers of the serving-mesh tests (test_torch_mesh*.py and
test_torch_chaos_drill.py): the reference's tiny Llama and the port's
with the same weights (convert.py), engine factories for both packages,
the tests' prompts, the JSON spec a socket worker builds from, and a
fixture that drops the labelled metric series a test created.

Every pool takes an ephemeral store port (`store_port=0`) and every
listener port 0, so these files bind no fixed port beside the
reference's mesh tests."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=256)
ENG = dict(num_blocks=64, block_size=8, max_batch=2, prefill_buckets=(16,))
# the JSON-safe recipe a socket worker (mesh/worker.py) builds its engine
# from: the port's weights from seed 0, on the CPU, torch on one thread
SPEC = {"seed": 0, "config": CFG, "device": "cpu", "threads": 1,
        "engine": dict(ENG, prefill_buckets=[16])}
# tightened health thresholds: a sub-second stall trips SLOW while DEAD
# stays far out of reach (the reference's tests and drill use the same)
TIGHT = dict(slow_phi=0.5, dead_phi=50.0, slow_elapsed_s=0.1,
             dead_elapsed_s=10.0)

_PAIR = []


def pair():
    """(reference model, port model with the reference's weights), f32."""
    if not _PAIR:
        paddle.seed(0)
        ref = JLlama(JConfig(**CFG))
        port = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
        load_reference_state(port, {k: np.asarray(v._data)
                                    for k, v in ref.state_dict().items()})
        _PAIR.extend((ref, port))
    return _PAIR


def port_model():
    """The port's tiny Llama from seed 0 (what a spec-built worker holds)."""
    pt.seed(0)
    return LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")


def factory(model=None, Engine=ContinuousBatchingEngine, **kw):
    """Zero-arg engine builder over one shared model (every replica holds
    the same weights, the disaggregation precondition)."""
    def build():
        m = model if model is not None else port_model()
        return Engine(m, **dict(ENG, **kw))
    return build


def ref_factory(**kw):
    return factory(pair()[0], JEngine, **kw)


def port_factory(**kw):
    return factory(pair()[1], **kw)


def dense(model, prompt, n):
    """The port's greedy continuation from the dense-cache generate()."""
    out = generation.generate(model, torch.as_tensor(np.asarray(prompt))[None],
                              max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def prompts(n, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (int(s),))
            for s in rs.randint(5, 14, size=n)]


def serve(router, ps, n=8, **kw):
    """Streams of `ps` through `router` (or an engine), in order."""
    rids = [router.add_request(p, max_new_tokens=n, **kw) for p in ps]
    out = router.run()
    return [out[r] for r in rids]


def counter(reg, name, **labels):
    fam = reg.get(name)
    if fam is None:
        return 0.0
    return fam.labels(**labels).value if labels else fam.value


def counter_sum(reg, name):
    fam = reg.get(name)
    if fam is None:
        return 0.0
    return sum(c.value for c in fam.children().values())


@pytest.fixture(autouse=True)
def no_new_series():
    """Leave both packages' registries without the labelled series a test
    created (a run creates them even while the layer is off), so the
    counter sets other files' tests compare do not depend on the order
    the files run in."""
    regs = (obs.get_registry(), jobs.get_registry())
    before = {id(m): set(m._children) for r in regs for m in r.collect()}
    yield
    for m in (m for r in regs for m in r.collect()):
        for key in set(m._children) - before.get(id(m), {()}):
            del m._children[key]


@pytest.fixture
def metrics():
    """The port's registry enabled and clean for one test."""
    reg = obs.get_registry()
    was = reg.enabled
    reg.reset()
    reg.enable()
    try:
        yield reg
    finally:
        reg.reset()
        if not was:
            reg.disable()
