"""The port's KV-cache generation against the JAX package's, mirroring
tests/test_generation.py.

Greedy output must equal paddle_tpu.generation.generate token for token in
float32 with the reference's weights carried across. Sampled output draws
from torch's generator, which does not reproduce JAX's bits, so it is held
only to itself under one seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch.convert import load_reference_state
from torch_one_thread import one_torch_thread  # noqa: F401


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = paddle.models.llama_tiny(**kw)
    port = pt.models.llama_tiny(device="cpu", **kw)
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    return ref, port


def _ref_generate(ref, ids, **kw):
    return np.asarray(jgen.generate(ref, jnp.asarray(ids, jnp.int32),
                                    **kw)._data)


def _port_generate(port, ids, **kw):
    return generation.generate(port, torch.as_tensor(ids), **kw).numpy()


def _port_model():
    pt.seed(0)
    return pt.models.llama_tiny(num_hidden_layers=2, device="cpu")


@pytest.mark.parametrize("name,kw,shape,new", [
    ("mha", dict(num_key_value_heads=4), (2, 7), 6),
    ("gqa_tied", dict(num_key_value_heads=2, tie_word_embeddings=True),
     (1, 5), 4),
    ("gqa_untied", dict(num_key_value_heads=2), (3, 6), 5),
])
def test_greedy_matches_reference(name, kw, shape, new):
    ref, port = _pair(seed=1, **kw)
    ids = np.random.RandomState(1).randint(0, 512, shape)
    want = _ref_generate(ref, ids, max_new_tokens=new)
    got = _port_generate(port, ids, max_new_tokens=new)
    assert got.shape == (shape[0], shape[1] + new)
    np.testing.assert_array_equal(got, want)


def test_eos_padding_matches_reference():
    ref, port = _pair()
    ids = np.ones((2, 3), np.int64)
    free = _ref_generate(ref, ids, max_new_tokens=8)
    eos = int(free[0, 5])    # the 3rd generated token of row 0 acts as EOS
    want = _ref_generate(ref, ids, max_new_tokens=8, eos_token_id=eos)
    got = _port_generate(port, ids, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 6:] == eos).all()


def test_zero_max_new_tokens_returns_prompt():
    ref, port = _pair()
    ids = np.ones((2, 5), np.int64)
    np.testing.assert_array_equal(_port_generate(port, ids, max_new_tokens=0),
                                  _ref_generate(ref, ids, max_new_tokens=0))
    np.testing.assert_array_equal(_port_generate(port, ids, max_new_tokens=0),
                                  ids)


def test_kv_cache_matches_recompute_greedy():
    port = _port_model()
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 512, (2, 7)))
    out = generation.generate(port, ids, max_new_tokens=6)
    x = ids
    with torch.no_grad():
        for _ in range(6):
            x = torch.cat([x, port(x)[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(out, x)


def test_sampling_deterministic_with_seed():
    port = _port_model()
    ids = torch.ones((2, 4), dtype=torch.long)
    kw = dict(max_new_tokens=5, do_sample=True, temperature=0.8, top_p=0.9)
    a = generation.generate(port, ids, seed=7, **kw)
    b = generation.generate(port, ids, seed=7, **kw)
    assert torch.equal(a, b)
    assert a.shape == (2, 9) and 0 <= a.min() and a.max() < 512


def test_top_k_one_equals_greedy():
    port = _port_model()
    ids = torch.zeros((1, 3), dtype=torch.long)
    greedy = generation.generate(port, ids, max_new_tokens=4)
    k1 = generation.generate(port, ids, max_new_tokens=4, do_sample=True,
                             top_k=1, temperature=5.0, seed=3)
    assert torch.equal(greedy, k1)


def test_tiny_top_p_equals_greedy():
    """top_p below every probability keeps only the most likely token."""
    port = _port_model()
    ids = torch.zeros((2, 3), dtype=torch.long)
    greedy = generation.generate(port, ids, max_new_tokens=4)
    p = generation.generate(port, ids, max_new_tokens=4, do_sample=True,
                            top_p=1e-6, seed=5)
    assert torch.equal(greedy, p)


def test_model_generate_method_and_type_check():
    port = _port_model()
    ids = torch.ones((1, 4), dtype=torch.long)
    assert torch.equal(port.generate(ids, max_new_tokens=3),
                       generation.generate(port, ids, max_new_tokens=3))
    with pytest.raises(TypeError):
        generation.generate(port.llama, ids)


def test_generic_fallback_gpt_matches_reference():
    """The reference's test_generic_fallback_gpt (tests/test_generation.py
    :101-106) through the port: a model other than Llama takes the
    recompute path and returns the reference's ids (it raised TypeError
    before the path was ported)."""
    paddle.seed(2)
    ref = paddle.models.gpt_tiny()
    port = pt.models.gpt_tiny(device="cpu")
    load_reference_state(port, {k: np.asarray(v._data)
                                for k, v in ref.state_dict().items()})
    ids = np.ones((1, 4), np.int64)
    want = _ref_generate(ref, ids, max_new_tokens=3)
    got = _port_generate(port, ids, max_new_tokens=3)
    assert got.shape == (1, 7)
    np.testing.assert_array_equal(got, want)
