"""The port's GPT generation (the recompute path of `generate`) against
the JAX package's: greedy `generate` token for token with tied and untied
heads, EOS padding and max_new_tokens <= 0, the recompute equal to an
argmax loop, and sampling. Sampled streams draw from torch's generators
and are held only to themselves. The models and ids are
tests/test_torch_gpt.py's (`_pair`, `_ids`, `HEADS`); the file stands
apart so that its reference compiles, one a generated length, run beside
the rest of that file.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu_torch as pt
from paddle_tpu import generation as jgen
from paddle_tpu_torch import generation
from paddle_tpu_torch.framework.random import get_generator
from test_torch_gpt import HEADS, _ids, _pair
from torch_one_thread import one_torch_thread  # noqa: F401


# -- generation: the recompute path ------------------------------------------

def _ref_generate(ref, ids, **kw):
    return np.asarray(jgen.generate(ref, jnp.asarray(ids, jnp.int32),
                                    **kw)._data)


def _port_generate(port, ids, **kw):
    return port.generate(torch.as_tensor(ids), **kw).numpy()


@pytest.mark.parametrize("head,shape,new", [
    ("tied", (1, 4), 3), ("tied", (2, 7), 4), ("untied", (3, 5), 3)])
def test_greedy_matches_reference(head, shape, new):
    ref, port = _pair(seed=1, **HEADS[head])
    ids = np.random.RandomState(1).randint(0, 512, shape)
    want = _ref_generate(ref, ids, max_new_tokens=new)
    got = _port_generate(port, ids, max_new_tokens=new)
    assert got.shape == (shape[0], shape[1] + new)
    np.testing.assert_array_equal(got, want)


def test_eos_padding_matches_reference():
    ref, port = _pair(seed=1)
    ids = _ids(4, (2, 3))
    free = _port_generate(port, ids, max_new_tokens=6)
    eos = int(free[0, 5])    # the 3rd generated token of row 0 acts as EOS
    want = _ref_generate(ref, ids, max_new_tokens=6, eos_token_id=eos)
    got = _port_generate(port, ids, max_new_tokens=6, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5:] == eos).all()


@pytest.mark.parametrize("new", [0, -1])
def test_no_new_tokens_returns_prompt(new):
    ref, port = _pair()
    ids = np.ones((2, 5), np.int64)
    np.testing.assert_array_equal(_port_generate(port, ids,
                                                 max_new_tokens=new),
                                  _ref_generate(ref, ids, max_new_tokens=new))
    np.testing.assert_array_equal(_port_generate(port, ids,
                                                 max_new_tokens=new), ids)


def test_recompute_equals_argmax_loop():
    _, port = _pair()
    ids = torch.as_tensor(_ids(5, (2, 6)))
    out = generation.generate(port, ids, max_new_tokens=5)
    x = ids
    with torch.no_grad():
        for _ in range(5):
            x = torch.cat([x, port(x)[:, -1].argmax(-1)[:, None]], dim=1)
    assert torch.equal(out, x)


def test_greedy_does_not_advance_the_generator():
    _, port = _pair()
    pt.seed(9)
    state = get_generator("cpu").get_state()
    port.generate(torch.ones((1, 3), dtype=torch.long), max_new_tokens=4)
    assert torch.equal(get_generator("cpu").get_state(), state)
    port.generate(torch.ones((1, 3), dtype=torch.long), max_new_tokens=4,
                  do_sample=True)
    assert not torch.equal(get_generator("cpu").get_state(), state)


def test_sampling_is_self_consistent():
    """One seed gives one stream; top_k=1 and a tiny top_p give the greedy
    stream; ids stay in the vocabulary."""
    _, port = _pair()
    ids = torch.ones((2, 4), dtype=torch.long)
    kw = dict(max_new_tokens=5, do_sample=True, temperature=0.8, top_p=0.9)
    a = port.generate(ids, seed=7, **kw)
    assert torch.equal(a, port.generate(ids, seed=7, **kw))
    assert a.shape == (2, 9) and 0 <= a.min() and a.max() < 512
    greedy = port.generate(ids, max_new_tokens=5)
    assert torch.equal(port.generate(ids, max_new_tokens=5, do_sample=True,
                                     top_k=1, temperature=5.0, seed=3),
                       greedy)
    assert torch.equal(port.generate(ids, max_new_tokens=5, do_sample=True,
                                     top_p=1e-6, seed=5), greedy)


def test_generate_rejects_a_model_without_logits():
    """A backbone returns hidden states, not vocabulary logits."""
    _, port = _pair()
    with pytest.raises(TypeError, match="logits"):
        generation.generate(port.gpt, torch.ones((1, 3), dtype=torch.long),
                            max_new_tokens=2)
