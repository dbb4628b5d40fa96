"""The port's GPT (models/gpt.py) against the JAX package's, with the
reference's weights carried across by paddle_tpu_torch.convert: logits,
the next-token loss and every gradient with tied and untied heads, greedy
`generate` through the recompute path token for token (EOS padding and
max_new_tokens=0 included), attention dropout in training, and the
converter's contract for GPT states. Sampled streams draw from torch's
generators and are held only to themselves.

Inputs come from numpy seeds. float32 parity is within F32_TOL (the same
math summed in other orders; the loss within LOSS_RTOL, the gradients
within GRAD_TOL); bfloat16 within BF16_TOL of the largest |logit|, the
bound tests/test_torch_llama.py holds bf16 to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu.parallel.functional import functional_call as jcall
import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch.convert import load_reference_state, \
    state_from_reference
from paddle_tpu_torch.framework.random import get_generator
from torch_one_thread import one_torch_thread  # noqa: F401

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2

HEADS = {"tied": dict(tie_word_embeddings=True),
         "untied": dict(tie_word_embeddings=False)}


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = paddle.models.gpt_tiny(**kw)
    port = pt.models.gpt_tiny(device="cpu", **kw)
    load_reference_state(port, _np_state(ref))
    return ref, port


def _ids(seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 512, shape)


def _j(a):
    return paddle.Tensor(jnp.asarray(a, jnp.int32))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_state_dict_keys_and_shapes_match_reference(head):
    paddle.seed(0)
    ref = _np_state(paddle.models.gpt_tiny(**HEADS[head]))
    port = pt.models.gpt_tiny(device="cpu", **HEADS[head]).state_dict()
    assert list(port) == list(ref)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}


def test_gpt3_1p3b_config_matches_reference():
    want = paddle.models.GPTConfig(vocab_size=50304, hidden_size=2048,
                                   num_hidden_layers=24,
                                   num_attention_heads=16,
                                   max_position_embeddings=2048).__dict__
    got = pt.models.GPTConfig(vocab_size=50304, hidden_size=2048,
                              num_hidden_layers=24, num_attention_heads=16,
                              max_position_embeddings=2048).__dict__
    assert {k: v for k, v in got.items() if k != "dtype"} == want


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("positions", [False, True])
def test_logits_match_reference(head, positions):
    ref, port = _pair(**HEADS[head])
    ids = _ids()
    pos = np.stack([np.arange(12), np.arange(12) + 5]) if positions else None
    want = ref(_j(ids), None if pos is None else _j(pos))
    with torch.no_grad():
        got = port(torch.as_tensor(ids),
                   None if pos is None else torch.as_tensor(pos))
    assert tuple(got.shape) == (2, 12, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_loss_and_every_gradient_match_reference(head):
    ref, port = _pair(**HEADS[head])
    ids = _ids(1)
    params = {k: v._data for k, v in ref.state_dict().items()}

    def loss_fn(p):
        return jcall(ref, p, jnp.asarray(ids, jnp.int32),
                     labels=jnp.asarray(ids, jnp.int32))[0]
    want_loss, want = jax.value_and_grad(loss_fn)(params)
    imperative, _ = ref(_j(ids), labels=_j(ids))
    loss, logits = port(torch.as_tensor(ids), labels=torch.as_tensor(ids))
    loss.backward()
    for w in (float(want_loss), float(imperative._data)):
        assert abs(loss.item() - w) <= LOSS_RTOL * abs(w)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_bf16_logits_match_reference():
    ref, _ = _pair()
    state = _np_state(ref)
    port = pt.models.gpt_tiny(device="cpu", dtype="bfloat16")
    port.load_state_dict(state_from_reference(state, "cpu", "bfloat16"))
    ids = _ids(2)
    want = jcall(ref, {k: jnp.asarray(v, jnp.bfloat16)
                       for k, v in state.items()},
                 jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = port(torch.as_tensor(ids))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, err


def test_attention_dropout_in_training():
    """dropout > 0: training draws masks from the port's generator (equal
    under one seed, another draw differs); eval is the dropout-free
    model."""
    pt.seed(0)
    port = pt.models.gpt_tiny(device="cpu", dropout=0.2)
    ids = torch.as_tensor(_ids(3))
    with torch.no_grad():
        port.eval()
        plain = port(ids)
        port.train()
        pt.seed(4)
        a, b = port(ids), port(ids)
        pt.seed(4)
        again = port(ids)
    assert torch.equal(a, again) and not torch.equal(a, b)
    assert not torch.allclose(a, plain)
    port.eval()
    with torch.no_grad():
        assert torch.equal(port(ids), plain)


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


# -- convert.py --------------------------------------------------------------

@pytest.mark.parametrize("head", sorted(HEADS))
def test_state_carries_across(head):
    paddle.seed(2)
    np_state = _np_state(paddle.models.gpt_tiny(num_hidden_layers=3,
                                                **HEADS[head]))
    state = state_from_reference(np_state, "cpu", dtype="bfloat16")
    assert list(state) == list(np_state)
    port = pt.models.gpt_tiny(device="cpu", num_hidden_layers=3,
                              dtype="bfloat16", **HEADS[head])
    port.load_state_dict(state)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.float().numpy(), np_state[k], rtol=1e-2,
                                   atol=1e-2, err_msg=k)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
@pytest.mark.parametrize("fn", ["load", "state"])
def test_converter_rejects_bad_state(fault, fn):
    paddle.seed(0)
    np_state = _np_state(paddle.models.gpt_tiny())
    if fault == "missing":
        del np_state["gpt.h.1.attn.out_proj.bias"]
    elif fault == "unexpected":
        np_state["gpt.h.0.attn.rotary.weight"] = np.zeros(32)
    else:
        np_state["gpt.h.0.attn.qkv_proj.weight"] = np.zeros((128, 383))
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err):
        if fn == "load":
            load_reference_state(pt.models.gpt_tiny(device="cpu"), np_state)
        else:
            state_from_reference(np_state, "cpu")
