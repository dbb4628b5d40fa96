"""The port's BERT (models/bert.py) against the JAX package's, with the
reference's weights carried across by paddle_tpu_torch.convert: MLM and
NSP logits, the loss with either label set, the 2-D attention mask,
BertForSequenceClassification, every parameter's gradient against
jax.grad, three AdamW steps of bench.py's CPU BERT configuration through
tools/train_bert, and the converter's contract for BERT states.

Inputs come from numpy seeds. float32 parity is within F32_TOL (the same
math summed in other orders; the loss within LOSS_RTOL of itself, the
gradients within GRAD_TOL); bfloat16 within BF16_TOL of the largest
|logit|, the bound tests/test_torch_llama.py holds bf16 to.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.parallel.functional import functional_call as jcall
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import load_reference_state, \
    state_from_reference
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import train_bert

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 1e-2


def _np_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = paddle.models.bert_tiny(dropout=0.0, **kw)
    port = pt.models.bert_tiny(device="cpu", dropout=0.0, **kw)
    load_reference_state(port, _np_state(ref))
    return ref, port


def _inputs(seed=0, b=2, s=16, vocab=512):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s))
    types = rs.randint(0, 2, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[0, s // 2:] = 0                       # row 0 padded at its end
    mlm = np.where(rs.rand(b, s) < 0.3, rs.randint(0, vocab, (b, s)), -100)
    nsp = rs.randint(0, 2, (b,))
    return ids, types, mask, mlm, nsp


def _j(a):
    return paddle.Tensor(jnp.asarray(a, jnp.int32))


def _t(a):
    return None if a is None else torch.as_tensor(a)


def test_state_dict_keys_and_shapes_match_reference():
    paddle.seed(0)
    ref = _np_state(paddle.models.bert_tiny())
    port = pt.models.bert_tiny(device="cpu").state_dict()
    assert list(port) == list(ref)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in ref.items()}


def test_init_follows_reference_scheme():
    """Truncated N(0, 0.02) on every weight matrix and embedding, zero
    biases, ones/zeros LayerNorm."""
    pt.seed(0)
    state = pt.models.bert_tiny(device="cpu").state_dict()
    emb = state["bert.embeddings.word_embeddings.weight"]
    assert emb.abs().max() <= 0.04 and 0.015 < emb.std() < 0.02
    assert state["bert.encoder.1.ffn1.weight"].abs().max() <= 0.04
    assert not state["bert.encoder.0.q.bias"].any()
    assert torch.equal(state["mlm_norm.weight"], torch.ones(128))


@pytest.mark.parametrize("types,masked", [(False, False), (True, False),
                                          (True, True)],
                         ids=["ids", "token_types", "mask_2d"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_logits_match_reference(types, masked, training):
    ref, port = _pair()
    if not training:
        ref.eval()
        port.eval()
    ids, tt, mask, _, _ = _inputs()
    tt = tt if types else None
    mask = mask if masked else None
    want = ref(_j(ids), None if tt is None else _j(tt),
               attention_mask=None if mask is None else _j(mask))
    with torch.no_grad():
        got = port(_t(ids), _t(tt), attention_mask=_t(mask))
    for g, w, shape in zip(got, want, [(2, 16, 512), (2, 2)]):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_mask_changes_the_output():
    """The 2-D mask reaches attention: masked keys change row 0 only."""
    _, port = _pair()
    ids, _, mask, _, _ = _inputs()
    with torch.no_grad():
        free = port(_t(ids))[0]
        masked = port(_t(ids), attention_mask=_t(mask))[0]
    assert not torch.allclose(free[0], masked[0], atol=1e-3)
    assert torch.allclose(free[1], masked[1], atol=1e-6)


@pytest.mark.parametrize("nsp", [False, True], ids=["mlm", "mlm_nsp"])
def test_loss_matches_reference(nsp):
    ref, port = _pair()
    ids, tt, mask, mlm, nsp_labels = _inputs()
    kw = dict(masked_lm_labels=mlm)
    if nsp:
        kw["next_sentence_labels"] = nsp_labels
    want, want_logits = ref(_j(ids), _j(tt), attention_mask=_j(mask),
                            **{k: _j(v) for k, v in kw.items()})
    with torch.no_grad():
        got, logits = port(_t(ids), _t(tt), attention_mask=_t(mask),
                           **{k: _t(v) for k, v in kw.items()})
    want = float(want._data)
    assert abs(got.item() - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits._data),
                               rtol=F32_TOL, atol=F32_TOL)


@functools.lru_cache(maxsize=None)
def _reference_grads():
    ref, _ = _pair()
    ids, tt, mask, mlm, nsp = _inputs()
    params = {k: v._data for k, v in ref.state_dict().items()}

    def loss_fn(p):
        out = jcall(ref, p, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(tt, jnp.int32),
                    attention_mask=jnp.asarray(mask, jnp.int32),
                    masked_lm_labels=jnp.asarray(mlm, jnp.int32),
                    next_sentence_labels=jnp.asarray(nsp, jnp.int32))
        return out[0]
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_every_gradient_matches_jax_grad():
    want_loss, want = _reference_grads()
    _, port = _pair()
    ids, tt, mask, mlm, nsp = _inputs()
    loss, _ = port(_t(ids), _t(tt), attention_mask=_t(mask),
                   masked_lm_labels=_t(mlm), next_sentence_labels=_t(nsp))
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("labels", [False, True])
def test_sequence_classification_matches_reference(labels):
    cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64, dropout=0.0)
    paddle.seed(1)
    ref = paddle.models.BertForSequenceClassification(
        paddle.models.BertConfig(**cfg), num_classes=3)
    port = pt.models.BertForSequenceClassification(
        pt.models.BertConfig(**cfg), num_classes=3, device="cpu")
    load_reference_state(port, _np_state(ref))
    ids, tt, mask, _, _ = _inputs(2, s=12, vocab=256)
    y = np.array([2, 0])
    want = ref(_j(ids), _j(tt), attention_mask=_j(mask),
               labels=_j(y) if labels else None)
    with torch.no_grad():
        got = port(_t(ids), _t(tt), attention_mask=_t(mask),
                   labels=_t(y) if labels else None)
    if labels:
        assert abs(got[0].item() - float(want[0]._data)) <= \
            LOSS_RTOL * abs(float(want[0]._data))
        got, want = got[1], want[1]
    assert tuple(got.shape) == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=F32_TOL, atol=F32_TOL)


def test_bf16_logits_match_reference():
    """bf16 weights and activations on both sides, the reference's weights
    cast as bench.py casts them (`_functional_train_setup`)."""
    ref, _ = _pair()
    state = _np_state(ref)
    port = pt.models.bert_tiny(device="cpu", dropout=0.0, dtype="bfloat16")
    port.load_state_dict(state_from_reference(state, "cpu", "bfloat16"))
    ids, tt, mask, _, _ = _inputs()
    params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in state.items()}
    want = jcall(ref, params, jnp.asarray(ids, jnp.int32),
                 jnp.asarray(tt, jnp.int32),
                 attention_mask=jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        got = port(_t(ids), _t(tt), attention_mask=_t(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= BF16_TOL, err


# -- the training tool: bench.py's BERT step -------------------------------

def test_three_adamw_steps_match_bench():
    """bench.py's CPU BERT configuration (:302-305) for three AdamW steps
    at lr 1e-4: its own `_functional_train_setup` and `_jit_train_step` on
    the reference model, and tools/train_bert's TrainStep on the same
    weights; the same ids and MLM labels from RandomState(0); equal losses
    at every step."""
    import bench
    from paddle_tpu import optimizer as joptim
    cfg, batch, seq, steps, dtype = train_bert.bench_config("cpu")
    assert (batch, seq, steps, dtype) == (2, 64, 2, "float32")
    paddle.seed(0)
    ref = paddle.models.BertForPretraining(paddle.models.BertConfig(
        **{k: v for k, v in cfg.__dict__.items() if k != "dtype"}))
    state = _np_state(ref)
    train = train_bert.TrainStep(cfg, batch, seq, dtype, "cpu")
    load_reference_state(train.model, state)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    labels = np.where(rng.rand(batch, seq) < 0.15,
                      rng.randint(0, cfg.vocab_size, (batch, seq)), -100)
    assert np.array_equal(train.ids.numpy(), ids)
    assert np.array_equal(train.labels.numpy(), labels)

    opt = joptim.AdamW(1e-4, parameters=ref.parameters())
    params, opt_state = bench._functional_train_setup(ref, opt, False)

    def loss_fn(p, x, y):
        return jcall(ref, p, x, masked_lm_labels=y)[0].astype(jnp.float32)
    jstep = bench._jit_train_step(opt, loss_fn)
    want = []
    for n in (1, 2, 3):
        loss, params, opt_state = jstep(
            params, opt_state, jnp.asarray(ids, jnp.int32),
            jnp.asarray(labels, jnp.int32), jnp.float32(1e-4), jnp.int32(n))
        want.append(float(loss))
    got = [train.step(n).item() for n in (1, 2, 3)]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
    assert got[-1] < got[0]


def test_run_one_on_the_cpu():
    """bench.py's keys, losses that fall, no kernel launch on the CPU, no
    MFU or device memory off the card."""
    before = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
              fa.flash_bwd_dkv_launches)
    cfg, batch, seq, steps, dtype = train_bert.bench_config("cpu")
    r = train_bert.run_one(cfg, batch, seq, steps, dtype, device="cpu")
    assert {"bert_tokens_per_s", "bert_params", "bert_loss", "bert_batch",
            "bert_seq", "bert_base_mfu"} <= set(r)
    assert (r["bert_batch"], r["bert_seq"]) == (2, 64)
    assert len(r["losses"]) == steps + 1 and r["losses"][-1] < r["losses"][0]
    assert r["bert_loss"] == r["losses"][-1]
    assert r["bert_base_mfu"] is None and r["peak_memory_bytes"] is None
    assert r["bert_params"] == sum(
        p.numel() for p in pt.models.BertForPretraining(
            cfg, device="cpu").parameters())
    assert r["launches_per_step"] == [{"flash_fwd": 0, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0}] * steps
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == before


def test_train_bert_defaults_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    monkeypatch.setattr("sys.argv", ["train_bert"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bert.main()


# -- convert.py --------------------------------------------------------------

def _cls_state():
    paddle.seed(3)
    return _np_state(paddle.models.BertForSequenceClassification(
        paddle.models.BertConfig(vocab_size=64, hidden_size=32,
                                 num_hidden_layers=3, num_attention_heads=2,
                                 intermediate_size=48), num_classes=5))


@pytest.mark.parametrize("head", ["pretraining", "classification"])
def test_state_carries_across(head):
    if head == "pretraining":
        paddle.seed(2)
        np_state = _np_state(paddle.models.bert_tiny())
        port = pt.models.bert_tiny(device="cpu", dtype="bfloat16")
    else:
        np_state = _cls_state()
        port = pt.models.BertForSequenceClassification(
            pt.models.BertConfig(vocab_size=64, hidden_size=32,
                                 num_hidden_layers=3, num_attention_heads=2,
                                 intermediate_size=48, dtype="bfloat16"),
            num_classes=5, device="cpu")
    state = state_from_reference(np_state, "cpu", dtype="bfloat16")
    assert list(state) == list(np_state)
    port.load_state_dict(state)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.float().numpy(), np_state[k], rtol=1e-2,
                                   atol=1e-2, err_msg=k)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
@pytest.mark.parametrize("fn", ["load", "state"])
def test_converter_rejects_bad_state(fault, fn):
    paddle.seed(0)
    np_state = _np_state(paddle.models.bert_tiny())
    if fault == "missing":
        del np_state["bert.encoder.1.attn_norm.bias"]
    elif fault == "unexpected":
        np_state["bert.encoder.0.q.extra"] = np.zeros(128)
    else:
        np_state["bert.encoder.0.ffn2.weight"] = np.zeros((255, 128))
    err = ValueError if fault == "shape" else KeyError
    with pytest.raises(err):
        if fn == "load":
            load_reference_state(pt.models.bert_tiny(device="cpu"), np_state)
        else:
            state_from_reference(np_state, "cpu")
