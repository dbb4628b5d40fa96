"""The sequence-model slice as a whole: chip_smoke.py's phase-20 models,
written once against a package `P`, built from the JAX package and from
the port at a small size (2 + 2 layers, d32; a 16-unit seq2seq), the
reference's weights (drawn from numpy) copied into the port. One training
step each with equal loss and gradients (rtol 1e-5, atol 1e-5; 2e-5 for
the gradients; the reference's through its jitted functional_call), and
one beam decode of the seq2seq with equal predicted ids, parents and
lengths. (The optimizers' and clips' own tests hold their updates to the
reference.) Then phase 20's check of the card's beams, the CPU forced
along a recorded decode (ReplayBeamSearch), on a CPU decode of its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from torch_seq_parity import assert_grads_close, copy_weights, ref_np, \
    ref_run, reference
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-5, atol=2e-5)
# the seq2seq: 6 sentences of 6 tokens in training, 2 of them decoded at
# beam 3, so the decoder cell sees 6 rows in both
SRC_V = TGT_V = 32
S2S_B, S2S_LEN, BEAM = 6, 6, 3


@pytest.fixture
def on_cpu():
    prev = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def _build(make):
    ref = reference(lambda: make(paddle))
    port = make(pt)
    return copy_weights(port, ref), ref


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(3, vocab, shape)


def _step_matches(port, ref, loss_fn, src, tgt):
    """loss_fn(P, model, src, tgt_in, labels)'s value and gradients, the
    port's by its backward and the reference's by jax.grad."""
    loss_p = loss_fn(pt, port, torch.tensor(src), torch.tensor(tgt[:, :-1]),
                     torch.tensor(tgt[:, 1:]))
    loss_p.backward()

    def calls(f):
        model = lambda a, b: RefTensor(f(a, b))
        return loss_fn(paddle, model, src, tgt[:, :-1],
                       RefTensor(jnp.asarray(tgt[:, 1:])))._data

    loss_r, grads = ref_run(ref, calls, loss=lambda loss: loss)
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r), **TOL)
    assert_grads_close(port, grads, **GTOL)


def test_transformer_step(on_cpu):
    vocab = 50
    port, ref = _build(lambda P: cs.transformer_mt(P, vocab, 32, 4, 2, 64,
                                                   0.0, 9))
    assert list(port.state_dict()) == list(ref.state_dict())
    src, tgt = _tokens(0, (2, 8), vocab), _tokens(1, (2, 9), vocab)
    _step_matches(port, ref, cs.transformer_loss, src, tgt)


def _seq2seq():
    return _build(lambda P: cs.lstm_seq2seq(P, SRC_V, TGT_V, 16, 0.0))


def test_seq2seq_step_and_beam(on_cpu):
    port, ref = _seq2seq()
    assert list(port.state_dict()) == list(ref.state_dict())
    src = _tokens(2, (S2S_B, S2S_LEN), SRC_V)
    tgt = _tokens(3, (S2S_B, S2S_LEN + 1), TGT_V)
    _step_matches(port, ref, cs.seq2seq_loss, src, tgt)
    with torch.no_grad():
        # sharper logits, so that beams end before max_step_num
        port.project.weight.mul_(20.0)
    ref.project.weight.set_value(port.project.weight.detach().numpy())
    port.eval()
    ref.eval()
    sents = src[:S2S_B // BEAM]
    with torch.no_grad():
        outp, lenp = cs.beam_decode(pt, port, torch.tensor(sents), BEAM, 8)
    outr, lenr = cs.beam_decode(paddle, ref, paddle.to_tensor(sents), BEAM,
                                8)
    np.testing.assert_array_equal(outp.predicted_ids.numpy(),
                                  ref_np(outr.predicted_ids))
    np.testing.assert_array_equal(outp.parent_ids.numpy(),
                                  ref_np(outr.parent_ids))
    np.testing.assert_array_equal(lenp.numpy(), ref_np(lenr))
    np.testing.assert_allclose(outp.scores.numpy(), ref_np(outr.scores),
                               **TOL)


def test_divergence_report():
    """chip_smoke's step-by-step comparison of two beam searches."""
    a = [(torch.tensor([[1, 2]]), torch.tensor([[0, 0]]),
          torch.tensor([[-1.0, -2.0]]))] * 2
    b = [a[0], (torch.tensor([[2, 1]]), torch.tensor([[0, 0]]),
                torch.tensor([[-1.0, -1.00001]]))]
    assert cs.first_divergence(a, a) is None
    step, gap, mag = cs.first_divergence(a, b)
    assert step == 1 and gap == pytest.approx(0.99999, rel=1e-5)
    assert mag == pytest.approx(1.00001, rel=1e-6)


def test_replay_holds_each_step(on_cpu):
    """ReplayBeamSearch forced along a decode's own record gives its ids,
    parents and lengths with no score gap and no tie; a recorded score
    moved by 1e-3 shows as a 1e-3 score gap at its step, and a recorded
    extension the decoder ranks below its own top-k as a tie gap."""
    pt.seed(0)
    model = cs.lstm_seq2seq(pt, SRC_V, TGT_V, 16, 0.0).eval()
    src = torch.tensor(_tokens(4, (2, S2S_LEN), SRC_V))
    with torch.no_grad():
        out, lengths, record = cs.RecordingBeamSearch.run(model, src, BEAM,
                                                          6)
        re_out, re_len, score_gaps, tie_gaps = cs.ReplayBeamSearch.run(
            model, src, record, BEAM, 6)
        assert len(score_gaps) == len(record)
        assert torch.equal(re_out.predicted_ids, out.predicted_ids)
        assert torch.equal(re_out.parent_ids, out.parent_ids)
        assert torch.equal(re_len, lengths)
        assert max(score_gaps) == 0.0 and max(tie_gaps) == 0.0
        moved = list(record)
        token, parent, top = moved[2]
        moved[2] = (token, parent, top + torch.tensor([1e-3, 0.0, 0.0]))
        _, _, score_gaps, tie_gaps = cs.ReplayBeamSearch.run(
            model, src, moved, BEAM, 6)
        assert score_gaps[2] == pytest.approx(1e-3, rel=1e-3)
        assert max(score_gaps[:2]) == 0.0 and max(tie_gaps) == 0.0
        # the last beam's token swapped for the (beam + 1)-th extension
        swapped = list(record)
        token, parent, top = swapped[0]
        token = token.clone()
        token[:, -1] = (token[:, -1] + 1) % TGT_V
        swapped[0] = (token, parent, top)
        _, _, score_gaps, tie_gaps = cs.ReplayBeamSearch.run(
            model, src, swapped, BEAM, 6)
        assert tie_gaps[0] > 0.0 and score_gaps[0] > 0.0
