"""The port's beam search (nn/decode.py, F.gather_tree) against the
reference's (paddle_tpu/nn/decode.py, nn/functional/extras.py:355):
gather_tree exactly, the reference's two beam cases
(tests/test_api_surface.py:341-400) in both packages, and an LSTM cell
with the reference's weights (drawn from numpy) copied in: equal
predicted ids, parents and lengths, scores and final states at rtol
1e-5, atol 1e-5."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.nn.decode import BeamSearchDecoder as RefDecoder
from paddle_tpu.nn.decode import dynamic_decode as ref_decode
from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
from torch_seq_parity import copy_weights, ref_np, reference

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def test_gather_tree():
    t, b, k = 5, 3, 4
    ids = RNG.integers(0, 9, (t, b, k)).astype(np.int64)
    parents = RNG.integers(0, k, (t, b, k)).astype(np.int64)
    out = pt.nn.functional.gather_tree(torch.tensor(ids),
                                       torch.tensor(parents))
    want = paddle.nn.functional.gather_tree(paddle.to_tensor(ids),
                                            paddle.to_tensor(parents))
    np.testing.assert_array_equal(out.numpy(), ref_np(want))


class _Table:
    """A cell whose logits are a table's row for each id (states pass
    through), written for either package."""

    def __init__(self, rows, port):
        self.rows, self.port = rows, port

    def __call__(self, ids, states):
        ids = ids.numpy() if self.port else np.asarray(ids._data)
        out = np.stack([self.rows(int(i)) for i in ids])
        return (torch.tensor(out) if self.port else
                paddle.to_tensor(out)), states


def _decode_both(rows, beam, inits, steps):
    outs = []
    for port in (True, False):
        dec_cls, run = ((BeamSearchDecoder, dynamic_decode) if port
                        else (RefDecoder, ref_decode))
        dec = dec_cls(_Table(rows, port), start_token=1, end_token=0,
                      beam_size=beam)
        h = (torch.tensor(inits) if port else paddle.to_tensor(inits))
        out, _, lengths = run(dec, inits={"h": h}, max_step_num=steps)
        outs.append([ref_np(x) if not port else x.numpy()
                     for x in (out.predicted_ids, out.parent_ids,
                               out.scores, lengths)])
    return outs


def test_beam1_follows_the_argmax_chain():
    v = 5
    trans = RNG.standard_normal((v, v)).astype(np.float32) * 3
    port, ref = _decode_both(lambda i: trans[i], 1,
                             np.zeros((2, 3), np.float32), 4)
    cur, chain = 1, []
    for _ in range(4):
        cur = int(np.argmax(trans[cur]))
        chain.append(cur)
        if cur == 0:
            break
    assert port[0][0, :len(chain), 0].tolist() == chain
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_beam2_finds_the_higher_probability_sequence():
    step_logits = {1: np.log(np.array([0.01, 0.54, 0.45], np.float32)),
                   2: np.log(np.array([0.98, 0.01, 0.01], np.float32))}
    punish = np.log(np.array([0.10, 0.45, 0.45], np.float32))
    port, ref = _decode_both(lambda i: step_logits.get(i, punish), 2,
                             np.zeros((1, 2), np.float32), 3)
    best = port[0][0, :, 0]
    assert best[0] == 2 and best[1] == 0
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **TOL)


def _lstm_decoder(nn, vocab, hid, beam, **dd):
    build = (lambda f: f()) if dd else reference
    emb = build(lambda: nn.Embedding(vocab, hid, **dd))
    cell = build(lambda: nn.LSTMCell(hid, hid, **dd))
    out = build(lambda: nn.Linear(hid, vocab, **dd))
    dec_cls = BeamSearchDecoder if dd else RefDecoder
    return (emb, cell, out), dec_cls(cell, 1, 2, beam, embedding_fn=emb,
                                     output_fn=out)


@pytest.mark.parametrize("beam", [1, 3])
def test_lstm_cell_beam_search_matches(beam):
    vocab, hid, b = 7, 8, 2
    ref_parts, ref_dec = _lstm_decoder(paddle.nn, vocab, hid, beam)
    port_parts, port_dec = _lstm_decoder(pt.nn, vocab, hid, beam,
                                         device="cpu")
    for p, r in zip(port_parts, ref_parts):
        copy_weights(p, r)
    with torch.no_grad():
        port_parts[2].weight.mul_(4.0)      # sharper logits: beams finish
    ref_parts[2].weight.set_value(port_parts[2].weight.detach().numpy())
    h0 = RNG.standard_normal((b, hid)).astype(np.float32)
    with torch.no_grad():
        outp, statesp, lenp = dynamic_decode(
            port_dec, inits=(torch.tensor(h0), torch.tensor(h0)),
            max_step_num=6)
    outr, statesr, lenr = ref_decode(
        ref_dec, inits=(paddle.to_tensor(h0), paddle.to_tensor(h0)),
        max_step_num=6)
    np.testing.assert_array_equal(outp.predicted_ids.numpy(),
                                  ref_np(outr.predicted_ids))
    np.testing.assert_array_equal(outp.parent_ids.numpy(),
                                  ref_np(outr.parent_ids))
    np.testing.assert_array_equal(lenp.numpy(), ref_np(lenr))
    np.testing.assert_allclose(outp.scores.numpy(), ref_np(outr.scores),
                               **TOL)
    for a, c in zip(statesp, statesr):
        np.testing.assert_allclose(a.numpy(), ref_np(c), **TOL)
    assert outp.predicted_ids.shape[0] == b
    assert outp.predicted_ids.shape[2] == beam


def test_states_gather_over_nests():
    """Dict, list and tuple states are tiled and gathered by parent."""
    dec = BeamSearchDecoder(lambda ids, s: (torch.zeros(len(ids), 4), s),
                            1, 0, 2)
    inits = {"a": [torch.arange(2.0)], "b": (torch.ones(2, 3),)}
    ids, states, lp, fin = dec.initialize(inits)
    assert states["a"][0].tolist() == [0.0, 0.0, 1.0, 1.0]
    assert isinstance(states["b"], tuple) and states["b"][0].shape == (4, 3)
    assert lp[:, 1:].max() == -1e30 and not fin.any()
    out = dec.step(ids, states, lp, fin)
    assert out[1]["b"][0].shape == (4, 3)
