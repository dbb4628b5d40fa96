"""The port's paddle.text (text/__init__.py) against the reference's
(paddle_tpu/text/__init__.py): viterbi_decode and ViterbiDecoder with and
without the BOS/EOS tags, on ragged lengths (scores at rtol 1e-6, atol
1e-5, paths exactly), and every synthetic dataset array-equal item for
item, in both modes."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from torch_seq_parity import ref_np
from torch_one_thread import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decode(bos_eos):
    b, t, n = 4, 6, 5
    emis = RNG.standard_normal((b, t, n)).astype(np.float32)
    trans = RNG.standard_normal((n, n)).astype(np.float32)
    lengths = np.array([6, 3, 1, 5], np.int64)
    sp, pp = pt.text.viterbi_decode(torch.tensor(emis), torch.tensor(trans),
                                    torch.tensor(lengths), bos_eos)
    sr, pr = paddle.text.viterbi_decode(
        paddle.to_tensor(emis), paddle.to_tensor(trans),
        paddle.to_tensor(lengths), bos_eos)
    np.testing.assert_allclose(sp.numpy(), ref_np(sr), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(pp.numpy(), ref_np(pr))
    assert pp.dtype == torch.int64
    dec = pt.text.ViterbiDecoder(torch.tensor(trans), bos_eos)
    assert isinstance(dec, pt.nn.Layer)
    s2, p2 = dec(torch.tensor(emis), torch.tensor(lengths))
    torch.testing.assert_close(p2, pp, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", ["Imdb", "Imikolov", "Movielens",
                                  "UCIHousing", "WMT14", "WMT16",
                                  "Conll05st"])
def test_datasets_equal_the_reference(name, mode):
    port = getattr(pt.text, name)(mode=mode)
    ref = getattr(paddle.text, name)(mode=mode)
    assert isinstance(port, pt.io.Dataset)
    assert len(port) == len(ref)
    for i in (0, len(ref) // 2, len(ref) - 1):
        for a, c in zip(port[i], ref[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
