"""paddle.text. reference: paddle_tpu/text/__init__.py (all of it):
`viterbi_decode` and `ViterbiDecoder`, and the synthetic datasets (`Imdb`,
`Imikolov`, `Movielens`, `UCIHousing`, `WMT14`, `WMT16`, `Conll05st`),
whose numpy arrays are the reference's, drawn from the same seeds.

`viterbi_decode` walks time on the host in plain torch, batched over
sentences: at each step the best previous tag for every tag, the path
kept as back-pointers, then traced back from the best last tag.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import Dataset
from ..nn.layer.layers import Layer

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16",
           "Conll05st", "ViterbiDecoder", "viterbi_decode"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """(scores (B,), int64 paths (B, T)) of the highest-scoring tag paths.
    potentials (B, T, N) are the emissions, transition_params (N, N) the
    scores of tag i followed by tag j, lengths (B,) each sentence's
    length; past it a path repeats its tag. With `include_bos_eos_tag`,
    tag N-2 is BOS and N-1 EOS: paths start from BOS's transitions, may
    not start on BOS or EOS (-1e4), and end with the transition to EOS."""
    emis, trans = potentials, transition_params
    B, T, N = emis.shape
    if include_bos_eos_tag:
        bos_mask = torch.full((N,), -1e4, dtype=emis.dtype,
                              device=emis.device)
        bos_mask[:N - 2] = 0.0
        alpha = emis[:, 0] + trans[N - 2][None, :] + bos_mask[None, :]
    else:
        alpha = emis[:, 0]
    keep_tag = torch.arange(N, device=emis.device).expand(B, N)
    backptrs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :]
        best_prev = torch.argmax(scores, dim=1)
        best_score = torch.amax(scores, dim=1)
        active = (t < lengths)[:, None]
        alpha = torch.where(active, best_score + emis[:, t], alpha)
        backptrs.append(torch.where(active, best_prev, keep_tag))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, N - 1][None, :]
    score, tag = torch.amax(alpha, dim=1), torch.argmax(alpha, dim=1)
    path = [tag]
    for bp in reversed(backptrs):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    return score, torch.stack(path[::-1], 1).long()


class ViterbiDecoder(Layer):
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


# ---------------------------------------------------------------------------
# datasets: the reference's numpy, line for line
# ---------------------------------------------------------------------------

class Imdb(Dataset):
    """reference: python/paddle/text/datasets/imdb.py (binary sentiment)."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n, vocab, seqlen = 512, 5000, 100
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        # class-dependent token distribution so models can learn
        self.docs = [
            rng.randint(lbl * vocab // 4, vocab // 2 + lbl * vocab // 4,
                        seqlen).astype(np.int64)
            for lbl in self.labels]

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Imikolov(Dataset):
    """reference: python/paddle/text/datasets/imikolov.py (n-gram LM)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        rng = np.random.RandomState(2 if mode == "train" else 3)
        n, vocab = 1024, 2000
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        self.window_size = window_size
        self.data = rng.randint(0, vocab, (n, window_size)).astype(np.int64)

    def __getitem__(self, idx):
        return tuple(self.data[idx])

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """reference: python/paddle/text/datasets/movielens.py."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        rng = np.random.RandomState(rand_seed + (0 if mode == "train" else 1))
        n = 1024
        self.user_ids = rng.randint(0, 943, n).astype(np.int64)
        self.movie_ids = rng.randint(0, 1682, n).astype(np.int64)
        self.ratings = rng.randint(1, 6, n).astype(np.float32)

    def __getitem__(self, idx):
        return (self.user_ids[idx], self.movie_ids[idx], self.ratings[idx])

    def __len__(self):
        return len(self.ratings)


class UCIHousing(Dataset):
    """reference: python/paddle/text/datasets/uci_housing.py (13-feat regression)."""

    def __init__(self, data_file=None, mode="train"):
        rng = np.random.RandomState(4 if mode == "train" else 5)
        n = 404 if mode == "train" else 102
        w = np.random.RandomState(99).randn(13).astype(np.float32)
        self.features = rng.randn(n, 13).astype(np.float32)
        self.prices = (self.features @ w + 22.5
                       + 0.5 * rng.randn(n)).astype(np.float32)[:, None]

    def __getitem__(self, idx):
        return self.features[idx], self.prices[idx]

    def __len__(self):
        return len(self.prices)


class _SyntheticTranslation(Dataset):
    def __init__(self, mode, dict_size, seed):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n, seqlen = 512, 20
        self.dict_size = max(dict_size, 100)
        self.src = rng.randint(3, self.dict_size, (n, seqlen)).astype(np.int64)
        # toy task: target = source shifted by one vocab id
        self.trg = np.minimum(self.src + 1, self.dict_size - 1)

    def __getitem__(self, idx):
        src = self.src[idx]
        trg = self.trg[idx]
        return src, trg[:-1], trg[1:]

    def __len__(self):
        return len(self.src)


class WMT14(_SyntheticTranslation):
    """reference: python/paddle/text/datasets/wmt14.py."""

    def __init__(self, data_file=None, mode="train", dict_size=30000):
        super().__init__(mode, dict_size, seed=6)


class WMT16(_SyntheticTranslation):
    """reference: python/paddle/text/datasets/wmt16.py."""

    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en"):
        super().__init__(mode, src_dict_size, seed=8)


class Conll05st(Dataset):
    """reference: python/paddle/text/datasets/conll05.py (SRL)."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 mode="train"):
        rng = np.random.RandomState(12 if mode == "train" else 13)
        n, seqlen = 256, 30
        self.word_vocab, self.label_vocab = 5000, 67
        self.words = rng.randint(0, self.word_vocab, (n, seqlen)).astype(np.int64)
        self.predicates = rng.randint(0, 3000, (n,)).astype(np.int64)
        self.labels = rng.randint(0, self.label_vocab, (n, seqlen)).astype(np.int64)

    def get_dict(self):
        return ({f"w{i}": i for i in range(self.word_vocab)},
                {f"v{i}": i for i in range(3000)},
                {f"l{i}": i for i in range(self.label_vocab)})

    def __getitem__(self, idx):
        return self.words[idx], self.predicates[idx], self.labels[idx]

    def __len__(self):
        return len(self.words)
