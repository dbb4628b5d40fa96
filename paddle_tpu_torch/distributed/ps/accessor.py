"""Sparse-table accessors: per-row optimizer rules and the CTR statistics
config. reference: paddle_tpu/distributed/ps/accessor.py (the rules
:71-146, `CtrAccessor` :149, the entry gates :170-214), after
paddle/fluid/distributed/ps/table/sparse_sgd_rule.cc and ctr_accessor.cc.

A rule is a small config object whose id selects the native update in
csrc/ps_table.cc (apply_rule); the numpy implementations here are the
executable specification: the path a table takes without the native
store, and the oracle its tests compare against.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SparseNaiveSGDRule", "SparseAdaGradRule", "SparseAdamRule",
           "CtrAccessor", "CountFilterEntry", "ProbabilityEntry",
           "ShowClickEntry"]

_M64 = (1 << 64) - 1


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64, state


def deterministic_init_batch(feature_ids: np.ndarray, emb_dim: int,
                             initial_range: float) -> np.ndarray:
    """Vectorized bit-exact mirror of csrc/ps_table.cc's init_row: one
    splitmix64 stream per feature id -> uniform[-initial_range,
    initial_range). A never-pushed id pulls identical weights on every
    server and across save/load. Vectorized over ids (the probationary-pull hot path must
    not pay a per-id, per-dim Python loop)."""
    ids = np.asarray(feature_ids, np.uint64).reshape(-1)
    out = np.empty((ids.size, emb_dim), np.float32)
    s = ids ^ np.uint64(0xA5A5A5A55A5A5A5A)
    with np.errstate(over="ignore"):
        for d in range(emb_dim):
            s = s + np.uint64(0x9E3779B97F4A7C15)
            z = s ^ (s >> np.uint64(30))
            z = z * np.uint64(0xBF58476D1CE4E5B9)
            z ^= z >> np.uint64(27)
            z = z * np.uint64(0x94D049BB133111EB)
            z ^= z >> np.uint64(31)
            u = (z >> np.uint64(40)).astype(np.float32) / \
                np.float32(1 << 24)
            out[:, d] = (np.float32(2.0) * u - np.float32(1.0)) * \
                np.float32(initial_range)
    return out


def deterministic_init(feature_id: int, emb_dim: int,
                       initial_range: float) -> np.ndarray:
    """Scalar flavor of deterministic_init_batch (the executable spec the
    tests pin against the native store)."""
    s = int(feature_id) ^ 0xA5A5A5A55A5A5A5A
    out = np.empty(emb_dim, np.float32)
    for d in range(emb_dim):
        r, s = _splitmix64(s)
        u = np.float32(r >> 40) / np.float32(1 << 24)
        out[d] = (np.float32(2.0) * u - np.float32(1.0)) * \
            np.float32(initial_range)
    return out


class _RuleBase:
    rule_id: int = -1

    def __init__(self, learning_rate: float = 0.05,
                 initial_range: float = 0.0001, eps: float = 1e-8,
                 beta1: float = 0.9, beta2: float = 0.999):
        self.learning_rate = float(learning_rate)
        self.initial_range = float(initial_range)
        self.eps = float(eps)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)

    # --- executable spec (numpy fallback + test oracle) -------------------
    def slot_len(self, emb_dim: int) -> int:
        return 0

    def init_slots(self, emb_dim: int) -> np.ndarray:
        return np.zeros(self.slot_len(emb_dim), np.float32)

    def apply(self, w: np.ndarray, slots: np.ndarray,
              g: np.ndarray) -> None:
        raise NotImplementedError


class SparseNaiveSGDRule(_RuleBase):
    """reference: SparseNaiveSGDRule (sparse_sgd_rule.cc)."""
    rule_id = 0

    def apply(self, w, slots, g):
        w -= np.float32(self.learning_rate) * g


class SparseAdaGradRule(_RuleBase):
    """Per-dim adagrad. reference: SparseAdaGradSGDRule (sparse_sgd_rule.cc);
    design departure: the reference keeps one scalar g2sum per feature, here
    the accumulator is per-dimension (standard adagrad) — strictly more
    state, strictly better conditioning, and it vectorizes."""
    rule_id = 1

    def slot_len(self, emb_dim):
        return emb_dim

    def apply(self, w, slots, g):
        slots += g * g
        w -= np.float32(self.learning_rate) * g / \
            (np.sqrt(slots) + np.float32(self.eps))


class SparseAdamRule(_RuleBase):
    """reference: SparseAdamSGDRule (sparse_sgd_rule.cc). Slots: m, v and
    the per-row running beta powers (the reference stores beta pows per row
    too — sparse rows step at different times, so bias correction must be
    per-row)."""
    rule_id = 2

    def slot_len(self, emb_dim):
        return 2 * emb_dim + 2

    def init_slots(self, emb_dim):
        s = np.zeros(2 * emb_dim + 2, np.float32)
        s[2 * emb_dim + 0] = 1.0
        s[2 * emb_dim + 1] = 1.0
        return s

    def apply(self, w, slots, g):
        d = w.shape[0]
        m, v = slots[:d], slots[d:2 * d]
        b1, b2 = np.float32(self.beta1), np.float32(self.beta2)
        slots[2 * d + 0] *= b1
        slots[2 * d + 1] *= b2
        corr1 = np.float32(1.0) - slots[2 * d + 0]
        corr2 = np.float32(1.0) - slots[2 * d + 1]
        m[:] = b1 * m + (np.float32(1.0) - b1) * g
        v[:] = b2 * v + (np.float32(1.0) - b2) * g * g
        w -= np.float32(self.learning_rate) * (m / corr1) / \
            (np.sqrt(v / corr2) + np.float32(self.eps))


class CtrAccessor:
    """Bundle of rule + CTR lifecycle policy for one sparse table.

    reference: CtrCommonAccessor (ctr_accessor.cc) — show/click statistics
    with daily decay and threshold-based shrink of cold features; `entry`
    is the feature-admission policy (reference python/paddle/distributed/
    entry_attr.py CountFilterEntry/ProbabilityEntry/ShowClickEntry).
    """

    def __init__(self, rule: _RuleBase | None = None,
                 show_decay_rate: float = 0.98,
                 shrink_show_threshold: float = 0.1,
                 shrink_unseen_days: float = 7.0,
                 entry=None):
        self.rule = rule or SparseAdaGradRule()
        self.show_decay_rate = float(show_decay_rate)
        self.shrink_show_threshold = float(shrink_show_threshold)
        self.shrink_unseen_days = float(shrink_unseen_days)
        self.entry = entry


class CountFilterEntry:
    """Admit a feature into the table only after it was pushed `count_filter`
    times (reference entry_attr.py CountFilterEntry — keeps one-off ids from
    bloating the table)."""

    needs_count = True  # admit() depends on the probation counter

    def __init__(self, count_filter: int):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self.count_filter = int(count_filter)

    def admit(self, feature_id: int, seen_count: int) -> bool:
        return seen_count >= self.count_filter


class ProbabilityEntry:
    """Admit with fixed probability, deterministic per feature id
    (reference entry_attr.py ProbabilityEntry)."""

    needs_count = False  # decision is per-id, not per-occurrence

    def __init__(self, probability: float):
        if not 0.0 <= probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        self.probability = float(probability)

    def admit(self, feature_id: int, seen_count: int) -> bool:
        r, _ = _splitmix64(int(feature_id) ^ 0xC0FFEE)
        return (r >> 11) / float(1 << 53) < self.probability


class ShowClickEntry:
    """Names the show/click input slots feeding the CTR statistics
    (reference entry_attr.py ShowClickEntry); admission is unconditional —
    the stats drive decay/shrink, not entry."""

    needs_count = False

    def __init__(self, show_name: str, click_name: str):
        self.show_name = str(show_name)
        self.click_name = str(click_name)

    def admit(self, feature_id: int, seen_count: int) -> bool:
        return True
