"""Multi-adapter (LoRA) serving: the adapter store behind the fused decode
program's per-lane batched deltas.

reference: paddle_tpu/inference/adapters.py — `AdapterLoadError`,
`LoraWeights`, `AdapterStore` (:87), `make_demo_store`,
`demo_store_for_engine` and `per_adapter_slos`.

  * ``AdapterStore`` — a closed registry of NAMED LoRA adapter sets.
    Residency is a device-resident stacked float32 pool per target
    projection: ``A_q [L, n_slots, H, r]`` / ``B_q [L, n_slots, r, Dq]``
    (and the v-projection pair), allocated once on the store's device.
    Slot 0 is the base model and holds zeros forever, so a lane with
    ``adapter_id == 0`` adds an exactly-zero delta and greedy streams
    match the storeless engine token for token.
  * hot-load / evict — ``acquire`` refcounts a named adapter into a pool
    slot (LRU-evicting an idle slot when full) and ``release`` drops the
    reference when the request retires.
  * swap without a new graph — an upload FILLS its slot in place
    (``pool[:, slot].copy_(w)``) where the reference rebinds the array
    (reference :273-282): the engine's captured CUDA graphs hold the
    pools' addresses, so a rebound pool would leave them reading stale
    weights. Loading, evicting or overwriting adapters changes only the
    pools' contents, never a graph key (``program_key`` is shape-only), so
    hot swaps add no capture. The copy is enqueued on the current stream,
    behind any tile already dispatched, which therefore reads what it was
    dispatched with; the evicted slot had no live lane.

Degrade contract: the store never half-serves. A failed ``acquire`` or
residency check at admission is a typed ``AdapterLoadError`` (or an
injected transient) and the engine rejects the request with
``finish_reason='rejected'``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..framework.device import resolve_device
from ..observability.catalog import metric as _metric
from ..observability.recorder import get_recorder as _get_recorder

__all__ = ["AdapterStore", "AdapterLoadError", "LoraWeights",
           "make_demo_store", "demo_store_for_engine", "per_adapter_slos"]


class AdapterLoadError(RuntimeError):
    """The store could not make a named adapter resident (unknown name,
    every slot pinned by live lanes, or a store fault). Admission treats
    it as a typed rejection — never a silent base-model fallback."""


class LoraWeights:
    """One named adapter set: per-layer A/B factors for the q and v
    projections, host-side until loaded. Shapes (L = layers, H = hidden,
    r = rank, Dq/Dv = projection output widths):

        a_q [L, H, r]   b_q [L, r, Dq]
        a_v [L, H, r]   b_v [L, r, Dv]
    """

    __slots__ = ("name", "a_q", "b_q", "a_v", "b_v")

    def __init__(self, name, a_q, b_q, a_v, b_v):
        self.name = str(name)
        self.a_q = np.asarray(a_q)
        self.b_q = np.asarray(b_q)
        self.a_v = np.asarray(a_v)
        self.b_v = np.asarray(b_v)
        if self.a_q.ndim != 3 or self.b_q.ndim != 3 \
                or self.a_v.ndim != 3 or self.b_v.ndim != 3:
            raise ValueError(f"adapter {name!r}: factors must be "
                             "[L, H, r] / [L, r, D] stacks")
        if self.a_q.shape[-1] != self.b_q.shape[1] \
                or self.a_v.shape[-1] != self.b_v.shape[1]:
            raise ValueError(f"adapter {name!r}: rank mismatch between "
                             "A and B factors")


class AdapterStore:
    """Closed registry of named LoRA adapter sets over a bounded
    device-resident slot pool. The engine-facing surface:

        store.acquire(name) -> adapter_id   (refcount++, hot-load)
        store.check_resident(adapter_id)    (gather-side validation)
        store.release(adapter_id)           (refcount--)
        store.can_serve(name)               (placement check)
        store.program_key                   (shape-only program key)

    ``n_slots`` INCLUDES the reserved all-zeros base slot 0, so a store
    with n_slots=5 serves at most 4 concurrent distinct adapters. The
    pools live on `device` (the package's default device when None); an
    engine takes a store on its own device only.
    """

    def __init__(self, num_layers, hidden, q_out, v_out, rank,
                 n_slots=8, max_adapters=256, *, device=None):
        if n_slots < 2:
            raise ValueError("n_slots must be >= 2 (slot 0 is the base)")
        self.num_layers = int(num_layers)
        self.hidden = int(hidden)
        self.q_out = int(q_out)
        self.v_out = int(v_out)
        self.rank = int(rank)
        self.n_slots = int(n_slots)
        self.max_adapters = int(max_adapters)
        device = resolve_device(device)
        L, S, H, r = self.num_layers, self.n_slots, self.hidden, self.rank

        def _zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        # the device pools; slot 0 stays all-zeros for the store's life
        self.A_q = _zeros(L, S, H, r)
        self.device = self.A_q.device       # "cuda" resolved to its index
        self.B_q = _zeros(L, S, r, self.q_out)
        self.A_v = _zeros(L, S, H, r)
        self.B_v = _zeros(L, S, r, self.v_out)
        self._registry: dict[str, LoraWeights] = {}   # closed name set
        self._slot_of: dict[str, int] = {}            # resident name->slot
        self._name_of: dict[int, str] = {}
        self._refs: dict[int, int] = {}               # slot -> refcount
        self._lru: list[int] = []                     # idle order, old first
        self._loads = 0
        self._evictions = 0
        self._rec = _get_recorder()
        self._m_resident = _metric("serving_adapter_resident")
        self._m_upload = _metric("serving_adapter_upload_seconds")

    @classmethod
    def for_model(cls, model, rank=4, n_slots=8, max_adapters=256):
        """Dimension a store from a LlamaForCausalLM config, on the
        model's device: the q delta lands on [H, nh*hd] and the v delta
        on [H, nkv*hd]."""
        cfg = model.config
        hd = cfg.hidden_size // cfg.num_attention_heads
        device = next(iter(model.parameters())).device
        return cls(cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.num_attention_heads * hd,
                   cfg.num_key_value_heads * hd,
                   rank, n_slots=n_slots, max_adapters=max_adapters,
                   device=device)

    # --- registry ---------------------------------------------------------
    def register(self, name, a_q, b_q, a_v, b_v):
        """Add a named adapter to the closed registry (host weights;
        residency comes later via acquire). Shape-checked against the
        store's dimensions so a bad adapter fails here, not inside the
        decode program."""
        name = str(name)
        if not name or name == "base":
            raise ValueError("adapter name must be non-empty and not "
                             "'base' (the reserved slot-0 identity)")
        if name not in self._registry \
                and len(self._registry) >= self.max_adapters:
            raise AdapterLoadError(
                f"adapter registry full ({self.max_adapters}); the id "
                "space is bounded by construction")
        w = LoraWeights(name, a_q, b_q, a_v, b_v)
        want = {
            "a_q": (self.num_layers, self.hidden, self.rank),
            "b_q": (self.num_layers, self.rank, self.q_out),
            "a_v": (self.num_layers, self.hidden, self.rank),
            "b_v": (self.num_layers, self.rank, self.v_out),
        }
        for attr, shape in want.items():
            got = getattr(w, attr).shape
            if tuple(got) != shape:
                raise ValueError(
                    f"adapter {name!r}: {attr} shape {tuple(got)} != "
                    f"store shape {shape}")
        self._registry[name] = w
        return name

    def names(self):
        return sorted(self._registry)

    def can_serve(self, name):
        """Placement check: True when the name is in the closed registry —
        resident now or hot-loadable on demand."""
        return str(name) in self._registry

    # --- residency --------------------------------------------------------
    @property
    def program_key(self):
        """What the decode programs depend on: pool SHAPE only. Every
        load, evict or overwrite leaves it untouched."""
        return ("lora", self.n_slots, self.rank)

    def resident(self):
        return dict(self._slot_of)

    def refcount(self, adapter_id):
        return self._refs.get(int(adapter_id), 0)

    def acquire(self, name):
        """Refcount the named adapter resident and return its slot id. A
        cold adapter hot-loads into a free (or LRU idle) slot. Raises
        AdapterLoadError when the name is unknown or every non-base slot
        is pinned by live lanes."""
        name = str(name)
        if name not in self._registry:
            raise AdapterLoadError(
                f"unknown adapter {name!r}; registered: {self.names()}")
        slot = self._slot_of.get(name)
        if slot is not None:
            self._refs[slot] = self._refs.get(slot, 0) + 1
            if slot in self._lru:
                self._lru.remove(slot)
            return slot
        slot = self._free_slot()
        if slot is None:
            raise AdapterLoadError(
                f"no adapter slot free for {name!r}: all "
                f"{self.n_slots - 1} slots pinned by live lanes")
        self._upload(slot, self._registry[name])
        self._slot_of[name] = slot
        self._name_of[slot] = name
        self._refs[slot] = 1
        self._loads += 1
        _metric("serving_adapter_loads_total", adapter=name).inc()
        self._m_resident.set(len(self._slot_of))
        if self._rec.enabled:
            self._rec.record("adapter", action="load", adapter=name,
                             slot=slot)
        return slot

    def check_resident(self, adapter_id):
        """Gather-side validation at lane bind time: the slot the lane will
        gather from must still belong to a live adapter. Raises
        AdapterLoadError otherwise."""
        aid = int(adapter_id)
        if aid == 0:
            return
        if aid not in self._name_of or self._refs.get(aid, 0) <= 0:
            raise AdapterLoadError(
                f"adapter slot {aid} is not resident (evicted or never "
                "loaded); refusing to gather stale weights")

    def release(self, adapter_id):
        """Drop one reference. A slot at refcount 0 stays resident (warm
        for the next acquire) but becomes LRU-evictable."""
        slot = int(adapter_id)
        if slot == 0 or slot not in self._refs:
            return
        self._refs[slot] = max(0, self._refs[slot] - 1)
        if self._refs[slot] == 0 and slot not in self._lru:
            self._lru.append(slot)

    def _free_slot(self):
        used = set(self._name_of)
        for s in range(1, self.n_slots):
            if s not in used:
                return s
        while self._lru:
            victim = self._lru.pop(0)
            if self._refs.get(victim, 0) > 0:
                continue        # re-acquired since it went idle
            name = self._name_of.pop(victim)
            self._slot_of.pop(name, None)
            self._refs.pop(victim, None)
            self._evictions += 1
            _metric("serving_adapter_evictions_total", adapter=name).inc()
            self._m_resident.set(len(self._slot_of))
            if self._rec.enabled:
                self._rec.record("adapter", action="evict", adapter=name,
                                 slot=victim)
            # no zeroing needed: the incoming upload overwrites the slot
            # and no live lane can reference it (refcount was 0)
            return victim
        return None

    def _upload(self, slot, w):
        """Fill `slot` of every pool in place: the tensors keep their
        addresses, which the captured decode graphs hold."""
        t0 = time.perf_counter()
        for pool, host in ((self.A_q, w.a_q), (self.B_q, w.b_q),
                           (self.A_v, w.a_v), (self.B_v, w.b_v)):
            pool[:, slot].copy_(torch.as_tensor(
                np.asarray(host, np.float32)))
        # host-side dispatch wall only: the copies are enqueued behind
        # whatever is in flight
        self._m_upload.observe(time.perf_counter() - t0)

    def stats(self):
        return {"loads": self._loads, "evictions": self._evictions,
                "resident": len(self._slot_of),
                "registered": len(self._registry)}


def _register_demo(store, names, seed, scale):
    L, H, r = store.num_layers, store.hidden, store.rank
    for i, name in enumerate(names):
        rs = np.random.RandomState(seed * 10_007 + i)
        store.register(
            name,
            rs.randn(L, H, r).astype(np.float32) * scale,
            rs.randn(L, r, store.q_out).astype(np.float32) * scale,
            rs.randn(L, H, r).astype(np.float32) * scale,
            rs.randn(L, r, store.v_out).astype(np.float32) * scale)
    return store


def make_demo_store(model, names, rank=4, n_slots=8, seed=0, scale=0.5):
    """A store populated with small random adapters, deterministic in
    `seed` (numpy draws, the same bits as the reference's demo store);
    `scale` keeps the deltas small enough that decode stays numerically
    tame while still flipping greedy argmaxes against the base model."""
    store = AdapterStore.for_model(model, rank=rank, n_slots=n_slots)
    return _register_demo(store, names, seed, scale)


def demo_store_for_engine(engine, names, rank=4, n_slots=8, seed=0,
                          scale=0.5):
    """make_demo_store for callers that only hold a built engine:
    dimensions the store from the engine's own parameters, on the
    engine's device. Same seed and dimensions give the same weights as
    make_demo_store."""
    cfg = engine.cfg
    store = AdapterStore(len(engine.layers), int(engine.embed_w.shape[1]),
                         int(cfg["heads"] * cfg["head_dim"]),
                         int(cfg["kv_heads"] * cfg["head_dim"]),
                         rank, n_slots=n_slots, device=engine.device)
    return _register_demo(store, names, seed, scale)


def per_adapter_slos(names, ttft_objective=2.5, tpot_objective=0.25):
    """Per-adapter SLOSpecs over the adapter-labeled serving histograms —
    the SLOEngine evaluates them like any other spec (the `labels=`
    filter keeps each verdict scoped to one adapter)."""
    from ..observability.slo import SLOSpec
    specs = []
    for n in names:
        specs.append(SLOSpec(
            f"adapter_{n}_ttft_p95", "quantile",
            "serving_adapter_ttft_seconds", objective=ttft_objective,
            q=0.95, labels={"adapter": str(n)}))
        specs.append(SLOSpec(
            f"adapter_{n}_tpot_p99", "quantile",
            "serving_adapter_tpot_seconds", objective=tpot_objective,
            q=0.99, labels={"adapter": str(n)}))
    return specs
