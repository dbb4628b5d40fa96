"""The port's serving mesh (inference/mesh/) and the engine's KV hand-off
against the JAX package's, mirroring tests/test_mesh.py,
test_prefix_cache.py::TestMeshHandoff and test_adapters.py::
TestMeshAdapters.

Both packages serve the same requests in float32 with the reference's
weights carried across (convert.py). The hand-off record of each pool
format is held field by field against the reference's, and pack_record's
bytes unpack in the other package bit for bit. Two-replica meshes, data
parallel and disaggregated, give the reference mesh's greedy streams
token for token and its mesh_report counts; sampled streams, drawn from
the port's own counter-based hash, are held to a single port engine's."""

import json
import struct

import numpy as np
import pytest
import torch

from paddle_tpu.inference import adapters as jadapters
from paddle_tpu.inference.mesh import MeshRouter as JMeshRouter
from paddle_tpu.inference.mesh import ReplicaPool as JReplicaPool
from paddle_tpu.inference.mesh import handoff as jhandoff
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch.inference.adapters import AdapterStore
from paddle_tpu_torch.inference.mesh import (KVHandoffError, MeshRouter,
                                             ReplicaPool, hand_off,
                                             pack_record, unpack_record,
                                             wire_size)
from paddle_tpu_torch.resilience import faults
from torch_mesh_parity import (dense, no_new_series, pair,  # noqa: F401
                               port_factory, prompts, ref_factory, serve)
from torch_one_thread import one_torch_thread  # noqa: F401

FORMATS = ["bf16", "int8", "fp8_e4m3", "fp8_e5m2"]
# the "bf16" format passes the model's dtype through: float32 here, so its
# blocks are the prefill's K/V, computed in another order on each side
# (products over hidden 64): |err| <= F32_TOL * max(1, max|K|)
F32_TOL = 2e-5
# a quantized payload element or bf16 scale may round to the neighbouring
# code where the float32 K/V it encodes lies within rounding of a code
# boundary: codes (in sign-magnitude order) at most QUANT_CODE_TOL apart,
# and at least QUANT_EQUAL_SHARE of them equal
QUANT_CODE_TOL = 1
QUANT_EQUAL_SHARE = 0.99
# the JSON header of each record holds its float anchors (t_arrival,
# t_first), whose repr length differs from run to run: a mesh's hand-off
# byte count may differ from another run's by this much per record
HEADER_JITTER = 16
_ID_FIELDS = ("trace_id", "t_arrival", "t_first")


def _capture(Engine_factory, fmt, prompt, n=6, **kw):
    """The export_kv record a sink-bound engine hands off for `prompt`."""
    eng = Engine_factory(kv_cache_dtype=fmt, **kw)()
    records = []
    eng.prefill_sink = records.append
    eng.add_request(prompt, max_new_tokens=n)
    for _ in range(50):
        if records:
            break
        eng.step()
    assert records, "prefill sink never fired"
    return records[0]


def _raw(a):
    """(dtype name, shape, bytes) of a record array of either package."""
    if isinstance(a, torch.Tensor):
        w = pack_record({"a": a})
    else:
        w = jhandoff.pack_record({"a": a})
    (hlen,) = struct.unpack_from("<I", w, 0)
    name, shape = json.loads(w[4:4 + hlen])["arrays"]["a"]
    return name, shape, w[4 + hlen:]


def _codes(name, buf):
    """Stored codes in sign-magnitude order (adjacent codes differ by 1)."""
    if name == "int8":
        return np.frombuffer(buf, np.int8).astype(np.int64)
    width = np.uint16 if name == "bfloat16" else np.uint8
    u = np.frombuffer(buf, width).astype(np.int64)
    sign = 1 << (8 * np.dtype(width).itemsize - 1)
    return np.where(u & sign, -(u & (sign - 1)), u)


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_kv_record_and_wire_match_reference(fmt):
    prompt = prompts(1)[0]
    want = _capture(ref_factory, fmt, prompt)
    got = _capture(port_factory, fmt, prompt)
    assert set(got) == set(want)
    for key, val in want.items():
        if key in _ID_FIELDS or isinstance(val, np.ndarray):
            continue
        assert got[key] == val, key
    assert isinstance(got["trace_id"], str) and got["t_first"] is not None
    np.testing.assert_array_equal(got["prompt"], want["prompt"])
    arrays = [k for k, v in want.items() if isinstance(v, np.ndarray)
              and k != "prompt"]
    assert sorted(arrays) == (["k", "v"] if fmt == "bf16" else
                              ["k", "k_scale", "v", "v_scale"])
    for key in arrays:
        jname, jshape, jbuf = _raw(want[key])
        name, shape, buf = _raw(got[key])
        assert (name, shape) == (jname, jshape), key
        if name == "float32":
            a, b = (np.frombuffer(x, np.float32) for x in (jbuf, buf))
            assert np.abs(a - b).max() <= F32_TOL * max(1, np.abs(a).max())
        else:
            a, b = _codes(name, jbuf), _codes(name, buf)
            assert np.abs(a - b).max() <= QUANT_CODE_TOL, key
            assert (a == b).mean() >= QUANT_EQUAL_SHARE, key
    # the wire: each package's bytes unpack in the other with the arrays
    # equal bit for bit, and repack to the same buffer
    for rec, pack, unpack, repack in (
            (want, jhandoff.pack_record, unpack_record, pack_record),
            (got, pack_record, jhandoff.unpack_record,
             jhandoff.pack_record)):
        wire = pack(rec)
        back = unpack(wire)
        assert repack(back) == wire
        for key in arrays:
            assert _raw(back[key])[2] == _raw(rec[key])[2], key
        assert back["prompt"].dtype == np.int32
    assert wire_size(got) == len(pack_record(got))


def test_wire_version_and_rejections():
    rec = _capture(port_factory, "bf16", prompts(1)[0])
    wire = pack_record(rec)
    (hlen,) = struct.unpack_from("<I", wire, 0)
    head = json.loads(wire[4:4 + hlen])
    head["meta"]["wire_version"] = 99
    new_head = json.dumps(head, sort_keys=True).encode()
    with pytest.raises(KVHandoffError, match="wire version"):
        unpack_record(struct.pack("<I", len(new_head)) + new_head
                      + wire[4 + hlen:])
    # a bf16 record cannot install into an int8 pool, nor blocks of
    # another geometry: the engine's ValueError is a rejected hand-off
    with pytest.raises(KVHandoffError, match="rejected"):
        hand_off(rec, port_factory(kv_cache_dtype="int8")())
    with pytest.raises(KVHandoffError, match="rejected"):
        hand_off(rec, port_factory(block_size=16)())


def test_import_kv_writes_in_place_and_resumes_as_parked():
    """import_kv writes the blocks into the pool's own tensors (the storage
    the decode programs hold) and parks the stream; adopt_identity binds a
    mesh identity to a queued request only."""
    prompt = prompts(1)[0]
    rec = _capture(port_factory, "int8", prompt, n=8)
    eng = port_factory(kv_cache_dtype="int8")()
    ptrs = [t.data_ptr() for t in (eng.pool.k, eng.pool.v,
                                   eng.pool.k_scale, eng.pool.v_scale)]
    rid = eng.import_kv(unpack_record(pack_record(rec)))
    assert [t.data_ptr() for t in (eng.pool.k, eng.pool.v, eng.pool.k_scale,
                                   eng.pool.v_scale)] == ptrs
    blocks = eng.pool.tables[rid][:rec["k"].shape[1]]
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(eng.pool, key)[:, blocks], rec[key]), key
    assert rid in eng._preempted and not eng.queue
    single = port_factory(kv_cache_dtype="int8")()
    assert eng.run()[rid] == serve(single, [prompt])[0]
    assert eng.pool.tables == {}
    q = eng.add_request(prompt, max_new_tokens=2)
    assert eng.adopt_identity(q, "mesh-1", t_arrival=5.0)
    assert eng.queue[0].trace_id == "mesh-1"
    assert eng.queue[0].t_arrival == 5.0
    assert not eng.adopt_identity(12345, "mesh-2")


def _mesh(Pool, Router, fac, **kw):
    pool = Pool(fac, n=2, store_port=0, **kw)
    return pool, Router(pool)


@pytest.mark.parametrize("disaggregate", [False, True])
def test_mesh_greedy_streams_and_report_match_reference(disaggregate):
    ps = prompts(4)
    _, jrouter = _mesh(JReplicaPool, JMeshRouter, ref_factory(),
                       disaggregate=disaggregate)
    want = serve(jrouter, ps)
    pool, router = _mesh(ReplicaPool, MeshRouter, port_factory(),
                         disaggregate=disaggregate)
    got = serve(router, ps)
    assert got == want
    assert got == [dense(pair()[1], p, 8) for p in ps]
    jrep, rep = jrouter.mesh_report(), router.mesh_report()
    for key in ("routed", "open", "committed_tokens", "failovers",
                "disaggregate", "membership", "sim_parallel"):
        assert rep[key] == jrep[key], key
    for key in ("ok", "retried", "re_prefill"):
        assert rep["handoffs"][key] == jrep["handoffs"][key], key
    assert abs(rep["handoffs"]["bytes"] - jrep["handoffs"]["bytes"]) \
        <= HEADER_JITTER * rep["handoffs"]["ok"]
    assert rep["handoffs"]["ok"] == (4 if disaggregate else 0)
    assert all(r.routed >= 1 for r in pool)
    assert ({n: r["role"] for n, r in rep["replicas"].items()}
            == {n: r["role"] for n, r in jrep["replicas"].items()})
    # the mesh trace id survives router -> prefill -> hand-off -> decode
    rid = router.add_request(ps[0], max_new_tokens=4)
    tid = router._open[rid].trace_id
    router.run()
    assert router.finished[rid].trace_id == tid


def test_sampled_streams_survive_the_hop():
    """Sampled lanes draw from (seed, position): a stream handed off, or
    placed on either replica, is the single engine's."""
    ps = prompts(4, seed=5)
    kw = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
              seed=11)
    single = serve(port_factory()(), ps, **kw)
    for disaggregate in (False, True):
        _, router = _mesh(ReplicaPool, MeshRouter, port_factory(),
                          disaggregate=disaggregate)
        assert serve(router, ps, **kw) == single, disaggregate


@pytest.mark.parametrize("spec", [
    "mesh.kv_handoff:1:ConnectionError",
    "mesh.kv_handoff:1:ConnectionError;mesh.kv_handoff:2:ConnectionError;"
    "mesh.kv_handoff:3:ConnectionError"])
def test_handoff_faults_retry_or_reprefill_as_reference(spec):
    ps = prompts(3)
    _, jrouter = _mesh(JReplicaPool, JMeshRouter, ref_factory(),
                       disaggregate=True)
    with jfaults.injected_faults(spec):
        want = serve(jrouter, ps, n=6)
    _, router = _mesh(ReplicaPool, MeshRouter, port_factory(),
                      disaggregate=True)
    with faults.injected_faults(spec):
        got = serve(router, ps, n=6)
    assert got == want
    for key in ("ok", "retried", "re_prefill"):
        assert router._handoffs[key] == jrouter._handoffs[key], key
    assert router._handoffs["retried"] + router._handoffs["re_prefill"] >= 1
    assert router.mesh_report()["open"] == 0


def test_kill_replica_failover_as_reference():
    ps = prompts(4)
    outs = []
    for Pool, Router, fac in ((JReplicaPool, JMeshRouter, ref_factory()),
                              (ReplicaPool, MeshRouter, port_factory())):
        pool, router = _mesh(Pool, Router, fac)
        rids = [router.add_request(p, max_new_tokens=8) for p in ps]
        router.step()
        router.step()       # streams in flight on both replicas
        router.kill_replica("replica0", why="test")
        out = router.run()
        assert len(pool.alive()) == 1
        assert pool.alive_nodes() == ["replica1"]   # lease tombstoned
        assert router._failovers.get("replica_down", 0) >= 1
        assert router.mesh_report()["open"] == 0
        outs.append([out[r] for r in rids])
    assert outs[1] == outs[0]


def test_prefix_cache_manifest_and_shared_block_handoff():
    """A warm prefix-cache hit's record names its matched tokens and
    shared blocks as the reference's does, and imports into a decode
    engine whose stream finishes as the dense forward's."""
    rs = np.random.RandomState(17)
    p = np.concatenate([rs.randint(1, 128, (16,)), rs.randint(1, 128, (5,))])
    manifests = []
    for fac in (ref_factory, port_factory):
        src = fac(prefix_cache=True)()
        records = []
        src.prefill_sink = records.append
        for i in range(2):      # cold, then warm: the 16-token head hits
            src.add_request(p, max_new_tokens=8)
            while len(records) <= i:
                src.step()
        manifests.append([(r["prefix_matched_tokens"],
                           r["prefix_shared_blocks"]) for r in records])
    assert manifests[1] == manifests[0]
    assert manifests[1][0][0] == 0 and manifests[1][1][0] == 16
    assert manifests[1][1][1] >= 2
    dst = port_factory()()
    local, nbytes, _retries = hand_off(records[1], dst)
    assert nbytes > 0
    assert dst.run()[local] == dense(pair()[1], p, 8)
    assert dst.pool.tables == {}


def _port_store(model, names=("lora0", "lora1")):
    """The port's store holding the reference demo store's factors."""
    jstore = jadapters.make_demo_store(pair()[0], list(names))
    store = AdapterStore.for_model(model, rank=jstore.rank,
                                   n_slots=jstore.n_slots)
    for name in names:
        w = jstore._registry[name]
        store.register(name, w.a_q, w.b_q, w.a_v, w.b_v)
    return store


def test_mesh_adapters_match_reference():
    """The adapter rides the hand-off (disaggregated), a request lands on
    the one replica that can serve its adapter, and a name no replica
    holds is a typed rejection, all as the reference's mesh."""
    ref, port = pair()
    p1, p2 = (np.random.RandomState(s).randint(1, 128, (n,))
              for s, n in ((7, 9), (7, 8)))

    def jstored():
        return ref_factory(adapters=jadapters.make_demo_store(
            ref, ["lora0", "lora1"]))()

    def stored():
        return port_factory(adapters=_port_store(port))()
    want, got = [], []
    for Pool, Router, build, plain, out in (
            (JReplicaPool, JMeshRouter, jstored, ref_factory(), want),
            (ReplicaPool, MeshRouter, stored, port_factory(), got)):
        pool = Pool(build, n=2, disaggregate=True, store_port=0)
        router = Router(pool)
        out.append(serve(router, [p1], adapter="lora1"))
        assert router.mesh_report()["handoffs"]["ok"] == 1
        builds = iter([plain(), build()])
        pool = Pool(lambda: next(builds), n=2, store_port=0)
        router = Router(pool)
        out.append(serve(router, [p2], adapter="lora0"))
        assert pool.by_name("replica1").routed == 1
        assert pool.by_name("replica0").routed == 0
        rid = router.add_request(p2, max_new_tokens=6, adapter="ghost")
        assert router.run()[rid] == []
        assert router.finished[rid].finish_reason == "rejected"
        assert router._failovers.get("adapter_missing", 0) >= 1
    assert got == want


def test_tp_replicas_build_plain_below_two_cards():
    """tp=True builds each engine under a logical two-way "mp" mesh scope
    at any card count (the port's meshes lie on the cards there are). As
    in the reference, the scope closes before the engine's programs
    compile, so the replica serves exactly what the plain engine serves."""
    from paddle_tpu_torch.pir import shard_prop
    scopes = []

    def build():
        scopes.append(shard_prop.current_mesh())
        return port_factory()()
    pool = ReplicaPool(build, n=1, tp=True, store_port=0)
    assert scopes[0] is not None and scopes[0].dim_names == ["mp"]
    assert scopes[0].shape == [2]
    assert shard_prop.current_mesh() is None
    assert serve(MeshRouter(pool), prompts(1), n=4) \
        == [dense(pair()[1], prompts(1)[0], 4)]
    scopes.clear()
    ReplicaPool(build, n=1, tp=False, store_port=0)
    assert scopes == [None]
