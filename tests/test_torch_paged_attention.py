"""The port's paged KV cache (ops/paged_attention.py) against the JAX
package's.

Every function is held against the reference's on the same inputs, made
with numpy from a seed, in float32: each write, the rollback, and decode,
verify and prefill-chunk attention. KVBlockFormat's encode and decode must
be bit-equal for int8 and both fp8 formats, and BlockKVCacheManager must
keep the same tables and caches. The port writes the cache in place where
the reference returns a new array; both results are compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as pa
from torch_one_thread import one_torch_thread  # noqa: F401

# f32 attention: scores over head dim 16 and softmax sums over up to 64
# cached positions, in another order on each side
F32_TOL = 2e-5
NB, BS, KVH, D = 12, 4, 2, 16
SCRATCH = NB - 1


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _pool(rs):
    return _rand(rs, NB, BS, KVH, D), _rand(rs, NB, BS, KVH, D)


def _tables():
    # two lanes of four blocks, padded with the scratch block
    return np.array([[0, 3, 5, SCRATCH], [1, 2, 4, 6]], np.int32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _eq(port, ref):
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(got, np.asarray(ref))


def _bits(x):
    """The raw bytes of a port or reference array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("name", ["native", "bf16", "int8", "fp8_e4m3",
                                  "fp8_e5m2"])
@pytest.mark.parametrize("native", ["float32", "bfloat16"])
def test_block_format_bit_equal(name, native):
    rs = np.random.RandomState(0)
    x = _rand(rs, 5, 3, D) * np.float32(rs.choice([1e-3, 1.0, 40.0],
                                                  (5, 3, 1)))
    x[1, 2] = 0.0                              # a zero row: scale 0
    x[3, 0, 4] = 1e4                           # an outlier in a row
    jdt = getattr(jnp, native)
    tdt = getattr(torch, native)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.as_tensor(x).to(tdt)
    jf = jpa.KVBlockFormat(name, native_dtype=jdt)
    tf = pa.KVBlockFormat(name, native_dtype=tdt)
    assert tf.quantized == jf.quantized
    assert tf.bytes_per_token(KVH, D) == jf.bytes_per_token(KVH, D)
    jq, js = jf.encode(jx)
    tq, ts = tf.encode(tx)
    assert _bits(tq) == _bits(jq)
    if tf.quantized:
        assert str(tq.dtype).split(".")[1] == jnp.dtype(jq.dtype).name
        assert _bits(ts) == _bits(js)
        assert _bits(tf.decode(tq, ts)) == _bits(jf.decode(jq, js))
    else:
        assert js is None and ts is None and tq is tx


def test_unknown_block_format_raises():
    with pytest.raises(ValueError, match="unknown kv cache format"):
        pa.KVBlockFormat("fp4")


@pytest.mark.parametrize("active", [None, [True, False]])
def test_write_to_cache(active):
    rs = np.random.RandomState(1)
    kc, vc = _pool(rs)
    kn, vn = _rand(rs, 2, KVH, D), _rand(rs, 2, KVH, D)
    pos = np.array([9, 13], np.int32)
    kw = {} if active is None else dict(active=np.array(active),
                                        scratch_block=SCRATCH)
    want = jpa.write_to_cache(_j(kc), _j(vc), _j(kn), _j(vn), _j(_tables()),
                              _j(pos), **{k: _j(v) if k == "active" else v
                                          for k, v in kw.items()})
    tk, tv = _t(kc), _t(vc)
    got = pa.write_to_cache(tk, tv, _t(kn), _t(vn), _t(_tables()), _t(pos),
                            **{k: _t(v) if k == "active" else v
                               for k, v in kw.items()})
    assert got[0] is tk and got[1] is tv        # in place
    for g, w in zip(got, want):
        _eq(g, w)


def test_write_chunk_to_cache():
    rs = np.random.RandomState(2)
    kc, vc = _pool(rs)
    kn, vn = _rand(rs, 7, KVH, D), _rand(rs, 7, KVH, D)
    row = _tables()[1]
    want = jpa.write_chunk_to_cache(_j(kc), _j(vc), _j(kn), _j(vn), _j(row),
                                    5)
    got = pa.write_chunk_to_cache(_t(kc), _t(vc), _t(kn), _t(vn), _t(row), 5)
    for g, w in zip(got, want):
        _eq(g, w)


def _torch(x):
    """A reference array (or None) as a torch tensor with the same bits,
    bf16 and fp8 included."""
    if x is None:
        return None
    a = np.asarray(x)
    narrow = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}.get(a.dtype.name)
    if narrow is None:
        return torch.as_tensor(a.copy())
    return torch.from_numpy(a.view(np.uint8).copy()).view(narrow)


def _formats(fmt):
    if fmt is None:
        return None, None
    return (jpa.KVBlockFormat(fmt, jnp.float32),
            pa.KVBlockFormat(fmt, torch.float32))


def _quant_pool(rs, jf):
    """A reference pool (payloads and scales, None without a format)."""
    kc, vc = _pool(rs)
    if jf is None:
        return jnp.asarray(kc), jnp.asarray(vc), None, None
    (qk, sk), (qv, sv) = jf.encode(jnp.asarray(kc)), jf.encode(
        jnp.asarray(vc))
    return qk, qv, sk, sv


def _same_bits(port, ref):
    for g, w in zip(port, ref):
        if w is None:
            assert g is None
        else:   # dead lanes' writes collide in the scratch block
            assert _bits(g[:SCRATCH]) == _bits(np.asarray(w)[:SCRATCH])


@pytest.mark.parametrize("fmt", [None, "int8", "fp8_e4m3"])
def test_write_tokens_and_rollback(fmt):
    """The speculative write of C tokens per lane, then the rollback of the
    positions not kept, with a dead lane routed to the scratch block."""
    rs = np.random.RandomState(3)
    jf, tf = _formats(fmt)
    jpool = _quant_pool(rs, jf)
    tpool = [_torch(x) for x in jpool]
    kn, vn = _rand(rs, 2, 3, KVH, D), _rand(rs, 2, 3, KVH, D)
    start = np.array([6, 10], np.int32)
    active = np.array([True, False])
    keep = np.array([[True, False, False], [True, True, False]])
    jout = jpa.kv_write_tokens(jf, *jpool, _j(kn), _j(vn), _j(_tables()),
                               _j(start), _j(active), SCRATCH)
    tout = pa.kv_write_tokens(tf, *tpool, _t(kn), _t(vn), _t(_tables()),
                              _t(start), _t(active), SCRATCH)
    _same_bits(tout[:4], jout[:4])
    for g, w in zip(tout[4], jout[4]):              # the live lane's slots
        assert _bits(g[0]) == _bits(np.asarray(w)[0])
    jback = jpa.kv_rollback_tokens(jf, *jout[:4], jout[4], _j(_tables()),
                                   _j(start), _j(keep), _j(active), SCRATCH)
    tback = pa.kv_rollback_tokens(tf, *tout[:4], tout[4], _t(_tables()),
                                  _t(start), _t(keep), _t(active), SCRATCH)
    _same_bits(tback, jback)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8_e5m2"])
def test_write_token_and_chunk(fmt):
    rs = np.random.RandomState(4)
    jf, tf = _formats(fmt)
    jpool = _quant_pool(rs, jf)
    tpool = [_torch(x) for x in jpool]
    kn, vn = _rand(rs, 2, KVH, D), _rand(rs, 2, KVH, D)
    pos = np.array([3, 14], np.int32)
    jout = jpa.kv_write_token(jf, *jpool, _j(kn), _j(vn), _j(_tables()),
                              _j(pos))
    tout = pa.kv_write_token(tf, *tpool, _t(kn), _t(vn), _t(_tables()),
                             _t(pos))
    _same_bits(tout, jout)
    kn, vn = _rand(rs, 5, KVH, D), _rand(rs, 5, KVH, D)
    jout = jpa.kv_write_chunk(jf, *jout, _j(kn), _j(vn), _j(_tables()[0]), 2)
    tout = pa.kv_write_chunk(tf, *tout, _t(kn), _t(vn), _t(_tables()[0]), 2)
    _same_bits(tout, jout)


@pytest.mark.parametrize("h", [2, 4])                  # MHA and GQA 2:1
@pytest.mark.parametrize("fmt", [None, "int8"])
def test_decode_attention(h, fmt):
    rs = np.random.RandomState(5)
    kc, vc = _pool(rs)
    q = _rand(rs, 2, h, D)
    lens = np.array([10, 16], np.int32)
    if fmt is None:
        want = jpa.paged_attention_decode(_j(q), _j(kc), _j(vc),
                                          _j(_tables()), _j(lens))
        got = pa.paged_attention_decode(_t(q), _t(kc), _t(vc), _t(_tables()),
                                        _t(lens))
    else:
        jf = jpa.KVBlockFormat(fmt, jnp.float32)
        tf = pa.KVBlockFormat(fmt, torch.float32)
        (jk, jks), (jv, jvs) = jf.encode(_j(kc)), jf.encode(_j(vc))
        (tk, tks), (tv, tvs) = tf.encode(_t(kc)), tf.encode(_t(vc))
        want = jpa.paged_attention_decode_inner(
            _j(q), jk, jv, _j(_tables()), _j(lens), fmt=jf,
            k_scale_cache=jks, v_scale_cache=jvs)
        got = pa.paged_attention_decode_inner(
            _t(q), tk, tv, _t(_tables()), _t(lens), fmt=tf,
            k_scale_cache=tks, v_scale_cache=tvs)
    assert got.shape == (2, h, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("h", [2, 4])
def test_verify_attention(h):
    rs = np.random.RandomState(6)
    kc, vc = _pool(rs)
    q = _rand(rs, 2, 3, h, D)
    base = np.array([4, 12], np.int32)
    want = jpa.paged_attention_verify(_j(q), _j(kc), _j(vc), _j(_tables()),
                                      _j(base))
    got = pa.paged_attention_verify(_t(q), _t(kc), _t(vc), _t(_tables()),
                                    _t(base))
    assert got.shape == (2, 3, h, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("h,start", [(2, 0), (4, 5), (4, 9)])
@pytest.mark.parametrize("fmt", [None, "fp8_e4m3"])
def test_prefill_chunk_attention(h, start, fmt):
    rs = np.random.RandomState(7)
    kc, vc = _pool(rs)
    q = _rand(rs, 6, h, D)
    row = _tables()[1]
    kw_j, kw_t = {}, {}
    jk, jv, tk, tv = _j(kc), _j(vc), _t(kc), _t(vc)
    if fmt is not None:
        jf = jpa.KVBlockFormat(fmt, jnp.float32)
        tf = pa.KVBlockFormat(fmt, torch.float32)
        (jk, jks), (jv, jvs) = jf.encode(jk), jf.encode(jv)
        (tk, tks), (tv, tvs) = tf.encode(tk), tf.encode(tv)
        kw_j = dict(fmt=jf, k_scale_cache=jks, v_scale_cache=jvs)
        kw_t = dict(fmt=tf, k_scale_cache=tks, v_scale_cache=tvs)
    want = jpa.paged_attention_prefill_chunk(_j(q), jk, jv, _j(row), start,
                                             **kw_j)
    got = pa.paged_attention_prefill_chunk(_t(q), tk, tv, _t(row), start,
                                           **kw_t)
    assert got.shape == (6, h, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_block_manager_matches_reference():
    rs = np.random.RandomState(8)
    jm = jpa.BlockKVCacheManager(10, 4, KVH, D, dtype=jnp.float32)
    tm = pa.BlockKVCacheManager(10, 4, KVH, D, dtype=torch.float32,
                                device="cpu")
    k, v = _rand(rs, 9, KVH, D), _rand(rs, 9, KVH, D)
    steps = [("prefill", "a", k, v), ("allocate", "b", 6),
             ("append", "a", k[0], v[0]), ("share", "a", "c", 2),
             ("fork_cow", "c", 1), ("append", "a", k[1], v[1]),
             ("free", "b"), ("allocate", "d", 5)]
    for op, *args in steps:
        jargs = [jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in args]
        targs = [torch.as_tensor(x) if isinstance(x, np.ndarray) else x
                 for x in args]
        assert getattr(tm, op)(*targs) == getattr(jm, op)(*jargs), op
        assert tm._tables == jm._tables and tm._lens == jm._lens, op
        assert tm._free == jm._free and tm._ref == jm._ref, op
    _eq(tm.k_cache, jm.k_cache)
    _eq(tm.v_cache, jm.v_cache)
    jt, jl = jm.batch_tables(["a", "c", "d"], pad_to=5)
    tt, tl = tm.batch_tables(["a", "c", "d"], pad_to=5)
    _eq(tt, jt)
    _eq(tl, jl)
    with pytest.raises(MemoryError):
        tm.allocate("e", 100)
