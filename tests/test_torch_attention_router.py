"""The port's attention router, backward flag and routed attention entry
points against the JAX package's.

Both routers read the same temporary ledger documents (through each
package's FLAGS_attention_ledger_path) with an explicit device kind and
must reach the same decisions. The backward flag's dense rematerialised
backward is held against jax.grad of the reference's hybrid (Pallas in
interpret mode, as tests/test_attention_router.py runs it). Inputs are
made with numpy from a seed and handed to both.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as pt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.ops.pallas import attention_router as jar
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import generation
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.nn.functional import attention as attn
from paddle_tpu_torch.ops import attention_router as ar
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import bake_attention_ledger, flash_vs_xla

CHIP = "TestChip"
# f32 gradients summed in another order on each side
F32_TOL = 2e-3


@pytest.fixture(autouse=True)
def _fresh_routers():
    ar.clear_routing_cache()
    jar.clear_routing_cache()
    yield
    for f in (flags, jflags):
        f.set_flags({"FLAGS_attention_ledger_path": "",
                     "FLAGS_attention_router": "auto",
                     "FLAGS_flash_attention_bwd": "auto",
                     "FLAGS_flash_attention_backend": "auto"})
    ar.clear_routing_cache()
    jar.clear_routing_cache()


def _entry(seq, d, bh, fwd, bwd, **kw):
    return dict(seq=seq, head_dim=d, bh=bh, causal=True, dtype="bfloat16",
                fwd=fwd, bwd=bwd, fwd_ms={"pallas": 1.0, "xla": 2.0},
                bwd_ms={"pallas": 3.0, "xla": 4.0}, **kw)


LEDGER = {
    "ledger_format": 1, "version": 1, "round": 7, "device_kind": CHIP,
    "entries": [_entry(1024, 128, 128, "xla", "xla"),
                _entry(2048, 128, 32, "xla", "pallas",
                       fused_epilogue_wins=True),
                _entry(4096, 128, 8, "pallas", "pallas"),
                _entry(2048, 96, 32, "pallas", "xla")],
    "end_to_end": [dict(config="cfg_e2e", seq=2048, head_dim=128, bh=64,
                        causal=True, dtype="bfloat16", fwd="pallas",
                        bwd="pallas", note="an end-to-end A/B")],
}


def _use_ledger(tmp_path, doc):
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps(doc))
    for f in (flags, jflags):
        f.set_flags({"FLAGS_attention_ledger_path": str(path)})
    return path


def _both(*key, **kw):
    """(port decision, reference decision) for one shape key."""
    return ar.route(*key, **kw), jar.route(*key, **kw)


def _same(a, b):
    assert (a.fwd, a.bwd, a.source) == (b.fwd, b.bwd, b.source), (a, b)


@pytest.mark.parametrize("bh,seq,d", [
    (64, 2048, 128),     # the end-to-end row outranks the isolated one
    (32, 2048, 128),     # isolated rows
    (128, 1024, 128),
    (8, 4096, 128),
    (40, 2048, 96),      # nearest recorded batch*heads
])
def test_route_matches_reference_on_the_same_ledger(tmp_path, bh, seq, d):
    _use_ledger(tmp_path, LEDGER)
    port, ref = _both(bh, seq, seq, d, "bfloat16", True, platform="cpu",
                      device_kind=CHIP)
    _same(port, ref)
    assert port.source == ("ledger-e2e" if bh == 64 else "ledger")
    if bh == 64:
        assert "cfg_e2e" in port.provenance
    else:
        assert "measured on TestChip" in port.provenance and "r7" in \
            port.provenance


def test_other_device_ignored(tmp_path):
    _use_ledger(tmp_path, LEDGER)
    port, ref = _both(32, 2048, 2048, 128, "bfloat16", True, platform="cpu",
                      device_kind="OtherChip")
    _same(port, ref)
    assert port.source == "proxy" and "NOT a measurement" in port.provenance


def test_wrong_format_fails_open(tmp_path):
    _use_ledger(tmp_path, {"ledger_format": 999, "device_kind": CHIP,
                           "entries": LEDGER["entries"]})
    assert ar.load_ledger() is None and jar.load_ledger() is None
    port, ref = _both(32, 2048, 2048, 128, "bfloat16", True, platform="cpu",
                      device_kind=CHIP)
    _same(port, ref)
    assert port.source == "proxy"


def test_ledger_mode_never_measures(tmp_path):
    _use_ledger(tmp_path, LEDGER)
    for f in (flags, jflags):
        f.set_flags({"FLAGS_attention_router": "ledger"})
    port, ref = _both(4, 640, 640, 64, "float32", True, platform="cpu",
                      device_kind="cpu")
    _same(port, ref)
    assert port.source == "heuristic"
    # a hit still reads the ledger
    _same(*_both(32, 2048, 2048, 128, "bfloat16", True, platform="cpu",
                 device_kind=CHIP))


@pytest.mark.parametrize("bh,seq,d", [(8, 512, 64), (8, 1024, 128),
                                      (8, 2048, 96), (8, 1024, 96),
                                      (8, 4096, 64)])
def test_heuristic_mode_matches_reference(tmp_path, bh, seq, d):
    _use_ledger(tmp_path, LEDGER)
    for f in (flags, jflags):
        f.set_flags({"FLAGS_attention_router": "heuristic"})
    port, ref = _both(bh, seq, seq, d, "bfloat16", True, platform="cpu",
                      device_kind=CHIP)
    _same(port, ref)
    assert port.source == "heuristic"
    assert ar._heuristic(bh, seq, seq, d) == jar._heuristic(bh, seq, seq, d)


def test_proxy_matches_reference_off_the_card():
    key = (4, 640, 640, 64, "float32", True)
    port, ref = _both(*key, platform="cpu", device_kind="cpu")
    _same(port, ref)
    ar.clear_routing_cache()
    assert ar.route(*key, platform="cpu", device_kind="cpu") == port
    assert port.packed_grid is False


def test_decision_log_matches_reference(tmp_path):
    _use_ledger(tmp_path, LEDGER)
    keys = [(64, 2048, 2048, 128, "bfloat16", True),
            (4, 640, 640, 64, "float32", True),
            (64, 2048, 2048, 128, "bfloat16", True)]     # a cache hit
    for key in keys:
        _both(*key, platform="cpu", device_kind=CHIP)
    port, ref = ar.decision_log(), jar.decision_log()
    assert [k for k, _ in port] == [k for k, _ in ref] == keys[:2]
    for (_, a), (_, b) in zip(port, ref):
        _same(a, b)


@pytest.mark.parametrize("bh,seq,d,wins", [(32, 2048, 128, True),
                                           (128, 1024, 128, False),
                                           (32, 512, 128, False)])
def test_epilogue_fusion_wins_matches_reference(tmp_path, bh, seq, d, wins):
    _use_ledger(tmp_path, LEDGER)
    key = (bh, seq, seq, d, "bfloat16", True)
    assert ar.epilogue_fusion_wins(*key, device_kind=CHIP) is wins
    assert jar.epilogue_fusion_wins(*key, device_kind=CHIP) is wins
    assert ar.epilogue_fusion_wins(*key, device_kind="OtherChip") is False


def test_ledger_blocks_none_without_blocks(tmp_path):
    _use_ledger(tmp_path, LEDGER)
    assert ar.ledger_blocks("fwd", 32, 2048, 2048, 128, "bfloat16", True,
                            device_kind=CHIP) is None


def test_measurement_raises_without_a_card():
    """On a ledger miss for a CUDA device the router measures; a failure
    there (here: no card) raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ar.route(4, 640, 640, 64, "bfloat16", True, platform="cuda",
                 device_kind="NVIDIA H100 80GB HBM3")
    assert ar.decision_log() == []


def test_shipped_ledger():
    led = ar.load_ledger()
    assert led is not None, "the shipped attention_ledger.json must parse"
    assert led["ledger_format"] == ar.LEDGER_FORMAT
    assert led["device_kind"].startswith("NVIDIA")
    assert "W" in led["nvidia_smi"]                 # the power limit
    shapes = {(e["bh"], e["seq"], e["head_dim"]) for e in led["entries"]}
    # the reference's four A/B shapes and the port's two main-path shapes
    assert shapes == {(128, 1024, 128), (32, 2048, 128), (8, 4096, 128),
                      (32, 2048, 96), (128, 512, 128), (128, 2048, 128)}
    for e in led["entries"]:
        for kind in ("fwd_ms", "bwd_ms"):
            assert set(e[kind]) == {"pallas", "xla"}
            assert all(x > 0 for x in e[kind].values())
        assert e["fwd"] == min(e["fwd_ms"], key=e["fwd_ms"].get)
        assert e["bwd"] == min(e["bwd_ms"], key=e["bwd_ms"].get)
        assert isinstance(e["fused_epilogue_wins"], bool)
        assert e["fused_epilogue_wins"] == (
            e["epilogue_ms"]["fused"] < e["epilogue_ms"]["unfused"])
    (e2e,) = led["end_to_end"]
    assert (e2e["config"], e2e["bh"], e2e["seq"]) == ("llama_1.3b", 128,
                                                      2048)
    assert set(e2e["step_ms"]) == {"pallas", "xla"}
    assert e2e["bwd"] == min(e2e["step_ms"], key=e2e["step_ms"].get)


def test_shipped_ledger_bakes_from_its_measurement():
    """The shipped ledger is what bake_attention_ledger makes of the
    committed measurement file."""
    src = os.path.join(os.path.dirname(bake_attention_ledger.__file__),
                       "flash_vs_xla_h100.json")
    with open(src) as f:
        doc = json.load(f)
    with open(ar._DEFAULT_LEDGER) as f:
        shipped = json.load(f)
    assert bake_attention_ledger.bake_ledger(
        doc, "flash_vs_xla_h100.json") == shipped


def test_bake_load_dispatch(tmp_path):
    """bake -> write -> load -> route, through FLAGS_attention_ledger_path
    (the reference's TestLedgerRoundTrip)."""
    row = {"seq": 256, "batch": 2, "heads": 2, "head_dim": 64,
           "flash_fwd_ms": 1.0, "dense_fwd_ms": 2.0,
           "fwdbwd_ms_pallas": 3.0, "fwdbwd_ms_hybrid": 2.5,
           "fwdbwd_ms_dense": 5.0, "fused_epilogue_ms": 0.9,
           "unfused_epilogue_ms": 1.2, "max_abs_err": 0.001,
           "epilogue_max_abs_err": 0.01}
    e2e = [{"config": "c", "batch": 2, "seq": 256, "heads": 2,
            "head_dim": 64, "fwd": "pallas", "bwd": b, "steps": 2,
            "step_time_s": t, "mfu": m}
           for b, t, m in (("pallas", 0.5, 0.3), ("xla", 0.4, 0.35))]
    led = bake_attention_ledger.bake_ledger(
        {"device_kind": CHIP, "dtype": "float32", "rows": [row],
         "end_to_end": e2e}, round_num=99)
    out = tmp_path / "ledger.json"
    out.write_text(json.dumps(led))
    flags.set_flags({"FLAGS_attention_ledger_path": str(out)})
    dec = ar.route(2, 256, 256, 64, "float32", True, platform="cpu",
                   device_kind=CHIP)
    assert (dec.fwd, dec.bwd, dec.source) == ("pallas", "xla", "ledger")
    assert "r99" in dec.provenance
    assert ar.epilogue_fusion_wins(2, 256, 256, 64, "float32", True,
                                   device_kind=CHIP)
    dec = ar.route(4, 256, 256, 64, "float32", True, platform="cpu",
                   device_kind=CHIP)
    assert (dec.fwd, dec.bwd, dec.source) == ("pallas", "xla", "ledger-e2e")
    # a config measured under one backward mode only is no A/B
    assert bake_attention_ledger.bake_ledger(
        {"rows": [], "end_to_end": e2e[:1]})["end_to_end"] == []


def test_flash_vs_xla_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr("sys.argv", ["flash_vs_xla", "--no-e2e"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        flash_vs_xla.main()


@pytest.mark.parametrize("h,kvh", [(2, 2), (4, 2)])
def test_xla_backward_matches_reference_hybrid(h, kvh):
    """FLAGS_flash_attention_bwd=xla: the dense rematerialised backward
    against jax.grad of the reference's hybrid (the Pallas forward, its
    `_dense_remat_bwd`), as the reference's TestBackendParity does, and
    against the port's own 'pallas' mode."""
    rs = np.random.RandomState(1)
    s, d = 256, 64
    q = rs.randn(h, s, d).astype(np.float32)
    k, v = (rs.randn(kvh, s, d).astype(np.float32) for _ in range(2))
    scale = d ** -0.5

    def ref_loss(q_, k_, v_):
        return jnp.sum(jfa._flash_attention_bhsd(q_, k_, v_, True, scale,
                                                 h // kvh) ** 2)
    jflags.set_flags({"FLAGS_flash_attention_bwd": "xla"})
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = {}
    for mode in ("xla", "pallas"):
        flags.set_flags({"FLAGS_flash_attention_bwd": mode})
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fa._FlashAttention.apply(*leaves, True, scale, h // kvh)
        (out ** 2).sum().backward()
        grads[mode] = [x.grad for x in leaves]
    for mode, got in grads.items():
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{mode} d{name}")


def test_dense_remat_bwd_matches_reference():
    rs = np.random.RandomState(2)
    q, g = (rs.randn(4, 96, 32).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(2, 96, 32).astype(np.float32) for _ in range(2))
    want = jfa._dense_remat_bwd(*(jnp.asarray(x) for x in (q, k, v)), True,
                                0.2, 2, jnp.asarray(g))
    got = fa._dense_remat_bwd(*(torch.as_tensor(x) for x in (q, k, v)),
                              True, 0.2, 2, torch.as_tensor(g))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    out = fa._xla_attention_bhsd(*(torch.as_tensor(x) for x in (q, k, v)),
                                 True, 0.2, 2)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jfa._xla_attention_bhsd(
            jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 0),
            jnp.repeat(jnp.asarray(v), 2, 0), True, 0.2)),
        rtol=1e-5, atol=1e-5)


def test_backward_auto_follows_the_router(monkeypatch):
    picked = []

    def fake_route(*key, **kw):
        picked.append(key)
        return ar.Decision(fwd="pallas", bwd="xla")
    monkeypatch.setattr(ar, "route", fake_route)
    x = torch.randn(2, 64, 64, requires_grad=True)
    fa._FlashAttention.apply(x, x, x, True, 0.1, 1).sum().backward()
    assert picked == [(2, 64, 64, 64, torch.float32, True)]
    flags.set_flags({"FLAGS_flash_attention_bwd": "bogus"})
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        fa._FlashAttention.apply(x, x, x, True, 0.1, 1).sum().backward()


CUDA = torch.device("cuda")     # only inspected, never allocated on


def test_use_pallas_follows_router(monkeypatch):
    """The reference's TestSdpaRouting (:321-345) on a CUDA device."""
    calls = {}

    def fake_route(bh, sq, sk, d, dtype, causal, **kw):
        calls["key"] = (bh, sq, sk, d, dtype, causal, kw)
        return ar.Decision(fwd="pallas", bwd="pallas")
    monkeypatch.setattr(ar, "route", fake_route)
    assert attn._use_pallas((2, 512, 4, 64), 64, False, dtype=torch.bfloat16,
                            causal=True, device=CUDA) is True
    assert calls["key"] == (8, 512, 512, 64, torch.bfloat16, True,
                            {"platform": "cuda"})
    monkeypatch.setattr(ar, "route",
                        lambda *a, **kw: ar.Decision(fwd="xla", bwd="xla"))
    assert attn._use_pallas((2, 512, 4, 64), 64, False, dtype=torch.bfloat16,
                            causal=True, device=CUDA) is False


def test_use_pallas_dense_cases(monkeypatch):
    monkeypatch.setattr(ar, "route", lambda *a, **kw: ar.Decision(
        fwd="pallas", bwd="pallas"))
    shape = (2, 2048, 4, 128)
    # a mask forces dense, as in the reference
    assert attn._use_pallas(shape, 128, True, device=CUDA) is False
    # off CUDA: dense, as the reference off a TPU
    assert attn._use_pallas(shape, 128, False, dtype=torch.bfloat16,
                            device=torch.device("cpu")) is False
    # a dtype or head dim the kernels do not take
    assert attn._use_pallas(shape, 128, False, dtype=torch.float32,
                            device=CUDA) is False
    assert attn._use_pallas(shape, 256, False, dtype=torch.bfloat16,
                            device=CUDA) is False
    with attn.sdp_kernel(enable_flash=False):
        assert flags.flag_value("flash_attention_backend") == "xla"
        assert attn._use_pallas(shape, 128, False, dtype=torch.bfloat16,
                                device=CUDA) is False
    with attn.sdp_kernel(enable_flash=True):
        assert attn._use_pallas(shape, 128, False, dtype=torch.float32,
                                device=CUDA) is True
    assert flags.flag_value("flash_attention_backend") == "auto"


def test_prefill_follows_router(monkeypatch):
    decisions = iter([ar.Decision(fwd="pallas", bwd="pallas"),
                      ar.Decision(fwd="xla", bwd="xla")])
    monkeypatch.setattr(ar, "route", lambda *a, **kw: next(decisions))
    assert generation._prefill_flash_routed(8, 512, 128, torch.bfloat16,
                                            CUDA) is True
    assert generation._prefill_flash_routed(8, 512, 128, torch.bfloat16,
                                            CUDA) is False
    assert generation._prefill_flash_routed(8, 512, 128, torch.bfloat16,
                                            torch.device("cpu")) is False


def test_flags_api(monkeypatch):
    assert pt.get_flags("FLAGS_flash_attention_bwd") == {
        "FLAGS_flash_attention_bwd": "auto"}
    pt.set_flags({"flash_attention_bwd": "xla"})
    assert pt.get_flags(["flash_attention_bwd"]) == {
        "flash_attention_bwd": "xla"}
    with pytest.raises(ValueError, match="unknown flag"):
        pt.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(ValueError, match="unknown flag"):
        pt.get_flags("no_such_flag")
    monkeypatch.setenv("FLAGS_port_test_flag", "7")
    assert flags.define_flag("port_test_flag", 1) == 7
