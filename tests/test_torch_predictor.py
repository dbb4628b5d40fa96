"""The port's jit.save / jit.load and predictor API (jit/__init__.py,
inference/__init__.py) against the JAX package's, mirroring
tests/test_quant_infer_profiler.py's TestInference and
TestReviewRegressions; and K1 and K2 as registered operators, which is
what lets torch.export record them.

The reference's Predictor runs a StableHLO program; the port's runs a
torch.export program that takes the params as an input. Both save the
params as the same npz: a reference `.pdiparams` (bf16 included) loads
into the port bit for bit, and the port's into the reference. Outputs of
the two Predictors on the same weights agree within 1e-5 (f32; the
reference test's tolerance, for two frameworks' f32 products). A tiny
llama saved by the port and run through its Predictor gives its own eager
logits bit for bit (the program runs the forward's own ops). Every
Predictor here asks for the CPU (`Config.disable_gpu()`); the default is
CUDA.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import nn as jnn
from paddle_tpu.jit import _load_npz_params as j_load_npz_params
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import flash_attention as fa
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.relu = jnn.ReLU()
        self.fc2 = jnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(16, 32, device="cpu")
        self.fc2 = Linear(32, 4, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _nets(seed):
    """(reference Net, port Net with its weights), eval mode."""
    paddle.seed(seed)
    ref = JNet()
    ref.eval()
    port = Net()
    port.load_state_dict({k: torch.tensor(np.asarray(v._data))
                          for k, v in ref.state_dict().items()})
    port.eval()
    return ref, port


def _cpu_config(path):
    cfg = inference.Config(path)
    cfg.disable_gpu()
    return cfg


def _run(predictor, x):
    h = predictor.get_input_handle(predictor.get_input_names()[0])
    h.copy_from_cpu(x)
    predictor.run()
    return predictor.get_output_handle(
        predictor.get_output_names()[0]).copy_to_cpu()


class TestInference:
    def test_jit_save_predictor_roundtrip(self, tmp_path):
        ref, port = _nets(2)
        x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
        want = port(torch.from_numpy(x)).detach().numpy()
        prefix = str(tmp_path / "model")
        jit.save(port, prefix, input_spec=[jit.InputSpec([4, 16], "float32")])
        assert os.path.exists(prefix + ".pdmodel")
        assert os.path.exists(prefix + ".pdiparams")
        out = _run(inference.create_predictor(_cpu_config(prefix)), x)
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        # against the reference's Predictor on the same weights
        jprefix = str(tmp_path / "jmodel")
        paddle.jit.save(ref, jprefix, input_spec=[
            paddle.jit.InputSpec([4, 16], "float32")])
        jout = _run(jinference.create_predictor(jinference.Config(jprefix)),
                    x)
        np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)

    def test_list_style_run(self, tmp_path):
        _ref, port = _nets(3)
        x = np.random.RandomState(4).randn(4, 16).astype(np.float32)
        prefix = str(tmp_path / "m")
        jit.save(port, prefix, input_spec=[jit.InputSpec([4, 16], "float32")])
        pred = inference.create_predictor(_cpu_config(prefix))
        outs = pred.run([x])
        np.testing.assert_allclose(
            outs[0].copy_to_cpu(),
            port(torch.from_numpy(x)).detach().numpy(), rtol=TOL, atol=TOL)
        assert pred.get_output_names() == ["out0"]

    def test_jit_load_translated_layer(self, tmp_path):
        _ref, port = _nets(4)
        x = np.random.RandomState(5).randn(2, 16).astype(np.float32)
        want = port(torch.from_numpy(x)).detach().numpy()
        prefix = str(tmp_path / "m2")
        jit.save(port, prefix, input_spec=[jit.InputSpec([2, 16], "float32")])
        loaded = jit.load(prefix, device="cpu")
        out = loaded(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
        assert loaded._input_spec == [((2, 16), "float32")]


class TestReviewRegressions:
    def test_config_pdmodel_suffix(self, tmp_path):
        _ref, port = _nets(6)
        prefix = str(tmp_path / "m3")
        jit.save(port, prefix, input_spec=[jit.InputSpec([1, 16], "float32")])
        pred = inference.create_predictor(_cpu_config(prefix + ".pdmodel"))
        _run(pred, np.zeros((1, 16), np.float32))
        with pytest.raises(RuntimeError, match="run"):
            inference.Predictor(_cpu_config(prefix)).get_output_handle(
                "out0")

    def test_jit_save_restores_train_mode(self, tmp_path):
        _ref, port = _nets(7)
        port.train()

        class Bad:
            shape = (None,)   # invalid spec makes the export fail
            dtype = "float32"
        with pytest.raises(Exception):
            jit.save(port, str(tmp_path / "bad"), input_spec=[Bad()])
        assert port.training is True


class TestArtifacts:
    def test_reference_pdiparams_load_bit_for_bit(self, tmp_path):
        """A reference bf16 llama's params-only artifact: the port reads
        every array bit for bit, without ml_dtypes."""
        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=1, num_attention_heads=2,
                   dtype="bfloat16")
        paddle.seed(1)
        ref = JLlama(JConfig(**cfg))
        prefix = str(tmp_path / "ref")
        paddle.jit.save(ref, prefix)
        loaded = jit.load(prefix, device="cpu").state_dict()
        want = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
        assert set(loaded) == set(want)
        for k, w in want.items():
            got = loaded[k]
            assert str(got.dtype) == f"torch.{w.dtype.name}", k
            assert got.shape == w.shape, k
            assert np.array_equal(
                got.contiguous().view(torch.uint8).numpy().tobytes(),
                w.tobytes()), k

    def test_port_pdiparams_load_in_the_reference(self, tmp_path):
        pt_model = LlamaForCausalLM(LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2, dtype="bfloat16"),
            device="cpu")
        prefix = str(tmp_path / "port")
        jit.save(pt_model, prefix)
        with open(prefix + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
        got = j_load_npz_params(prefix + ".pdiparams", meta)
        for k, t in pt_model.state_dict().items():
            assert got[k].dtype.name == "bfloat16", k
            assert got[k].tobytes() == t.view(torch.uint8).numpy().tobytes()

    def test_reference_program_is_refused(self, tmp_path):
        ref, _port = _nets(8)
        prefix = str(tmp_path / "jm")
        paddle.jit.save(ref, prefix, input_spec=[
            paddle.jit.InputSpec([2, 16], "float32")])
        with pytest.raises(ValueError, match="StableHLO"):
            jit.load(prefix, device="cpu")
        with pytest.raises(ValueError, match="StableHLO"):
            inference.create_predictor(_cpu_config(prefix))

    def test_params_only_artifact(self, tmp_path):
        """As the reference's: jit.load gives a layer whose call raises,
        and a Predictor refuses the artifact."""
        _ref, port = _nets(9)
        prefix = str(tmp_path / "po")
        jit.save(port, prefix)
        loaded = jit.load(prefix, device="cpu")
        assert set(loaded.state_dict()) == set(port.state_dict())
        with pytest.raises(RuntimeError, match="params only"):
            loaded(torch.zeros(1, 16))
        with pytest.raises(ValueError, match="no serialized program"):
            inference.create_predictor(_cpu_config(prefix))

    def test_newer_format_is_refused(self, tmp_path):
        _ref, port = _nets(10)
        prefix = str(tmp_path / "nf")
        jit.save(port, prefix)
        with open(prefix + ".pdmodel", "rb") as f:
            meta = pickle.load(f)
        meta["format_version"] = jit.FORMAT_VERSION + 1
        with open(prefix + ".pdmodel", "wb") as f:
            pickle.dump(meta, f)
        with pytest.raises(ValueError, match="format version"):
            jit.load(prefix, device="cpu")
        with pytest.raises(ValueError, match="format version"):
            inference.create_predictor(_cpu_config(prefix))

    def test_program_holds_no_weights(self, tmp_path):
        model = LlamaForCausalLM(LlamaConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4), device="cpu")
        prefix = str(tmp_path / "nw")
        jit.save(model, prefix, input_spec=[jit.InputSpec([2, 16], "int64")])
        params = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
        assert os.path.getsize(prefix + ".pdmodel") < params / 4


class TestPredictorDevice:
    def test_cuda_is_the_default(self):
        cfg = inference.Config("x")
        assert cfg.use_gpu() and cfg.summary()["device"] == "cuda"
        cfg.enable_use_gpu(device_id=1)
        assert cfg.summary()["device"] == "cuda:1"
        cfg.disable_gpu()
        assert not cfg.use_gpu()

    def test_no_card_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _ref, port = _nets(11)
        prefix = str(tmp_path / "d")
        jit.save(port, prefix, input_spec=[jit.InputSpec([1, 16], "float32")])
        with pytest.raises(RuntimeError, match="CUDA"):
            inference.create_predictor(inference.Config(prefix))

    def test_low_precision_is_recorded_not_cast(self, tmp_path):
        _ref, port = _nets(12)
        x = np.random.RandomState(13).randn(2, 16).astype(np.float32)
        prefix = str(tmp_path / "lp")
        jit.save(port, prefix, input_spec=[jit.InputSpec([2, 16], "float32")])
        cfg = _cpu_config(prefix)
        cfg.enable_low_precision(inference.PrecisionType.Bfloat16)
        assert cfg.summary()["precision"] == inference.PrecisionType.Bfloat16
        out = _run(inference.create_predictor(cfg), x)
        assert out.dtype == np.float32
        np.testing.assert_allclose(
            out, port(torch.from_numpy(x)).detach().numpy(), rtol=TOL,
            atol=TOL)

    def test_version(self):
        assert inference.get_version() == "0.1.0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_llama_predictor_equals_eager(tmp_path, dtype):
    """A tiny llama saved and run through the Predictor: its own eager
    logits bit for bit (bf16 logits come back as float32, which holds
    them exactly)."""
    torch.manual_seed(0)
    paddle.seed(0)
    cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2)
    ref = JLlama(JConfig(**cfg))
    model = LlamaForCausalLM(LlamaConfig(**cfg, dtype=dtype), device="cpu")
    load_reference_state(model, {k: np.asarray(v._data)
                                 for k, v in ref.state_dict().items()})
    model.eval()
    ids = np.random.RandomState(1).randint(0, 128, (2, 24))
    prefix = str(tmp_path / "llama")
    jit.save(model, prefix, input_spec=[jit.InputSpec([2, 24], "int64")])
    pred = inference.create_predictor(_cpu_config(prefix))
    outs = [_run(pred, ids) for _ in range(2)]
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).float().numpy()
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], want)


# -- K1 and K2 as registered operators -----------------------------------------

def _attn_inputs(seed, b=1, s=32, h=4, kvh=2, d=64):
    rs = np.random.RandomState(seed)
    return [torch.tensor(rs.randn(b, s, n, d), dtype=torch.float32)
            for n in (h, kvh, kvh)]


class _Attn(torch.nn.Module):
    def forward(self, q, k, v):
        return fa.flash_attention_bshd(q, k, v, causal=True)


class _AttnEpilogue(torch.nn.Module):
    def forward(self, q, k, v, residual, w):
        return fa.flash_attention_rms_epilogue_bshd(q, k, v, residual, w)


def _targets(ep):
    return [n.target for n in ep.graph.nodes if n.op == "call_function"]


def test_export_holds_the_flash_fwd_operator():
    """torch.export of the kernels' entry point records K1 as one node
    (the CPU takes the kernel route whenever flash_attention_bshd is
    called), and the exported program gives the eager result."""
    q, k, v = _attn_inputs(0)
    ep = torch.export.export(_Attn(), (q, k, v))
    assert _targets(ep).count(torch.ops.paddle_tpu_torch.flash_fwd.default) \
        == 1
    assert torch.equal(ep.module()(q, k, v), _Attn()(q, k, v))


def test_export_holds_the_epilogue_operator():
    q, k, v = _attn_inputs(1, kvh=4)
    rs = np.random.RandomState(2)
    residual = torch.tensor(rs.randn(*q.shape), dtype=torch.float32)
    w = torch.tensor(rs.randn(q.shape[-1]), dtype=torch.float32)
    ep = torch.export.export(_AttnEpilogue(), (q, k, v, residual, w))
    assert _targets(ep).count(
        torch.ops.paddle_tpu_torch.flash_fwd_rms_epilogue.default) == 1
    assert torch.equal(ep.module()(q, k, v, residual, w),
                       _AttnEpilogue()(q, k, v, residual, w))


def test_flash_attention_goes_through_the_operator(monkeypatch):
    """_flash_fwd_bhsd reaches the plain version only through the
    registered operator on the CPU: the op's CPU kernel is the plain
    version, and the result is the plain version's bit for bit."""
    q = torch.randn(4, 40, 64)
    k = torch.randn(2, 40, 64)
    v = torch.randn(2, 40, 64)
    calls = []
    real = fa._flash_fwd_bhsd_plain
    monkeypatch.setattr(fa, "_flash_fwd_bhsd_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out, lse = fa._flash_fwd_bhsd(q, k, v, True, 0.125, 2)
    want_out, want_lse = real(q, k, v, True, 0.125, 2)
    assert calls == [1]
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_flash_fwd(dtype):
    q, k, v = (t.to(dtype) for t in _attn_inputs(3, b=2, s=24))
    q, k, v = (t.transpose(1, 2).reshape(-1, 24, 64).contiguous()
               for t in (q, k, v))
    torch.library.opcheck(fa.flash_fwd_op, (q, k, v, True, 0.125, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_flash_fwd_rms_epilogue(dtype):
    rs = np.random.RandomState(4)
    q, k, v, residual = (torch.tensor(rs.randn(4, 24, 64)).to(dtype)
                         for _ in range(4))
    w = torch.tensor(rs.randn(64), dtype=torch.float32)
    torch.library.opcheck(fa.flash_fwd_rms_epilogue_op,
                          (q, k, v, residual, w, True, 0.125, 1, 1e-6, 64))
