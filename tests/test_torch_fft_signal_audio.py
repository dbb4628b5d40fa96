"""The port's fft, signal, audio and linalg.fp8_fp8_half_gemm_fused against
the JAX package's, on the CPU in float32 (complex64), with inputs drawn by
numpy from a seed. Reference calls run under one jax.jit each.

Tolerances: transforms and features in float32, rtol 1e-4 and atol 1e-4
of values of order 1-100 (different FFT algorithms, pocketfft against
XLA's); the fp8 GEMM's half outputs within one half-precision step
(rtol 2e-3), its float32 sums being the same up to order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.framework.core import Tensor as RefTensor
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-4


def _ref(fn, *arrays):
    """fn over reference tensors of `arrays`, under one jax.jit."""
    def run(*a):
        out = fn(*(RefTensor(x) for x in a))
        if isinstance(out, (list, tuple)):
            return [o._data for o in out]
        return out._data
    return jax.jit(run)(*(jnp.asarray(a) for a in arrays))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


_R = np.random.RandomState(0)
REAL = _R.randn(4, 6, 8).astype(np.float32)
CPLX = (_R.randn(4, 6, 8) + 1j * _R.randn(4, 6, 8)).astype(np.complex64)
SIGNAL = _R.randn(2, 1000).astype(np.float32)

FFT_CASES = [
    ("fft", CPLX, {}), ("fft", REAL, dict(n=10, axis=1, norm="ortho")),
    ("ifft", CPLX, dict(norm="forward")), ("rfft", REAL, dict(n=6)),
    ("irfft", CPLX, dict(n=12)), ("hfft", CPLX, dict(n=14, axis=0)),
    ("ihfft", REAL, {}),
    ("fft2", CPLX, {}), ("ifft2", CPLX, dict(s=(4, 5), norm="ortho")),
    ("rfft2", REAL, dict(axes=(0, 2))), ("irfft2", CPLX, {}),
    ("fftn", CPLX, {}), ("ifftn", CPLX, dict(axes=(0, 1))),
    ("rfftn", REAL, dict(s=(3, 6, 8))), ("irfftn", CPLX, {}),
    ("hfft2", CPLX, {}), ("ihfft2", REAL, {}),
    ("hfftn", CPLX, dict(axes=(1, 2))), ("ihfftn", REAL, {}),
    ("fftshift", REAL, dict(axes=(1,))), ("ifftshift", CPLX, {}),
]


@pytest.mark.parametrize("name,x,kw", FFT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(FFT_CASES)])
def test_fft_matches_reference(name, x, kw):
    want = _ref(lambda t: getattr(paddle.fft, name)(t, **kw), x)
    got = getattr(pt.fft, name)(torch.as_tensor(x), **kw)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got, want)


def test_fft_norm_and_frequencies():
    with pytest.raises(ValueError):
        pt.fft.fft(torch.ones(4, dtype=torch.complex64), norm="bad")
    for f in ("fftfreq", "rfftfreq"):
        got = getattr(pt.fft, f)(10, d=0.1, device="cpu")
        _close(got, getattr(paddle.fft, f)(10, d=0.1)._data)
        assert got.dtype == torch.float32
    assert pt.fft.fftfreq(4, dtype="float64", device="cpu").dtype == \
        torch.float64


def test_fft_gradient_matches_reference():
    x = SIGNAL[0, :64]

    def run(P, t, leaf):
        t = leaf(t)
        X = P.fft.rfft(t)
        return P.grad((X.real() * X.real() + X.imag() * X.imag()).sum()
                      if P is paddle else X.abs().pow(2).sum(), t)[0]

    want = jax.jit(lambda a: run(paddle, RefTensor(a, stop_gradient=False),
                                 lambda t: t)._data)(x)
    got = run(pt, torch.as_tensor(x), lambda t: t.requires_grad_(True))
    _close(got, want, atol=1e-3)


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add(axis):
    x = SIGNAL[0, :40] if axis == -1 else SIGNAL[:, :40].T.copy()
    want = _ref(lambda t: paddle.signal.frame(t, 8, 3, axis=axis), x)
    got = pt.signal.frame(torch.as_tensor(x), 8, 3, axis=axis)
    _close(got, want)
    back = _ref(lambda t: paddle.signal.overlap_add(t, 3, axis=axis),
                np.asarray(want))
    _close(pt.signal.overlap_add(got, 3, axis=axis), back)
    with pytest.raises(ValueError):
        pt.signal.frame(torch.zeros(2, 3, 40), 8, 3, axis=1)


STFT_CASES = {
    "default": dict(n_fft=128),
    "hann_hop": dict(n_fft=128, hop_length=32, window="hann"),
    "short_window": dict(n_fft=128, hop_length=40, win_length=100,
                         window="hann"),
    "constant_normalized": dict(n_fft=64, pad_mode="constant",
                                normalized=True),
    "two_sided_uncentred": dict(n_fft=64, onesided=False, center=False),
}


@pytest.mark.parametrize("name", sorted(STFT_CASES))
def test_stft_istft_match_reference(name):
    kw = dict(STFT_CASES[name])
    win = kw.pop("window", None)
    w = None if win is None else np.hanning(kw.get("win_length", kw[
        "n_fft"]) + 1)[:-1].astype(np.float32)
    args = (SIGNAL,) if w is None else (SIGNAL, w)

    def ref_stft(t, *wt):
        return paddle.signal.stft(t, window=wt[0] if wt else None, **kw)
    want = _ref(ref_stft, *args)
    T = [torch.as_tensor(a) for a in args]
    got = pt.signal.stft(T[0], window=T[1] if w is not None else None, **kw)
    assert got.dtype == torch.complex64
    _close(got, want, atol=1e-3)
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    if not kw.get("center", True):
        return           # the window envelope vanishes at the ends
    spec = np.array(want)

    def ref_istft(s, *wt):
        return paddle.signal.istft(s, window=wt[0] if wt else None,
                                   length=1000, **ikw)
    back = _ref(ref_istft, spec, *args[1:])
    out = pt.signal.istft(torch.as_tensor(spec), window=T[1] if w is not
                          None else None, length=1000, **ikw)
    _close(out, back, atol=1e-3)
    if w is not None or name == "default":
        # the signal back, up to the last whole hop
        _close(out, SIGNAL[:, :out.shape[-1]], atol=1e-3)


def test_stft_of_one_signal_and_istft_rules():
    spec = pt.signal.stft(torch.as_tensor(SIGNAL[0]), 64)
    assert spec.shape == (33, 1000 // 16 + 1)
    with pytest.raises(ValueError):
        pt.signal.istft(spec, 64, return_complex=True)
    two = pt.signal.stft(torch.as_tensor(SIGNAL[0]), 64, onesided=False)
    back = pt.signal.istft(two, 64, onesided=False, return_complex=True,
                           length=1000)
    assert back.is_complex()
    _close(back.real, SIGNAL[0, :back.shape[-1]], atol=1e-3)


# -- audio -------------------------------------------------------------------

@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_matches_reference(htk):
    A, J = pt.audio.functional, paddle.audio.functional
    hz = np.array([0.0, 440.0, 1000.0, 8000.0], np.float32)
    assert A.hz_to_mel(440.0, htk) == J.hz_to_mel(440.0, htk)
    assert A.mel_to_hz(20.0, htk) == J.mel_to_hz(20.0, htk)
    mel = A.hz_to_mel(torch.as_tensor(hz), htk)
    _close(mel, J.hz_to_mel(paddle.to_tensor(hz), htk)._data, rtol=1e-6)
    _close(A.mel_to_hz(mel, htk),
           J.mel_to_hz(paddle.to_tensor(mel.numpy()), htk)._data, rtol=1e-6)
    _close(A.mel_frequencies(16, 20.0, 8000.0, htk, device="cpu"),
           J.mel_frequencies(16, 20.0, 8000.0, htk)._data, rtol=1e-6)
    for norm in ("slaney", None):
        _close(A.compute_fbank_matrix(16000, 256, 20, 50.0, None, htk, norm,
                                      device="cpu"),
               J.compute_fbank_matrix(16000, 256, 20, 50.0, None, htk,
                                      norm)._data, rtol=1e-6, atol=1e-7)


def test_audio_functions_match_reference():
    A, J = pt.audio.functional, paddle.audio.functional
    _close(A.fft_frequencies(16000, 256, device="cpu"),
           J.fft_frequencies(16000, 256)._data, rtol=1e-6)
    for norm in ("ortho", None):
        _close(A.create_dct(13, 40, norm, device="cpu"),
               J.create_dct(13, 40, norm)._data, rtol=1e-6, atol=1e-7)
    power = np.abs(SIGNAL[:, :64]) ** 2 + 1e-12
    for top_db in (None, 20.0):
        _close(A.power_to_db(torch.as_tensor(power), top_db=top_db),
               _ref(lambda t: J.power_to_db(t, top_db=top_db), power))
    for win in ("hann", "hamming", "blackman", "bohman", "bartlett",
                "triang", "boxcar", "taylor", ("kaiser", 8.0),
                ("gaussian", 3.0), ("exponential", 2.0)):
        for fftbins in (True, False):
            _close(A.get_window(win, 31, fftbins, device="cpu"),
                   J.get_window(win, 31, fftbins)._data, rtol=1e-6,
                   atol=1e-7)
    with pytest.raises(ValueError):
        A.get_window("nope", 8, device="cpu")


FEATURES = {
    "Spectrogram": dict(n_fft=256),
    "MelSpectrogram": dict(sr=16000, n_fft=256, n_mels=32),
    "LogMelSpectrogram": dict(sr=16000, n_fft=256, n_mels=32, top_db=80.0),
    "MFCC": dict(sr=16000, n_mfcc=13, n_fft=256, n_mels=32),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_features_match_reference(name):
    kw = FEATURES[name]
    layer = getattr(pt.audio.features, name)(device="cpu", **kw)
    assert layer.state_dict() == {}
    ref = getattr(paddle.audio.features, name)(**kw)
    want = _ref(ref, SIGNAL)
    got = layer(torch.as_tensor(SIGNAL))
    scale = float(np.abs(np.asarray(want)).max())
    _close(got / scale, np.asarray(want) / scale, rtol=0, atol=RTOL)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_wav_round_trip_as_the_reference(tmp_path, bits):
    wave = np.clip(SIGNAL * 0.3, -0.99, 0.99)
    path = str(tmp_path / "a.wav")
    pt.audio.backends.save(path, torch.as_tensor(wave), 8000,
                           bits_per_sample=bits)
    got, sr = pt.audio.backends.load(path, device="cpu")
    want, sr2 = paddle.audio.backends.load(path)
    assert sr == sr2 == 8000
    _close(got, want.numpy(), rtol=0, atol=0)
    info = pt.audio.backends.info(path)
    assert (info.num_channels, info.num_samples, info.bits_per_sample) == \
        (2, 1000, bits)
    ref_path = str(tmp_path / "b.wav")
    paddle.audio.save(ref_path, paddle.to_tensor(wave), 8000,
                      bits_per_sample=bits)
    pt.audio.save(path, torch.as_tensor(wave), 8000, bits_per_sample=bits)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    got, _ = pt.audio.load(path, 10, 100, device="cpu")
    _close(got, paddle.audio.load(path, 10, 100)[0].numpy(), rtol=0, atol=0)
    assert pt.audio.info(path).num_frames == 1000
    assert pt.audio.backends.get_current_backend() == "wave_backend"
    with pytest.raises(NotImplementedError):
        pt.audio.backends.set_backend("soundfile")


def test_datasets_as_the_reference():
    for cls in ("TESS", "ESC50"):
        got = getattr(pt.audio.datasets, cls)(mode="test")
        want = getattr(paddle.audio.datasets, cls)(mode="test")
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got[5][0], want[5][0])
    feats = pt.audio.datasets.ESC50(feat_type="mfcc", n_mfcc=13, n_fft=256)
    assert feats[0][0].shape == (13, int(44100 * 0.25) // 64 + 1)


# -- linalg.fp8_fp8_half_gemm_fused -------------------------------------------

def _fp8(shape, seed):
    """float32 values an e4m3 holds, as (numpy float32, port fp8)."""
    t = torch.as_tensor(np.random.RandomState(seed).randn(*shape).astype(
        np.float32) * 2).to(torch.float8_e4m3fn)
    return t.float().numpy(), t


FP8_CASES = {
    "identity": dict(),
    "bias_gelu_half": dict(activation_type="gelu", scale=0.5, bias=True),
    "relu_bf16_transposed": dict(activation_type="relu", transpose_x=True,
                                 transpose_y=True,
                                 output_dtype="bfloat16"),
    "batched": dict(batch=True),
}


@pytest.mark.parametrize("name", sorted(FP8_CASES))
def test_fp8_gemm_matches_reference(name):
    kw = dict(FP8_CASES[name])
    batch = (3,) if kw.pop("batch", False) else ()
    tx, ty = kw.get("transpose_x", False), kw.get("transpose_y", False)
    xn, xt = _fp8(batch + ((32, 24) if tx else (24, 32)), 1)
    yn, yt = _fp8(batch + ((16, 32) if ty else (32, 16)), 2)
    bias = np.random.RandomState(3).randn(16).astype(np.float32)
    use_bias = kw.pop("bias", False)
    e4m3 = jnp.float8_e4m3fn

    def ref(a, b, c):
        return paddle.linalg.fp8_fp8_half_gemm_fused(
            RefTensor(a.astype(e4m3)), RefTensor(b.astype(e4m3)),
            RefTensor(c) if use_bias else None, **kw)._data
    want = jax.jit(ref)(xn, yn, bias)
    before = dict(pt.linalg.FP8_GEMM_PATHS)
    got = pt.linalg.fp8_fp8_half_gemm_fused(
        xt, yt, torch.as_tensor(bias) if use_bias else None, **kw)
    assert pt.linalg.FP8_GEMM_PATHS["upcast"] == before["upcast"] + 1
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got.float(), np.asarray(want).astype(np.float32), rtol=2e-3,
           atol=2e-3)
