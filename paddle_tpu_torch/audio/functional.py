"""Audio DSP functions. reference: paddle_tpu/audio/functional.py
(hz_to_mel, mel_to_hz, mel_frequencies, fft_frequencies,
compute_fbank_matrix, power_to_db, create_dct, get_window).

The mel scales, filterbanks, DCT bases and windows are built on the host
in numpy, once, by the reference's own formulas, then put on the device
(the default one unless `device` says); power_to_db is torch math on the
spectrogram's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dtypes import convert_dtype

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct", "get_window"]


def _host(x):
    """A tensor's values on the host, else x as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


# Slaney's mel scale: linear below 1 kHz, logarithmic above:
# (f_min, Hz a mel, the knee in Hz, log step a mel above it)
_SLANEY = (0.0, 200.0 / 3, 1000.0, math.log(6.4) / 27.0)


def hz_to_mel(freq, htk=False):
    """Hz to mels (Slaney's scale, or HTK's): a float for a number, a
    tensor on the input's device for a tensor."""
    f = _host(freq)
    if htk:
        mel = 2595.0 * np.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp, min_log_hz, logstep = _SLANEY
        mel = (f - f_min) / f_sp
        min_log_mel = (min_log_hz - f_min) / f_sp
        mel = np.where(
            f >= min_log_hz,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
            mel)
    if not isinstance(freq, torch.Tensor):
        return float(mel) if mel.ndim == 0 else torch.as_tensor(mel)
    return torch.as_tensor(mel, device=freq.device)


def mel_to_hz(mel, htk=False):
    m = _host(mel)
    if htk:
        hz = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp, min_log_hz, logstep = _SLANEY
        hz = f_min + f_sp * m
        min_log_mel = (min_log_hz - f_min) / f_sp
        hz = np.where(m >= min_log_mel,
                      min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
    if not isinstance(mel, torch.Tensor):
        return float(hz) if hz.ndim == 0 else torch.as_tensor(hz)
    return torch.as_tensor(hz, device=mel.device)


def _mel_frequencies(n_mels, f_min, f_max, htk, dtype):
    low, high = hz_to_mel(f_min, htk), hz_to_mel(f_max, htk)
    return np.asarray([mel_to_hz(float(m), htk)
                       for m in np.linspace(low, high, n_mels)], dtype)


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32", *, device=None):
    """n_mels frequencies evenly spaced on the mel scale."""
    return torch.as_tensor(_mel_frequencies(n_mels, f_min, f_max, htk,
                                            dtype),
                           device=resolve_device(device))


def fft_frequencies(sr, n_fft, dtype="float32", *, device=None):
    """The 1 + n_fft // 2 bin frequencies of an n_fft-point rfft."""
    return torch.linspace(0, sr / 2, 1 + n_fft // 2,
                          dtype=convert_dtype(dtype),
                          device=resolve_device(device))


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32", *,
                         device=None):
    """Triangular mel filterbank [n_mels, 1 + n_fft // 2]; "slaney" scales
    each filter to unit area."""
    f_max = f_max or sr / 2.0
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_frequencies(n_mels + 2, f_min, f_max, htk,
                             "float32").astype(np.float64)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return torch.as_tensor(weights.astype(dtype),
                           device=resolve_device(device))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0, name=None):
    """10 log10(max(spect, amin) / max(ref_value, amin)), floored at
    top_db below its largest value unless top_db is None."""
    log_spec = 10.0 * (torch.log10(spect.clamp_min(amin))
                       - math.log10(max(ref_value, amin)))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32", *,
               device=None):
    """The DCT-II basis [n_mels, n_mfcc]."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    basis = np.cos(math.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        basis[0] *= 1.0 / math.sqrt(2)
        basis *= math.sqrt(2.0 / n_mels)
    else:
        basis *= 2.0
    return torch.as_tensor(basis.T.astype(dtype),
                           device=resolve_device(device))


def _win_np(window, win_length, fftbins=True):
    n = win_length
    if isinstance(window, tuple):
        name, *params = window
    else:
        name, params = window, []
    sym = not fftbins
    m = n + 1 if not sym else n

    def _cosine_sum(coeffs):
        k = np.arange(m)
        w = np.zeros(m)
        for i, c in enumerate(coeffs):
            w += (-1) ** i * c * np.cos(
                2 * math.pi * i * k / (m - 1) if m > 1 else k * 0)
        return w

    if name in ("hann", "hanning"):
        w = _cosine_sum([0.5, 0.5])
    elif name == "hamming":
        w = _cosine_sum([0.54, 0.46])
    elif name in ("blackman", "taylor"):
        # the reference's "taylor" is Blackman's cosine sum
        w = _cosine_sum([0.42, 0.5, 0.08])
    elif name == "bohman":
        fac = np.abs(np.linspace(-1, 1, m))
        w = (1 - fac) * np.cos(math.pi * fac) + \
            1.0 / math.pi * np.sin(math.pi * fac)
    elif name == "bartlett":
        w = np.bartlett(m)
    elif name == "kaiser":
        w = np.kaiser(m, params[0] if params else 12.0)
    elif name == "gaussian":
        std = params[0] if params else 7.0
        k = np.arange(m) - (m - 1) / 2
        w = np.exp(-0.5 * (k / std) ** 2)
    elif name == "exponential":
        tau = params[0] if params else 1.0
        w = np.exp(-np.abs(np.arange(m) - (m - 1) / 2) / tau)
    elif name == "triang":
        k = np.arange(1, (m + 1) // 2 + 1)
        if m % 2 == 0:
            w = (2 * k - 1.0) / m
            w = np.concatenate([w, w[::-1]])
        else:
            w = 2 * k / (m + 1.0)
            w = np.concatenate([w, w[-2::-1]])
    elif name in ("boxcar", "rect", "rectangular", "ones"):
        w = np.ones(m)
    else:
        raise ValueError(f"unknown window {window!r}")
    return w[:-1] if not sym and m > n else w


def get_window(window, win_length, fftbins=True, dtype="float32", *,
               device=None):
    """A window by name (or (name, parameter)): periodic with fftbins,
    else symmetric."""
    return torch.as_tensor(_win_np(window, win_length, fftbins).astype(dtype),
                           device=resolve_device(device))
