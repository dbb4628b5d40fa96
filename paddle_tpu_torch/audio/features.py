"""Audio feature layers. reference: paddle_tpu/audio/features.py
(Spectrogram, MelSpectrogram, LogMelSpectrogram, MFCC).

The window, the mel filterbank and the DCT basis are buffers of the layer
that are not saved (the reference's state_dict holds none of them), built
on the layer's device (the default one unless `device` says).
"""

from __future__ import annotations

import torch

from .. import signal as _signal
from ..framework.device import resolve_device
from ..nn.layer.layers import Layer
from . import functional as F

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    """|stft(x)| ** power: [..., n_fft // 2 + 1, frames]."""

    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32", *, device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("window", F.get_window(
            window, self.win_length, dtype=dtype,
            device=resolve_device(device)), persistent=False)

    def forward(self, x):
        spec = _signal.stft(x, self.n_fft, self.hop_length, self.win_length,
                            window=self.window, center=self.center,
                            pad_mode=self.pad_mode)
        return spec.abs() ** self.power


class MelSpectrogram(Layer):
    """The spectrogram through a mel filterbank: [..., n_mels, frames]."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 dtype="float32", *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                       power, center, pad_mode, dtype,
                                       device=device)
        self.register_buffer("fbank", F.compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype,
            device=device), persistent=False)

    def forward(self, x):
        return torch.einsum("mf,...ft->...mt", self.fbank,
                            self.spectrogram(x))


class LogMelSpectrogram(Layer):
    """power_to_db of the mel spectrogram."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 ref_value=1.0, amin=1e-10, top_db=None, dtype="float32", *,
                 device=None):
        super().__init__()
        self.mel = MelSpectrogram(sr, n_fft, hop_length, win_length, window,
                                  power, center, pad_mode, n_mels, f_min,
                                  f_max, htk, norm, dtype, device=device)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return F.power_to_db(self.mel(x), self.ref_value, self.amin,
                             self.top_db)


class MFCC(Layer):
    """The log-mel spectrogram through a DCT-II: [..., n_mfcc, frames]."""

    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32", *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.logmel = LogMelSpectrogram(sr, n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        n_mels, f_min, f_max, htk, norm,
                                        ref_value, amin, top_db, dtype,
                                        device=device)
        self.register_buffer("dct", F.create_dct(n_mfcc, n_mels, dtype=dtype,
                                                 device=device),
                             persistent=False)

    def forward(self, x):
        return torch.einsum("mk,...mt->...kt", self.dct, self.logmel(x))
