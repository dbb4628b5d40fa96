"""Audio IO over the standard library's wave module. reference:
paddle_tpu/audio/backends.py (list_available_backends,
get_current_backend, set_backend, info, load, save).

A loaded waveform is a tensor on the default device unless `device`
says.
"""

from __future__ import annotations

import wave as _wave

import numpy as np
import torch

from ..framework.device import resolve_device

__all__ = ["list_available_backends", "get_current_backend", "set_backend",
           "load", "save", "info"]

_backend = ["wave_backend"]


def list_available_backends():
    return ["wave_backend"]


def get_current_backend():
    return _backend[0]


def set_backend(backend_name):
    if backend_name not in list_available_backends():
        raise NotImplementedError(f"backend {backend_name} not available")
    _backend[0] = backend_name


class AudioInfo:
    def __init__(self, sample_rate, num_samples, num_channels, bits_per_sample,
                 encoding="PCM_S"):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def info(filepath):
    with _wave.open(filepath, "rb") as f:
        return AudioInfo(f.getframerate(), f.getnframes(), f.getnchannels(),
                         f.getsampwidth() * 8)


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True, *, device=None):
    """(waveform, sample rate) of a PCM WAV file: (channels, samples) with
    channels_first, float32 in [-1, 1) when normalized, else the file's
    integers (8-bit: unsigned; 24-bit: assembled into int32)."""
    with _wave.open(filepath, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(frame_offset)
        n = f.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(n)
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        data = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16))
        data = np.where(data >= 1 << 23, data - (1 << 24),
                        data).reshape(-1, nch)
    else:
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype).reshape(-1, nch)
    if normalize:
        if width == 1:
            data = (data.astype(np.float32) - 128) / 128.0
        else:
            data = data.astype(np.float32) / float(2 ** (8 * width - 1))
    arr = data.T if channels_first else data
    return torch.as_tensor(np.ascontiguousarray(arr),
                           device=resolve_device(device)), sr


def save(filepath, src, sample_rate, channels_first=True, encoding="PCM_S",
         bits_per_sample=16):
    """Write a waveform (float in [-1, 1]) as PCM WAV of bits_per_sample."""
    data = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
        else np.asarray(src)
    if channels_first:
        data = data.T
    if bits_per_sample == 8:
        pcm = np.clip(data * 128.0 + 128.0, 0, 255).astype(np.uint8)
    else:
        scale = float(2 ** (bits_per_sample - 1))
        pcm = np.clip(data.astype(np.float64) * scale, -scale,
                      scale - 1).astype(
            {16: np.int16, 32: np.int32}[bits_per_sample])
    with _wave.open(filepath, "wb") as f:
        f.setnchannels(data.shape[1] if data.ndim == 2 else 1)
        f.setsampwidth(bits_per_sample // 8)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
