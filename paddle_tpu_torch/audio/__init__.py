"""paddle.audio. reference: paddle_tpu/audio/__init__.py (functional,
features, datasets, backends, and its own `info`/`load`/`save` over the
standard library's wave module)."""

from __future__ import annotations

import wave as _wave

import numpy as np
import torch

from ..framework.device import resolve_device
from . import backends, datasets, features, functional  # noqa: F401

__all__ = ["functional", "features", "datasets", "backends"]


def _wav_params(path):
    with _wave.open(path, "rb") as w:
        return w.getframerate(), w.getnframes(), w.getnchannels(), \
            w.getsampwidth()


class AudioInfo:
    def __init__(self, sample_rate, num_frames, num_channels,
                 bits_per_sample, encoding="PCM_S"):
        self.sample_rate = sample_rate
        self.num_frames = num_frames
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def info(filepath):
    sr, nf, nc, sw = _wav_params(filepath)
    return AudioInfo(sr, nf, nc, sw * 8)


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True, *, device=None):
    """(waveform, sample rate) of a PCM WAV file; 8-bit samples are
    unsigned, centred at 128."""
    with _wave.open(filepath, "rb") as w:
        sr = w.getframerate()
        nc = w.getnchannels()
        sw = w.getsampwidth()
        w.setpos(frame_offset)
        n = w.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = w.readframes(n)
    if sw == 1:
        data = np.frombuffer(raw, np.uint8).reshape(-1, nc)
        data = data.astype(np.int16) - 128
    else:
        data = np.frombuffer(raw, {2: np.int16, 4: np.int32}[sw]).reshape(
            -1, nc)
    if normalize:
        data = data.astype(np.float32) / float(2 ** (8 * sw - 1))
    arr = data.T if channels_first else data
    return torch.as_tensor(np.ascontiguousarray(arr),
                           device=resolve_device(device)), sr


def save(filepath, src, sample_rate, channels_first=True,
         bits_per_sample=16):
    """Write a waveform as PCM WAV; floats are clipped to [-1, 1] and
    scaled to the sample width."""
    data = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
        else np.asarray(src)
    if channels_first:
        data = data.T
    if data.dtype.kind == "f":
        data = np.clip(data, -1.0, 1.0) * float(2 ** (bits_per_sample - 1)
                                                  - 1)
    if bits_per_sample == 8:
        data = (data + 128).clip(0, 255).astype(np.uint8)
    else:
        data = data.astype({16: np.int16, 32: np.int32}[bits_per_sample])
    with _wave.open(filepath, "wb") as w:
        w.setnchannels(data.shape[1] if data.ndim == 2 else 1)
        w.setsampwidth(bits_per_sample // 8)
        w.setframerate(sample_rate)
        w.writeframes(data.tobytes())
