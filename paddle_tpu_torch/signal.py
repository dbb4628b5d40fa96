"""Short-time Fourier transforms. reference: paddle_tpu/signal.py (frame,
overlap_add, stft, istft).

The reference's framing, centring, padding and normalisation, not
torch.stft's defaults: frames come out as [..., frame_length, frames];
`center` pads n_fft // 2 on each side in `pad_mode`; a window shorter than
n_fft is zero-padded to it in the middle; `normalized` divides by
sqrt(n_fft); istft divides the overlap-added frames by the overlap-added
squared window (floored at 1e-11), then cuts the centring pad and keeps
`length` samples. The transforms are torch.fft's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["frame", "overlap_add", "stft", "istft"]

# numpy's pad modes (the reference pads with jnp.pad) by torch's names
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _frame(a, frame_length, hop_length, axis=-1):
    if axis not in (-1, a.ndim - 1, 0):
        raise ValueError("frame: axis must be 0 or -1")
    seq_last = axis in (-1, a.ndim - 1)
    if not seq_last:
        a = a.movedim(0, -1)
    out = a.unfold(-1, frame_length, hop_length).transpose(-1, -2)
    if not seq_last:
        out = out.movedim((-2, -1), (0, 1))
    return out


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Frames of `frame_length` samples every `hop_length`: [...,
    frame_length, num_frames] for axis -1, [frame_length, num_frames, ...]
    for axis 0."""
    return _frame(x, frame_length, hop_length, axis)


def _overlap_add(a, hop_length, axis=-1):
    seq_last = axis in (-1, a.ndim - 1)
    if not seq_last:
        a = a.movedim((0, 1), (-2, -1))
    *batch, frame_length, num_frames = a.shape
    n = frame_length + hop_length * (num_frames - 1)
    idx = (torch.arange(frame_length, device=a.device)[None, :]
           + hop_length * torch.arange(num_frames, device=a.device)[:, None])
    frames = a.transpose(-1, -2).reshape(*batch, num_frames * frame_length)
    out = torch.zeros(*batch, n, dtype=a.dtype, device=a.device).index_add(
        -1, idx.reshape(-1), frames)
    if not seq_last:
        out = out.movedim(-1, 0)
    return out


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of frame's layout: frames [..., frame_length,
    num_frames] summed where they overlap."""
    return _overlap_add(x, hop_length, axis)


def _window(window, win_length, n_fft, dtype, device):
    win = torch.ones(win_length, dtype=dtype, device=device) \
        if window is None else window
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        win = TF.pad(win, (left, n_fft - win_length - left))
    return win


def _pad_last(a, pad, mode):
    """Pad the last axis by `pad` on both sides, in numpy's `mode`."""
    shape = a.shape
    flat = a.reshape(-1, 1, shape[-1])
    out = TF.pad(flat, (pad, pad), mode=_PAD_MODES[mode])
    return out.reshape(*shape[:-1], out.shape[-1])


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """[..., n_fft // 2 + 1 (n_fft if not onesided or complex), frames]
    for a signal [..., samples]."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    a = x[None] if x.ndim == 1 else x
    win = _window(window, win_length, n_fft, a.dtype, a.device)
    if center:
        a = _pad_last(a, n_fft // 2, pad_mode)
    frames = _frame(a, n_fft, hop_length) * win[:, None]
    if a.is_complex() or not onesided:
        spec = torch.fft.fft(frames, dim=-2)
    else:
        spec = torch.fft.rfft(frames, dim=-2)
    if normalized:
        spec = spec / n_fft ** 0.5
    return spec[0] if x.ndim == 1 else spec


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The signal of an stft: [..., samples] for [..., bins, frames]."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if return_complex and onesided:
        raise ValueError(
            "istft: onesided must be False when return_complex is True "
            "(a onesided spectrum reconstructs a real signal)")
    spec = x[None] if x.ndim == 2 else x
    real = spec.real.dtype if spec.is_complex() else spec.dtype
    win = _window(None if window is None else window.to(real), win_length,
                  n_fft, real, spec.device)
    if normalized:
        spec = spec * n_fft ** 0.5
    if onesided and not return_complex:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-2)
    else:
        frames = torch.fft.ifft(spec, dim=-2)
        if not return_complex:
            frames = frames.real
    frames = frames * win[:, None]
    out = _overlap_add(frames, hop_length)
    env = _overlap_add((win * win)[:, None].expand(frames.shape[-2:]),
                       hop_length)
    out = out / env.clamp_min(1e-11)
    if center:
        out = out[..., n_fft // 2: out.shape[-1] - n_fft // 2]
    if length is not None:
        out = out[..., :length]
    return out[0] if x.ndim == 2 else out
