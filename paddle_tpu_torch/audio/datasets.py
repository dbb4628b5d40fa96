"""Audio datasets. reference: paddle_tpu/audio/datasets.py: TESS and
ESC50 as synthetic, deterministic stand-ins (a class's tone and its
harmonic plus noise, from numpy seeds), as the reference's are; no
download.
"""

from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ["TESS", "ESC50"]


class _SyntheticAudioDataset(Dataset):
    def __init__(self, num_classes, n, sr, duration_s, mode, feat_type="raw",
                 seed=0, **feat_kwargs):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        self.sample_rate = sr
        self.labels = rng.randint(0, num_classes, n).astype(np.int64)
        t = np.arange(int(sr * duration_s)) / sr
        self.waves = np.stack([
            (np.sin(2 * np.pi * (110 * (c + 1)) * t)
             + 0.5 * np.sin(2 * np.pi * (220 * (c + 1)) * t)
             + 0.1 * rng.randn(len(t))).astype(np.float32)
            for c in self.labels])
        self.feat_type = feat_type
        self._feat_layer = None
        if feat_type != "raw":
            from . import features as _feat
            name = {"spectrogram": "Spectrogram",
                    "melspectrogram": "MelSpectrogram",
                    "logmelspectrogram": "LogMelSpectrogram",
                    "mfcc": "MFCC"}[feat_type]
            # features are computed on the host, as the samples are read
            self._feat_layer = getattr(_feat, name)(
                sr=sr, device="cpu", **feat_kwargs)

    def _features(self, wave):
        if self._feat_layer is None:
            return wave
        import torch
        return self._feat_layer(torch.as_tensor(wave[None]))[0].numpy()

    def __getitem__(self, idx):
        return self._features(self.waves[idx]), self.labels[idx]

    def __len__(self):
        return len(self.labels)


class TESS(_SyntheticAudioDataset):
    """Toronto emotional speech set's shape: 7 emotions."""

    def __init__(self, mode="train", n_folds=1, split=1, feat_type="raw",
                 archive=None, **kwargs):
        super().__init__(num_classes=7, n=128, sr=24414, duration_s=0.5,
                         mode=mode, feat_type=feat_type, seed=10, **kwargs)


class ESC50(_SyntheticAudioDataset):
    """ESC-50's shape: 50 environmental sound classes."""

    def __init__(self, mode="train", split=1, feat_type="raw", archive=None,
                 **kwargs):
        super().__init__(num_classes=50, n=128, sr=44100, duration_s=0.25,
                         mode=mode, feat_type=feat_type, seed=20, **kwargs)
