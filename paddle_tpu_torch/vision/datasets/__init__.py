"""Vision datasets. A copy of paddle_tpu/vision/datasets/__init__.py
(:21-220; reference: python/paddle/vision/datasets/), on the port's
io.Dataset.

Nothing is downloaded. MNIST reads the gzip files at `image_path` and
`label_path` where they exist; otherwise every dataset is the reference's
synthetic stand-in, drawn from the same numpy RandomState seeds at the same
sizes (MNIST 2048 images, Cifar 2048/512, Flowers 1024/256/256 at 64 x 64,
VOC2012 256), so that each yields the same arrays as the reference's.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "DatasetFolder", "ImageFolder"]


class MNIST(Dataset):
    """reference: python/paddle/vision/datasets/mnist.py."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        n = 60000 if mode == "train" else 10000
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(num, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        else:
            # synthetic deterministic stand-in (no network egress): class
            # prototypes are split-independent so train→test generalizes
            proto_rng = np.random.RandomState(1234)
            base = proto_rng.rand(10, 28, 28)
            rng = np.random.RandomState(0 if mode == "train" else 1)
            n = min(n, 2048)
            self.labels = rng.randint(0, 10, n).astype(np.int64)
            noise = rng.rand(n, 28, 28) * 0.3
            self.images = ((base[self.labels] * 0.7 + noise) * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 255.0
        if self.transform is not None:
            img = self.transform(self.images[idx])
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        proto_rng = np.random.RandomState(1234)
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 2048 if mode == "train" else 512
        self.num_classes = 10
        self.labels = rng.randint(0, self.num_classes, n).astype(np.int64)
        base = proto_rng.rand(self.num_classes, 32, 32, 3)
        self.images = ((base[self.labels] * 0.7 + rng.rand(n, 32, 32, 3) * 0.3)
                       * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        super().__init__(data_file, mode, transform, download, backend)
        self.num_classes = 100
        rng = np.random.RandomState(2)
        self.labels = rng.randint(0, 100, len(self.labels)).astype(np.int64)


class Flowers(Dataset):
    """reference: python/paddle/vision/datasets/flowers.py (102 classes).
    Synthetic deterministic stand-in (zero-egress environment)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        proto_rng = np.random.RandomState(4321)
        rng = np.random.RandomState({"train": 0, "valid": 1, "test": 2}.get(mode, 0))
        n = {"train": 1024, "valid": 256, "test": 256}.get(mode, 1024)
        self.num_classes = 102
        self.labels = rng.randint(0, self.num_classes, n).astype(np.int64)
        base = proto_rng.rand(self.num_classes, 64, 64, 3)
        self.images = ((base[self.labels] * 0.7 + rng.rand(n, 64, 64, 3) * 0.3)
                       * 255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """reference: python/paddle/vision/datasets/voc2012.py (segmentation).
    Synthetic: images + integer masks with the same spatial size."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        rng = np.random.RandomState({"train": 0, "valid": 1, "test": 2}.get(mode, 0))
        n = 256
        self.images = (rng.rand(n, 64, 64, 3) * 255).astype(np.uint8)
        self.masks = rng.randint(0, 21, (n, 64, 64)).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


class DatasetFolder:
    """Generic folder-of-class-folders dataset.
    reference: vision/datasets/folder.py DatasetFolder."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        exts = tuple(e.lower() for e in (extensions or (
            ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".npy")))
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for base, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(base, fname)
                    ok = is_valid_file(path) if is_valid_file else \
                        fname.lower().endswith(exts)
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path):
        import numpy as np
        if path.endswith(".npy"):
            return np.load(path)
        from .. import image_load
        return image_load(path)

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Flat folder of images (no labels). reference: folder.py ImageFolder."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._default_loader
        exts = tuple(e.lower() for e in (extensions or (
            ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".npy")))
        self.samples = []
        for base, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(base, fname)
                ok = is_valid_file(path) if is_valid_file else \
                    fname.lower().endswith(exts)
                if ok:
                    self.samples.append(path)

    def __getitem__(self, index):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]
