"""The port's vision datasets against the JAX package's: the synthetic
stand-ins (nothing is downloaded) are array-equal, sample by sample and
as whole arrays, in every mode; a transform is applied to the same uint8
image; MNIST reads real gzip files where the path exists; the folder
datasets list and load the same samples."""

import gzip
import struct

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jd
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.vision import datasets as pd

CASES = [("MNIST", "train"), ("MNIST", "test"), ("FashionMNIST", "train"),
         ("Cifar10", "train"), ("Cifar10", "test"), ("Cifar100", "train"),
         ("Flowers", "train"), ("Flowers", "valid"), ("Flowers", "test"),
         ("VOC2012", "train"), ("VOC2012", "valid")]


@pytest.mark.parametrize("name,mode", CASES)
def test_synthetic_datasets_equal_reference(name, mode):
    ref = getattr(jd, name)(mode=mode)
    port = getattr(pd, name)(mode=mode)
    assert isinstance(port, pio.Dataset)
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port.images, ref.images)
    want = getattr(ref, "labels", getattr(ref, "masks", None))
    got = getattr(port, "labels", getattr(port, "masks", None))
    np.testing.assert_array_equal(got, want)
    for i in (0, 1, len(ref) - 1):
        for a, b in zip(port[i], ref[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sizes_are_the_references():
    assert len(pd.MNIST(mode="train")) == 2048
    assert [len(pd.Flowers(mode=m)) for m in ("train", "valid", "test")] \
        == [1024, 256, 256]
    assert pd.Flowers(mode="train").images.shape[1:] == (64, 64, 3)


def test_transform_is_applied_to_the_uint8_image():
    def t(img):
        return img.astype(np.float32).mean(-1)
    for name in ("Cifar10", "Flowers"):
        a = getattr(pd, name)(mode="train", transform=t)[5][0]
        b = getattr(jd, name)(mode="train", transform=t)[5][0]
        np.testing.assert_array_equal(a, b)
    a = pd.MNIST(mode="test", transform=lambda im: im * 2)[3][0]
    b = jd.MNIST(mode="test", transform=lambda im: im * 2)[3][0]
    np.testing.assert_array_equal(a, b)


def test_mnist_reads_real_files(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = np.array([3, 1, 4, 1, 5], np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    port = pd.MNIST(image_path=str(ip), label_path=str(lp))
    ref = jd.MNIST(image_path=str(ip), label_path=str(lp))
    np.testing.assert_array_equal(port.images, imgs)
    np.testing.assert_array_equal(port[2][0], ref[2][0])
    assert port[4][1] == ref[4][1] == 5


def test_folder_datasets_match_reference(tmp_path):
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(2):
            np.save(tmp_path / c / f"{i}.npy", np.full((2, 2), i))
    (tmp_path / "dog" / "skip.txt").write_text("x")
    ref, port = jd.DatasetFolder(str(tmp_path)), \
        pd.DatasetFolder(str(tmp_path))
    assert port.classes == ref.classes == ["cat", "dog"]
    assert port.samples == ref.samples and len(port) == 4
    np.testing.assert_array_equal(port[3][0], ref[3][0])
    assert port[3][1] == 1
    flat_ref, flat = jd.ImageFolder(str(tmp_path)), \
        pd.ImageFolder(str(tmp_path))
    assert flat.samples == flat_ref.samples
    np.testing.assert_array_equal(flat[0][0], flat_ref[0][0])
