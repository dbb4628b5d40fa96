"""The port's vision.transforms against the JAX package's: `resize`
against jax.image.resize (through the reference) on down- and upsampling
in every method, uint8 and float images, an int size, and a 2-D image;
every functional transform; and every transform class, the random ones
from the same numpy seed on both sides. Host numpy on both sides: the
same arrays exactly, except resize's float32 weight products (summed in
another order than XLA's einsum) within F32_TOL of the largest |value|
and to_tensor / erase, which hand back torch tensors."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.vision import transforms as PT


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with a worker's default threads under xdist,
    every worker's CPU kernels contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F32_TOL = 1e-4


def _img(h=12, w=16, c=3, seed=0, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (h, w, c) if c else (h, w)).astype(
            np.uint8)
    return rs.rand(*((h, w, c) if c else (h, w))).astype(dtype)


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return np.asarray(x)


def _same(got, want):
    got, want = _arr(got), _arr(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- resize against jax.image.resize --------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3",
                                    "lanczos5", "linear", "nearest"])
@pytest.mark.parametrize("size", [(5, 7), (30, 41), (12, 9), 6, 20],
                         ids=["down", "up", "mixed", "int_down", "int_up"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_matches_jax_image_resize(method, size, dtype):
    """Downsampling antialiases (the kernel widened by the factor, weights
    renormalised at the edges); nearest keeps the dtype, the others give
    float32."""
    img = _img(12, 16, dtype=dtype)
    want = JT.resize(img, size, method)
    got = PT.resize(img, size, method)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale)


@pytest.mark.parametrize("size", [(4, 5), (25, 33)])
def test_resize_2d_image_and_tensor_input(size):
    img = _img(10, 13, c=0, dtype=np.float32)
    want = JT.resize(img, size)
    np.testing.assert_allclose(PT.resize(torch.tensor(img), size), want,
                               rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(PT.Resize(size)(img), want, rtol=0,
                               atol=F32_TOL)


def test_resize_rejects_an_unknown_method():
    with pytest.raises(ValueError):
        PT.resize(_img(), (4, 4), "area")


# -- functional transforms -------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("hflip", ()), ("vflip", ()), ("crop", (1, 2, 5, 7)),
    ("center_crop", (5,)), ("center_crop", ((6, 9),)),
    ("pad", (2,)), ("pad", ((1, 2),)), ("pad", ((1, 2, 3, 4), 7)),
    ("pad", ((1, 2, 3, 4), 0, "edge")), ("pad", (2, 0, "reflect")),
    ("pad", (3, 0, "symmetric")),
    ("adjust_brightness", (1.7,)), ("adjust_contrast", (0.4,)),
    ("adjust_saturation", (1.8,)), ("adjust_hue", (0.21,)),
    ("adjust_hue", (-0.4,)), ("to_grayscale", ()), ("to_grayscale", (3,)),
    ("rotate", (30,)), ("rotate", (-75, "nearest", False, (4, 3), 9)),
    ("affine", (20, (2, -1), 1.2, 10)),
    ("affine", (-10, (0, 3), 0.8, (5, -7), "nearest", 3, (6, 5))),
    ("perspective", ([(0, 0), (15, 0), (15, 11), (0, 11)],
                     [(2, 1), (14, 0), (13, 10), (1, 11)])),
], ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_functional_transform_matches_reference(case, dtype):
    name, args = case
    img = _img(12, 16, dtype=dtype)
    _same(getattr(PT, name)(img, *args), getattr(JT, name)(img, *args))


def test_crop_and_center_crop_on_chw():
    img = _img(3, 12, 16).reshape(3, 12, 16)
    _same(PT.crop(img, 1, 2, 5, 7), JT.crop(img, 1, 2, 5, 7))
    _same(PT.center_crop(img, 6), JT.center_crop(img, 6))


def test_to_tensor_and_normalize_match_reference():
    img = _img()
    got = PT.to_tensor(img)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _same(got, JT.to_tensor(img))
    _same(PT.to_tensor(img, "HWC"), JT.to_tensor(img, "HWC"))
    _same(PT.to_tensor(img[..., 0]), JT.to_tensor(img[..., 0]))
    chw = _img(dtype=np.float32).transpose(2, 0, 1)
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]
    _same(PT.normalize(chw, mean, std), JT.normalize(chw, mean, std))
    out = PT.normalize(torch.tensor(chw), mean, std)
    assert isinstance(out, torch.Tensor)
    _same(out, JT.normalize(paddle.Tensor(chw), mean, std))
    hwc = chw.transpose(1, 2, 0)
    _same(PT.normalize(hwc, mean, std, "HWC"),
          JT.normalize(hwc, mean, std, "HWC"))


@pytest.mark.parametrize("inplace", [False, True])
def test_erase_matches_reference(inplace):
    chw = _img(dtype=np.float32).transpose(2, 0, 1).copy()
    v = np.zeros((3, 3, 2), np.float32)
    want = JT.erase(paddle.Tensor(chw.copy()), 1, 2, 3, 2,
                    paddle.Tensor(v))
    t = torch.tensor(chw)
    got = PT.erase(t, 1, 2, 3, 2, torch.tensor(v), inplace=inplace)
    assert isinstance(got, torch.Tensor)
    _same(got, want)
    assert (got is t) == inplace
    hwc = _img()
    _same(PT.erase(hwc, 2, 3, 4, 5, 0), JT.erase(hwc, 2, 3, 4, 5, 0))


# -- transform classes --------------------------------------------------------

CLASSES = [
    ("Compose", lambda M: M.Compose([M.Resize((6, 8)), M.ToTensor()])),
    ("ToTensor", lambda M: M.ToTensor()),
    ("Normalize", lambda M: M.Normalize(127.5, 60.0, "HWC")),
    ("Resize", lambda M: M.Resize((7, 9), "bicubic")),
    ("RandomHorizontalFlip", lambda M: M.RandomHorizontalFlip(0.5)),
    ("RandomVerticalFlip", lambda M: M.RandomVerticalFlip(0.5)),
    ("RandomCrop", lambda M: M.RandomCrop(8, padding=2)),
    ("CenterCrop", lambda M: M.CenterCrop((6, 10))),
    ("RandomResizedCrop", lambda M: M.RandomResizedCrop(8)),
    ("Transpose", lambda M: M.Transpose()),
    ("Pad", lambda M: M.Pad((1, 2, 3, 4), fill=5)),
    ("ColorJitter", lambda M: M.ColorJitter(0.4, 0.4, 0.4, 0.1)),
    ("BrightnessTransform", lambda M: M.BrightnessTransform(0.5)),
    ("ContrastTransform", lambda M: M.ContrastTransform(0.5)),
    ("SaturationTransform", lambda M: M.SaturationTransform(0.5)),
    ("HueTransform", lambda M: M.HueTransform(0.3)),
    ("Grayscale", lambda M: M.Grayscale(3)),
    ("RandomRotation", lambda M: M.RandomRotation(45, center=(5, 4),
                                                  fill=1)),
    ("RandomAffine", lambda M: M.RandomAffine(20, (0.1, 0.2), (0.8, 1.2),
                                              (-5, 5, -3, 3))),
    ("RandomPerspective", lambda M: M.RandomPerspective(1.0, 0.4)),
    ("RandomErasing", lambda M: M.RandomErasing(1.0, value=7)),
]


@pytest.mark.parametrize("name,build", CLASSES, ids=[n for n, _ in CLASSES])
def test_transform_class_matches_reference(name, build):
    """Three calls from the same numpy seed on both sides: the same draws,
    the same images."""
    port, ref = build(PT), build(JT)
    assert isinstance(port, PT.Compose if name == "Compose"
                      else PT.BaseTransform)
    for seed in range(3):
        img = _img(12, 16, seed=seed)
        np.random.seed(seed)
        want = ref(img)
        np.random.seed(seed)
        got = port(img)
        got, want = _arr(got), _arr(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0,
                                   atol=F32_TOL * max(np.abs(want).max(), 1))
