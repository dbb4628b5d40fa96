"""paddle.vision. reference: paddle_tpu/vision/__init__.py: the datasets,
models, ops and transforms, and the image-backend registry
(`set_image_backend`, `get_image_backend`, `image_load`)."""

from . import datasets, models, ops, transforms
from .models import LeNet, ResNet, resnet18, resnet50

__all__ = ["datasets", "models", "ops", "transforms", "LeNet", "ResNet", "resnet18",
           "resnet50", "set_image_backend", "get_image_backend",
           "image_load"]

_BACKENDS = ("pil", "cv2", "tensor")
_image_backend = ["pil"]


def set_image_backend(backend):
    if backend not in _BACKENDS:
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend[0] = backend


def get_image_backend():
    return _image_backend[0]


def image_load(path, backend=None):
    """An image file -> HWC uint8 numpy array, read with PIL; the cv2
    backend raises (OpenCV is not a dependency of the port)."""
    b = backend or _image_backend[0]
    if b == "cv2":
        raise NotImplementedError("cv2 is not available in this build")
    import numpy as np
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img)
