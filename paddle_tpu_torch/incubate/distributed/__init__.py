"""paddle.incubate.distributed. reference:
paddle_tpu/incubate/distributed/__init__.py."""

from . import models  # noqa: F401
