"""reference: paddle_tpu/incubate/distributed/models/__init__.py."""

from . import moe  # noqa: F401
