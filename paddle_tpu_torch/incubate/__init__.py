"""paddle.incubate. reference: paddle_tpu/incubate/__init__.py, of which
`autograd` and `nn` are ported."""

from . import autograd, nn  # noqa: F401
