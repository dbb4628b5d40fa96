"""Tensor functions on `torch.Tensor`. reference: paddle_tpu/tensor/
(attribute, creation, logic, search and manipulation whole; of math,
the matrix products). The reference's `Tensor` methods are not ported:
the port's tensor stays torch's."""

from . import attribute, creation, logic, manipulation, math, search
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

__all__ = list(dict.fromkeys(
    attribute.__all__ + creation.__all__ + logic.__all__
    + manipulation.__all__ + math.__all__ + search.__all__))
