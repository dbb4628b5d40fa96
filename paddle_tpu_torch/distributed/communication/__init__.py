"""paddle.distributed.communication. reference: paddle_tpu/distributed/
communication/__init__.py: the collectives live flat on
paddle.distributed (collective.py); this package holds `stream`."""

from . import stream  # noqa: F401

__all__ = ["stream"]
