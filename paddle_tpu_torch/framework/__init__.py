from .device import get_device, resolve_device, set_device
from .dtypes import convert_dtype
from .flags import get_flags, set_flags
from .random import get_generator, seed

__all__ = ["get_device", "resolve_device", "set_device", "convert_dtype",
           "get_flags", "set_flags", "get_generator", "seed"]
