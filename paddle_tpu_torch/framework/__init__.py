from .device import get_device, resolve_device, set_device
from .dtypes import convert_dtype
from .flags import get_flags, set_flags
from .io_file import load, save
from .param_attr import L1Decay, L2Decay, ParamAttr
from .random import get_generator, seed

__all__ = ["get_device", "resolve_device", "set_device", "convert_dtype",
           "get_flags", "set_flags", "get_generator", "seed", "save", "load",
           "ParamAttr", "L1Decay", "L2Decay"]
