from . import functional, initializer, utils
from . import layer as _layer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import *  # noqa: F401,F403

__all__ = ["functional", "initializer", "utils", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_",
           "clip_grad_value_", "BeamSearchDecoder",
           "dynamic_decode"] + _layer.__all__
