from torch.nn import ReLU

from .activation import Hardsigmoid, Hardswish, ReLU6, Swish
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .extras import MaxUnPool1D, MaxUnPool2D, MaxUnPool3D
from . import loss as _loss
from .loss import *  # noqa: F401,F403
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, LPPool1D, LPPool2D, MaxPool1D,
                      MaxPool2D, MaxPool3D)

__all__ = ["Dropout", "Embedding", "LayerList", "LayerNorm", "Linear",
           "RMSNorm", "ReLU", "ReLU6", "Hardsigmoid", "Hardswish", "Swish",
           "Sequential", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "LPPool1D", "LPPool2D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D"]
__all__ += _loss.__all__
