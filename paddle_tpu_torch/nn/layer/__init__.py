from torch.nn import ReLU

from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool2D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Dropout", "Embedding", "LayerList", "LayerNorm", "Linear",
           "RMSNorm", "ReLU", "Sequential", "Conv1D", "Conv2D", "Conv3D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool2D"]
