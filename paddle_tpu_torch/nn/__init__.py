from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import loss as _loss
from .layer.loss import *  # noqa: F401,F403
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv1DTranspose, Conv2D,
                    Conv2DTranspose, Conv3D, Conv3DTranspose, Dropout,
                    Embedding, Hardsigmoid, Hardswish, LPPool1D, LPPool2D,
                    LayerList, LayerNorm, Linear, MaxPool1D, MaxPool2D,
                    MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, RMSNorm,
                    ReLU, ReLU6, Sequential, Swish)

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "RMSNorm", "ReLU", "ReLU6", "Hardsigmoid",
           "Hardswish", "Swish", "Sequential", "Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "LPPool1D", "LPPool2D", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D"]
__all__ += ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
            "clip_grad_norm_", "clip_grad_value_"] + _loss.__all__
