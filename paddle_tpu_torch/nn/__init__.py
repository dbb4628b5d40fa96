from . import functional, initializer
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D,
                    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, Conv1D,
                    Conv2D, Conv3D, Dropout, Embedding, LayerList, LayerNorm,
                    Linear, MaxPool1D, MaxPool2D, MaxPool3D, ReLU, RMSNorm,
                    Sequential)

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "RMSNorm", "ReLU", "Sequential", "Conv1D",
           "Conv2D", "Conv3D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool2D"]
