"""The ``nn`` subset of the ported slices."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer
from .layers_common import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                            Embedding, LayerList, LayerNorm, Linear,
                            MaxPool2D, ReLU, Sequential)

__all__ = ["functional", "Layer", "Linear", "Embedding", "LayerNorm",
           "Dropout", "LayerList", "Sequential", "Conv2D", "BatchNorm2D",
           "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
