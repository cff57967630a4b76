"""The ``nn`` subset of the serving and training slices."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer
from .layers_common import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "Layer", "Linear", "Embedding", "LayerNorm",
           "Dropout", "LayerList", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
