"""The ``nn`` subset of the serving slice."""
from . import functional
from .layer import Layer
from .layers_common import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "Layer", "Linear", "Embedding", "LayerNorm",
           "Dropout", "LayerList"]
