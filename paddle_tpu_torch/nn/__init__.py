"""The ``nn`` subset of the ported slices."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer
from .layers_common import (AdaptiveAvgPool2D, BatchNorm2D,
                            BCEWithLogitsLoss, Conv2D, Dropout, Embedding,
                            LayerList, LayerNorm, Linear, MaxPool2D, ReLU,
                            Sequential, SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "Layer", "Linear", "Embedding", "LayerNorm",
           "Dropout", "LayerList", "Sequential", "Conv2D", "BatchNorm2D",
           "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "BCEWithLogitsLoss", "SyncBatchNorm"]
