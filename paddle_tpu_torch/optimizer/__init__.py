"""The optimizers of the training slice (counterpart of
``paddle_tpu.optimizer``) and the learning-rate schedulers."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
