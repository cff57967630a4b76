"""Models of the port."""
from .deepfm import DeepFM
from .wide_deep import WideDeep, load_dense_params
from .bert import Bert, BertConfig, BertForPretraining
from .ernie import Ernie, ErnieConfig, ErnieForPretraining, ernie_mask_tokens
from .gpt import GPT, GPTConfig, PagedKVCache
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["GPT", "GPTConfig", "PagedKVCache", "ResNet", "BasicBlock",
           "BottleneckBlock", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "Bert", "BertConfig", "BertForPretraining", "Ernie",
           "ErnieConfig", "ErnieForPretraining", "ernie_mask_tokens",
           "WideDeep", "DeepFM", "load_dense_params"]
