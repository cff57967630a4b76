"""Models of the port."""
from .gpt import GPT, GPTConfig, PagedKVCache
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["GPT", "GPTConfig", "PagedKVCache", "ResNet", "BasicBlock",
           "BottleneckBlock", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
