"""Serving of the port."""
from .sampling import SamplingParams, sample_logits
from .serving import PageAllocator, Request, ServingEngine

__all__ = ["SamplingParams", "sample_logits", "PageAllocator", "Request",
           "ServingEngine"]
