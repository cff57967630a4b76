"""Serving of the port."""
from .governor import MemoryGovernor
from .sampling import SamplingParams, sample_logits
from .serving import EngineSuspended, PageAllocator, Request, ServingEngine

__all__ = ["SamplingParams", "sample_logits", "EngineSuspended",
           "MemoryGovernor", "PageAllocator", "Request", "ServingEngine"]
