"""Models of the port."""
from .gpt import GPT, GPTConfig, PagedKVCache

__all__ = ["GPT", "GPTConfig", "PagedKVCache"]
