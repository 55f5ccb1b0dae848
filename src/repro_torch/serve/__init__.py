"""Paged serving: allocator, scheduler, sampling, engine."""

from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.kv_cache import PagedKVCache

__all__ = ["PagedKVCache", "Request", "ServingEngine"]
