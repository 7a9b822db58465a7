"""repro_torch.serve — KV cache (dense + paged) + prefill/decode serving
steps (the counterpart of ``repro.serve``)."""

from repro_torch.serve.kvcache import (
    PagedKVCache,
    cache_bytes,
    cache_bytes_per_token,
    init_cache,
)
from repro_torch.serve.step import greedy_decode, make_serve_step, prefill

__all__ = ["PagedKVCache", "cache_bytes", "cache_bytes_per_token",
           "init_cache", "greedy_decode", "make_serve_step", "prefill"]
