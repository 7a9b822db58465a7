"""KV-cache layer: byte accounting and the paged/blocked cache behind
continuous-batching serving — the counterpart of ``repro.serve.kvcache``.

:class:`PagedKVCache` keeps one dense backing buffer of ``max_batch`` slots,
and every *view* the model attends against is cut at **page granularity**:
``page_size`` — a layout axis of the tuned ``decode_attention`` space —
fixes the seq-bucket ladder, so a request that is ``pos`` tokens deep
attends against ``ceil((pos+1)/page)*page`` keys, not ``max_len``.

Requests occupy slots: :meth:`admit` copies a prefilled cache into a free
slot, decode rounds run on :meth:`view`/:meth:`writeback` batched views of
whichever slots are live, and :meth:`release` frees the slot. In PyTorch a
view over a set of slots is advanced indexing, which copies: :meth:`view`
gathers the slots' first ``bucket`` positions into a new cache, the decode
step updates that copy in place, and :meth:`writeback` scatters it back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import init_cache

__all__ = [
    "init_cache", "cache_bytes_per_token", "cache_bytes", "PagedKVCache",
]


def cache_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    if cfg.family == "ssm":
        return 0  # state is O(1) in sequence length
    if cfg.attn_type == "mla":
        per = cfg.kv_lora_rank + cfg.qk_rope_dim
        n = cfg.n_layers
    elif cfg.family == "hybrid":
        sites = int(np.ceil(cfg.n_layers / cfg.attn_every)) if cfg.attn_every else 0
        per = 2 * cfg.n_kv_heads * cfg.hd
        n = sites
    else:
        per = 2 * cfg.n_kv_heads * cfg.hd
        n = cfg.n_layers
    return int(per * n * dtype_bytes)


def cache_bytes(cfg: ArchConfig, batch: int, seq: int, dtype_bytes: int = 2,
                page_size: int | None = None) -> int:
    """Cache footprint for ``batch`` sequences of ``seq`` tokens. With
    ``page_size`` the per-sequence length is rounded up to page granularity
    — the paged layout's allocation unit (pages are whole or nothing)."""
    if page_size:
        seq = -(-seq // page_size) * page_size
    return cache_bytes_per_token(cfg, dtype_bytes) * batch * seq


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree: dict, other: dict):
    """(leaf of ``tree``, the leaf of ``other`` under the same keys) pairs:
    stacked layers are (L, B, S, K, hd), an unstacked site such as a MoE
    arch's leading dense layer (B, S, K, hd)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, other[k])
        else:
            yield v, other[k]


class PagedKVCache:
    """Slot-managed, page-bucketed KV cache for GQA serving (the dense
    family and GQA MoE archs such as mixtral).

    MLA keeps its latent cache and is refused, as in the JAX package. A
    uniform sliding window is admitted only while the cache is shorter than
    the window (``alloc <= sliding_window``): it is then never a ring and
    the window never masks a key. The JAX package refuses every windowed
    arch; past its window a windowed arch allocates an O(window) ring cache,
    and a local:global schedule (gemma3) is refused here as there."""

    def __init__(self, cfg: ArchConfig, max_batch: int, max_len: int, *,
                 page_size: int = 128, dtype=None, device=None):
        if cfg.attn_type == "mla" or cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError(f"paged KV cache requires a GQA family, got "
                             f"{cfg.family}/{cfg.attn_type}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        alloc = _cdiv(max_len, page_size) * page_size
        if cfg.local_global_ratio or (cfg.sliding_window and alloc > cfg.sliding_window):
            raise ValueError("paged KV cache does not support windowed archs past their "
                             "window (their ring cache is already O(window))")
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.alloc = alloc
        self.dtype = dtype or cfg.dtype
        self.buf = init_cache(cfg, self.max_batch, self.alloc, self.dtype, device)
        self.device = self.buf["layers"]["k"].device
        # host-side slot table: last written position per slot, -1 = free
        self.pos = np.full(self.max_batch, -1, np.int64)

    # -- slot management ---------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if self.pos[i] < 0]

    def active_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if self.pos[i] >= 0]

    def admit(self, slot: int, prefilled: dict, prompt_len: int) -> None:
        """Copy a prefilled single-request cache (``init_cache(cfg, 1, n)``,
        ``n <= alloc``) into ``slot``. Stale data beyond the prompt is
        harmless: decode masks by position and overwrites slot-by-slot."""
        if self.pos[slot] >= 0:
            raise ValueError(f"slot {slot} is occupied")
        for buf, new in _leaves(self.buf, prefilled):
            if buf.ndim == 5:                        # (L, 1, n, K, hd)
                buf[:, slot, :new.shape[2]] = new[:, 0].to(buf.dtype)
            else:                                    # (1, n, K, hd): dense0
                buf[slot, :new.shape[1]] = new[0].to(buf.dtype)
        self.pos[slot] = prompt_len - 1

    def release(self, slot: int) -> None:
        self.pos[slot] = -1

    # -- bucketed batch views ----------------------------------------------------

    def seq_bucket(self, slots, extra: int = 1) -> int:
        """The page-aligned view length covering every slot's position plus
        ``extra`` upcoming tokens — the S the dispatch signature sees."""
        if len(slots) == 0:
            return self.page_size
        need = int(max(self.pos[s] for s in slots)) + 1 + extra
        return min(_cdiv(need, self.page_size) * self.page_size, self.alloc)

    def view(self, slots, bucket: int) -> dict:
        """Batched cache over ``slots``, cut at ``bucket`` positions — what a
        decode round's serve step consumes. A gather: a copy of the slots'
        first ``bucket`` positions."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        return _map(lambda a: a[:, idx, :bucket] if a.ndim == 5 else a[idx, :bucket],
                    self.buf)

    def writeback(self, slots, bucket: int, cache: dict) -> None:
        """Scatter a round's updated view back into the backing buffer."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        for buf, c in _leaves(self.buf, cache):
            if buf.ndim == 5:
                buf[:, idx, :bucket] = c.to(buf.dtype)
            else:
                buf[idx, :bucket] = c.to(buf.dtype)

    def pos_vector(self, slots) -> torch.Tensor:
        """(len(slots),) int32 per-sequence decode positions, on the cache's
        device."""
        return torch.as_tensor([int(self.pos[s]) for s in slots], dtype=torch.int32,
                               device=self.device)

    def advance(self, slots) -> None:
        """Record one decoded token per slot (host-side position bump)."""
        for s in slots:
            self.pos[s] += 1

    # -- accounting --------------------------------------------------------------

    def stats(self) -> dict:
        """Paged accounting: pages allocated vs tokens resident. Allocation
        is page-granular per active sequence; ``bytes_backing`` is the dense
        backing buffer's full footprint."""
        active = self.active_slots()
        tokens = int(sum(int(self.pos[s]) + 1 for s in active))
        pages = int(sum(_cdiv(int(self.pos[s]) + 1, self.page_size)
                        for s in active))
        per_tok = cache_bytes_per_token(self.cfg, self.buf["layers"]["k"].element_size())
        cap = pages * self.page_size
        return {
            "page_size": self.page_size,
            "slots_active": len(active),
            "slots_total": self.max_batch,
            "tokens_resident": tokens,
            "pages_allocated": pages,
            "bytes_resident": tokens * per_tok,
            "bytes_allocated": cap * per_tok,
            "bytes_backing": self.max_batch * self.alloc * per_tok,
            "page_occupancy": (tokens / cap) if cap else 0.0,
        }
