"""Paged KV-cache subsystem: block-pool allocation + block-table caches.

``BlockPool`` is the host-side allocator (fixed-size KV blocks, refcounted
free-list alloc/free with copy-on-write and a cached-free prefix tier,
per-sequence block tables, utilization/fragmentation stats);
``PagedKVCache`` binds a pool to the per-slot block-table rows the serve
engine ships to the device each decode step, plus the ``PrefixIndex`` that
hash-conses prompt-prefix blocks so identical prefixes share physical KV;
``gather_paged_kv`` is the naive gather oracle the paged decode kernels are
tested against.
"""
from repro_torch.paging.block_pool import BlockEvent, BlockPool, BlockPoolExhausted
from repro_torch.paging.paged_cache import (PagedKVCache, PrefixIndex,
                                            gather_paged_kv)

__all__ = ["BlockEvent", "BlockPool", "BlockPoolExhausted", "PagedKVCache",
           "PrefixIndex", "gather_paged_kv"]
