"""Host-side block-pool allocator for paged KV caches.

The KV cache is carved into fixed-size blocks of ``block_size`` token
positions. Sequences own ordered lists of physical block ids (their *block
table*); allocation and free are O(1) free-list operations. This is the
memory-manager half of the paged subsystem — the device side (pool arrays +
the block-table flash-decode kernel) never sees the free list, only the
(B, max_blocks_per_seq) int32 tables built from it.

Physical block 0 is reserved as the *null block*: retired serving slots keep
decoding masked garbage until re-admission, and their table rows are reset to
0 so those writes land in a block no live sequence owns — stale table entries
pointing at freed (possibly re-allocated) blocks would otherwise corrupt the
new owner's cache.

Blocks are **refcounted** so prompt-prefix deduplication can map one physical
block into many sequences' tables (``allocate(shared=...)``): a block returns
to the free list only when its last owner releases it. ``append_token`` into
a block another sequence still references triggers **copy-on-write** — the
appender gets a fresh block and the caller is told to copy the device data
(the pool itself never touches device arrays).

A block whose refcount drops to zero while a prefix cache still indexes it
parks on the **cached-free** list instead of the free list: still allocatable
(evicted LRU via ``on_evict`` so the index can drop its entries) but
resurrectable by a later prefix hit at zero cost.

Exhaustion raises ``BlockPoolExhausted`` instead of handing out a live
block twice; the serve engine checks ``can_allocate`` at admission and
leaves requests queued rather than corrupting resident sequences.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Hashable, List, Mapping, Optional,
                    Sequence, Tuple)


class BlockPoolExhausted(RuntimeError):
    """No free blocks left; the caller must retire or wait, never overwrite."""


@dataclasses.dataclass
class BlockEvent:
    """What ``append_token`` did to back a write position.

    ``kind == "alloc"``: ``block`` was freshly taken on a block boundary.
    ``kind == "cow"``: the position's block was shared; the sequence now owns
    the private copy ``block`` and the caller must copy device data from
    ``src`` (the still-shared original) before writing.
    """
    kind: str  # "alloc" | "cow"
    block: int
    src: Optional[int] = None


def _blocks_for(n_tokens: int, block_size: int) -> int:
    return max(1, -(-int(n_tokens) // block_size))


class BlockPool:
    """Fixed-size-block allocator with per-sequence block tables."""

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list: freshly-freed blocks are reused first (their pool
        # pages are the ones most likely still warm in cache)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[Hashable, List[int]] = {}
        # per-block owner count; 0 = free or cached-free. The null block's
        # refcount is pinned at 1 so no path can ever free or hand it out.
        self._refs: List[int] = [0] * self.num_blocks
        self._refs[self.NULL_BLOCK] = 1
        # blocks with refcount 0 that a prefix index still maps: insertion-
        # ordered dict as an LRU (oldest entry evicted first). Values unused.
        self._cached_free: Dict[int, None] = {}
        # called with the block id when a cached-free block is evicted to
        # satisfy an allocation, so the prefix index drops its entries
        self.on_evict: Optional[Callable[[int], None]] = None
        # cache_filter(block) -> True parks a ref-0 block on the cached-free
        # list instead of the free list (a prefix index still maps it); set
        # by PagedKVCache so every release path — free() and the COW decref —
        # routes identically
        self.cache_filter: Optional[Callable[[int], bool]] = None
        self.peak_blocks_in_use = 0
        self.total_allocs = 0
        self.total_shares = 0
        self.total_cow = 0
        self.total_evictions = 0

    # -- capacity ----------------------------------------------------------

    @property
    def num_usable(self) -> int:
        """Allocatable blocks (total minus the reserved null block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks allocatable right now (free list + evictable cached)."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_cached(self) -> int:
        """Unreferenced blocks kept alive for prefix reuse (evictable)."""
        return len(self._cached_free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_usable - self.num_free

    @property
    def shared_blocks(self) -> int:
        """Physical blocks mapped by more than one sequence."""
        return sum(1 for r in self._refs[1:] if r > 1)

    def blocks_for(self, n_tokens: int) -> int:
        return _blocks_for(n_tokens, self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.num_free

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def is_cached(self, block: int) -> bool:
        return block in self._cached_free

    # -- alloc / free ------------------------------------------------------

    def _take_block(self) -> int:
        if self._free:
            blk = self._free.pop()
        elif self._cached_free:
            # evict the least-recently-cached block and let the prefix
            # index forget it before it is recycled under a new identity
            blk = next(iter(self._cached_free))
            del self._cached_free[blk]
            self.total_evictions += 1
            if self.on_evict is not None:
                self.on_evict(blk)
        else:
            raise BlockPoolExhausted(
                f"pool exhausted: {self.num_usable} blocks "
                f"({self.num_usable * self.block_size} token slots) all live")
        self.total_allocs += 1
        self._refs[blk] = 1
        in_use = self.blocks_in_use
        if in_use > self.peak_blocks_in_use:
            self.peak_blocks_in_use = in_use
        return blk

    def allocate(self, seq_id: Hashable, n_tokens: int,
                 shared: Sequence[int] = ()) -> List[int]:
        """Allocate blocks covering ``n_tokens`` positions for a new sequence.

        ``shared`` maps already-populated physical blocks (a prefix-cache
        hit) into the head of the new table: each is refcounted up — and
        resurrected off the cached-free list when unowned — instead of
        taken from the free list. Fails atomically on exhaustion.
        """
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already has a block table")
        shared = list(shared)
        need = self.blocks_for(n_tokens)
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared blocks exceed the "
                             f"{need} needed for {n_tokens} tokens")
        fresh = need - len(shared)
        # a cached-free shared block is about to be resurrected, not drawn
        # from the allocatable budget
        budget = len(self._free) + len(self._cached_free) \
            - sum(1 for b in shared if b in self._cached_free)
        if fresh > budget:
            raise BlockPoolExhausted(
                f"need {fresh} blocks for {n_tokens} tokens "
                f"({len(shared)} shared), only {budget} free")
        for blk in shared:
            self._adopt(blk)
        table = shared + [self._take_block() for _ in range(fresh)]
        self._tables[seq_id] = table
        return list(table)

    def _adopt(self, blk: int) -> None:
        """Take a reference on a prefix-hit block."""
        if blk == self.NULL_BLOCK:
            raise ValueError("cannot share the null block")
        if self._refs[blk] == 0:
            if blk not in self._cached_free:
                raise ValueError(f"block {blk} is free, not shareable")
            del self._cached_free[blk]
            in_use = self.blocks_in_use
            if in_use > self.peak_blocks_in_use:
                self.peak_blocks_in_use = in_use
        self._refs[blk] += 1
        self.total_shares += 1

    def append_token(self, seq_id: Hashable, position: int) -> Optional[BlockEvent]:
        """Make the block holding ``position`` privately writable.

        Allocates on a block boundary; a position landing in a block other
        sequences (or only the prefix cache) still reference triggers
        copy-on-write. Returns the :class:`BlockEvent` describing what
        happened, or None when the position already lands in a private
        owned block.
        """
        table = self._tables[seq_id]
        blk_idx = int(position) // self.block_size
        if blk_idx < len(table):
            blk = table[blk_idx]
            if self._refs[blk] > 1:
                # shared: divergence point — the appender pays for the copy
                new = self._take_block()
                table[blk_idx] = new
                self._release(blk)
                self.total_cow += 1
                return BlockEvent("cow", new, src=blk)
            return None
        if blk_idx != len(table):
            raise ValueError(
                f"non-contiguous append: position {position} wants block "
                f"{blk_idx}, sequence owns {len(table)}")
        blk = self._take_block()
        table.append(blk)
        return BlockEvent("alloc", blk)

    def free(self, seq_id: Hashable) -> int:
        """Release a sequence's references; returns the table length.

        A block drops to the free list only when its last reference goes —
        or to the cached-free list when ``cache_filter`` claims it.
        """
        table = self._tables.pop(seq_id)
        for blk in table:
            self._release(blk)
        return len(table)

    def _release(self, blk: int) -> None:
        if self._refs[blk] <= 0:
            raise RuntimeError(f"double free of block {blk}")
        self._refs[blk] -= 1
        if self._refs[blk] == 0:
            if self.cache_filter is not None and self.cache_filter(blk):
                self._cached_free[blk] = None
            else:
                self._free.append(blk)

    def uncache(self, blk: int) -> None:
        """Drop a cached-free block to the free list (index removed it)."""
        if blk in self._cached_free:
            del self._cached_free[blk]
            self._free.append(blk)

    # -- introspection -----------------------------------------------------

    def block_table(self, seq_id: Hashable) -> List[int]:
        return list(self._tables[seq_id])

    def owned_blocks(self, seq_id: Hashable) -> int:
        return len(self._tables.get(seq_id, ()))

    def utilization(self) -> float:
        """Fraction of usable blocks currently live."""
        return self.blocks_in_use / max(self.num_usable, 1)

    def fragmentation(self, live_tokens: Mapping[Hashable, int]) -> float:
        """Internal fragmentation: fraction of allocated token slots not
        backing a live token. ``live_tokens`` maps seq_id -> valid positions
        (the serve engine's per-slot cache_len). Refcount-aware: a block
        shared by many sequences contributes its slots once, covered by the
        deepest owner's live length."""
        bs = self.block_size
        covered: Dict[int, int] = {}  # physical block -> live slots backed
        for s, t in self._tables.items():
            live = int(live_tokens.get(s, 0))
            for i, blk in enumerate(t):
                c = max(0, min(live - i * bs, bs))
                if c > covered.get(blk, -1):
                    covered[blk] = c
        if not covered:
            return 0.0
        allocated = len(covered) * bs
        return 1.0 - sum(covered.values()) / allocated

    def stats(self, live_tokens: Optional[Mapping[Hashable, int]] = None) -> dict:
        out = {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.blocks_in_use,
            "num_free": self.num_free,
            "cached_blocks": self.num_cached,
            "shared_blocks": self.shared_blocks,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "utilization": round(self.utilization(), 4),
            "total_allocs": self.total_allocs,
            "total_shares": self.total_shares,
            "total_cow": self.total_cow,
            "total_evictions": self.total_evictions,
            "n_sequences": len(self._tables),
        }
        if live_tokens is not None:
            out["fragmentation"] = round(self.fragmentation(live_tokens), 4)
        return out

    def publish_metrics(self, metrics, stats: Optional[dict] = None,
                        **labels) -> None:
        """Export pool accounting as gauges into a ``repro_torch.obs``
        MetricsRegistry. ``stats`` may be a precomputed :meth:`stats` dict
        (e.g. one that already carries fragmentation from live tokens)."""
        st = stats if stats is not None else self.stats()
        for key in ("blocks_in_use", "num_free", "cached_blocks",
                    "shared_blocks", "peak_blocks_in_use", "utilization",
                    "fragmentation", "total_allocs", "total_shares",
                    "total_cow", "total_evictions", "n_sequences"):
            if key in st:
                metrics.gauge(f"pool_{key}").labels(**labels).set(
                    float(st[key]))

    def check_invariants(self) -> None:
        """Assert conservation: every usable block is exactly one of free,
        cached-free, or referenced; refcounts equal table occurrences plus
        (never) the null block. Test/chaos hook — O(num_blocks)."""
        owners: Dict[int, int] = {}
        for t in self._tables.values():
            for blk in t:
                owners[blk] = owners.get(blk, 0) + 1
        free_set = set(self._free)
        cached = set(self._cached_free)
        assert not (free_set & cached), "block both free and cached"
        assert self.NULL_BLOCK not in free_set | cached, "null block freed"
        assert self.NULL_BLOCK not in owners, "null block in a table"
        for blk in range(1, self.num_blocks):
            refs = self._refs[blk]
            assert refs == owners.get(blk, 0), \
                f"block {blk}: refcount {refs} != {owners.get(blk, 0)} owners"
            in_free = blk in free_set or blk in cached
            assert (refs == 0) == in_free, \
                f"block {blk}: refs={refs} but free/cached={in_free}"
        total = len(free_set) + len(cached) + len(owners)
        assert total == self.num_usable, \
            f"leaked blocks: {self.num_usable - total}"
