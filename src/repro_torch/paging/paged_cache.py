"""Device-facing half of the paged KV cache.

``PagedKVCache`` binds a ``BlockPool`` to the dense (max_batch,
max_blocks_per_seq) int32 block-table array the decode step ships to the
device: slot admission/append/release keep the numpy table in sync with the
pool's per-sequence tables, and retired slots' rows reset to the null block
so their masked-garbage decode writes can never land in a live block.

The pool *arrays* themselves (``(num_blocks, block_size, ...)`` per layer)
belong to the model (``model.init_paged_cache``) and are written in place by
the decode step, exactly like the contiguous slabs; this class only
manages which physical block backs which (slot, logical-block) coordinate.

Prefix sharing: a :class:`PrefixIndex` hash-conses full prompt-prefix blocks
(chained digests, so a block's key commits to everything before it) plus the
partially-filled final prompt block (keyed by its token count). Admission
looks up the longest indexed prefix and maps those physical blocks into the
new sequence's table via the pool's refcounts — identical prompt prefixes
cost their KV once. Divergence is handled by the pool's copy-on-write.

Dirty-row tracking: every mutation to a table row records the slot, so the
serve engine ships only changed rows to the device instead of re-uploading
the whole dense table every decode step.

``gather_paged_kv`` is the naive oracle: materialize a sequence's contiguous
view by indexing the pool through its table. The paged decode kernels must
match it (and hence the contiguous path) at f32.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Hashable, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.paging.block_pool import BlockEvent, BlockPool


def gather_paged_kv(pool, block_table):
    """Materialize contiguous caches from a block pool (naive oracle).

    pool: (num_blocks, block_size, ...) — one layer's K, V or latent pool.
    block_table: (B, T) int32 physical block ids per logical block.
    Returns (B, T * block_size, ...): the virtual contiguous cache each
    sequence sees; positions past its valid length read whatever the mapped
    (or null) block holds and must be masked by ``kv_len`` downstream.
    """
    table = torch.as_tensor(block_table, device=pool.device).long().clamp(
        0, pool.shape[0] - 1)
    gathered = pool[table]  # (B, T, block_size, ...)
    B, T, bs = gathered.shape[:3]
    return gathered.reshape((B, T * bs) + tuple(gathered.shape[3:]))


class PrefixIndex:
    """Hash-cons of populated prompt-prefix blocks.

    Keys are *chained* sha1 digests — block i's key hashes block i's tokens
    into the digest of blocks 0..i-1 — so equal keys imply equal full
    prefixes, never just equal block contents. The partially-filled final
    prompt block gets its own key tagged with the token count, enabling
    sharing right up to the divergence point (the pool's COW takes over on
    the first append). First insertion wins; later identical prefixes map
    onto the existing block.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._map: Dict[str, int] = {}          # key -> physical block
        self._keys: Dict[int, List[str]] = {}   # block -> keys (eviction)
        self.lookups = 0   # prompt blocks examined at admission
        self.hits = 0      # prompt blocks resolved to an indexed block

    def __len__(self) -> int:
        return len(self._map)

    def maps_block(self, blk: int) -> bool:
        return blk in self._keys

    def _chain_keys(self, tokens: np.ndarray) -> Tuple[List[str], Optional[str]]:
        """(full-block keys, partial-tail key or None) for a prompt."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        h = hashlib.sha1()
        keys = []
        n_full = len(tokens) // bs
        for i in range(n_full):
            h.update(tokens[i * bs:(i + 1) * bs].tobytes())
            keys.append(h.hexdigest())
        r = len(tokens) - n_full * bs
        partial = None
        if r:
            h.update(b"partial:%d:" % r)
            h.update(tokens[n_full * bs:].tobytes())
            partial = "p" + h.hexdigest()
        return keys, partial

    def match(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens``: (physical blocks, tokens
        covered). The partial tail only matches when every full block before
        it did — anything else would splice mismatched prefixes."""
        keys, partial = self._chain_keys(tokens)
        bs = self.block_size
        blocks: List[int] = []
        for key in keys:
            blk = self._map.get(key)
            if blk is None:
                break
            blocks.append(blk)
        covered = len(blocks) * bs
        if partial is not None and len(blocks) == len(keys):
            blk = self._map.get(partial)
            if blk is not None:
                blocks.append(blk)
                covered = len(tokens)
        self.lookups += len(keys) + (1 if partial is not None else 0)
        self.hits += len(blocks)
        return blocks, covered

    def insert(self, tokens: np.ndarray, blocks: Sequence[int]) -> int:
        """Index a freshly-prefilled prompt's blocks; returns insertions.

        ``blocks`` is the sequence's table prefix covering the prompt
        (full blocks plus the partial tail block, if any)."""
        keys, partial = self._chain_keys(tokens)
        if partial is not None:
            keys = keys + [partial]
        added = 0
        for key, blk in zip(keys, blocks):
            if key in self._map:
                continue  # an identical prefix beat us to it
            self._map[key] = blk
            self._keys.setdefault(blk, []).append(key)
            added += 1
        return added

    def forget_block(self, blk: int) -> None:
        """Drop every key mapping to ``blk`` (pool evicted/recycled it)."""
        for key in self._keys.pop(blk, ()):
            self._map.pop(key, None)

    def stats(self) -> dict:
        return {
            "entries": len(self._map),
            "blocks": len(self._keys),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.lookups, 4)
            if self.lookups else 0.0,
        }


class PagedKVCache:
    """Block pool + per-slot block-table rows for the serve engine."""

    def __init__(self, num_blocks: int, block_size: int, max_batch: int,
                 max_blocks_per_seq: int, prefix_cache: bool = False):
        self.pool = BlockPool(num_blocks, block_size)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        # rows default to the null block: idle slots' masked decode writes
        # land somewhere no live sequence reads
        self.tables = np.zeros((max_batch, max_blocks_per_seq), np.int32)
        self._slot_seq: List[Optional[Hashable]] = [None] * max_batch
        # rows touched since the engine last shipped them to the device
        self._dirty: Set[int] = set(range(max_batch))
        self.prefix: Optional[PrefixIndex] = None
        if prefix_cache:
            self.prefix = PrefixIndex(block_size)
            self.pool.cache_filter = self.prefix.maps_block
            self.pool.on_evict = self.prefix.forget_block

    # -- prefix sharing ----------------------------------------------------

    def match_prefix(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest indexed prefix: (shared physical blocks, tokens covered).
        ([], 0) when the prefix cache is off."""
        if self.prefix is None:
            return [], 0
        return self.prefix.match(tokens)

    def index_prompt(self, slot: int, tokens: np.ndarray) -> int:
        """Index the slot's populated prompt blocks for future sharing."""
        if self.prefix is None:
            return 0
        n = self.pool.blocks_for(max(len(tokens), 1))
        return self.prefix.insert(tokens, list(self.tables[slot, :n]))

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, slot: int, seq_id: Hashable, n_tokens: int,
              shared: Sequence[int] = ()) -> List[int]:
        """Allocate blocks for a prompt and install them in the slot's row.

        ``shared`` (from :meth:`match_prefix`) maps already-populated blocks
        into the head of the table via pool refcounts."""
        blocks = self.pool.allocate(seq_id, n_tokens, shared=shared)
        if len(blocks) > self.max_blocks_per_seq:
            self.pool.free(seq_id)
            raise ValueError(
                f"{n_tokens} tokens need {len(blocks)} blocks > table width "
                f"{self.max_blocks_per_seq}")
        self.tables[slot, :] = BlockPool.NULL_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        self._slot_seq[slot] = seq_id
        self._dirty.add(slot)
        return blocks

    def append(self, slot: int, position: int) -> Optional[BlockEvent]:
        """Allocate-on-boundary (or copy-on-write) for the decode write at
        ``position``. Returns the pool's :class:`BlockEvent` — the engine
        must device-copy ``event.src`` into ``event.block`` on a "cow"."""
        if position // self.block_size >= self.max_blocks_per_seq:
            raise ValueError(f"position {position} exceeds the table width "
                             f"({self.max_blocks_per_seq} blocks of "
                             f"{self.block_size})")
        seq_id = self._slot_seq[slot]
        event = self.pool.append_token(seq_id, position)
        if event is not None:
            self.tables[slot, position // self.block_size] = event.block
            self._dirty.add(slot)
        return event

    def release(self, slot: int) -> int:
        """Free the slot's blocks and reset its row to the null block.

        Indexed prompt blocks park on the pool's cached-free list (still
        allocatable, but a later identical prefix resurrects them free)."""
        seq_id = self._slot_seq[slot]
        self._slot_seq[slot] = None
        self.tables[slot, :] = BlockPool.NULL_BLOCK
        self._dirty.add(slot)
        return self.pool.free(seq_id)

    def slot_blocks(self, slot: int) -> List[int]:
        """The slot's live physical blocks, in logical order (swap-out)."""
        return self.pool.block_table(self._slot_seq[slot])

    # -- dirty-row shipping --------------------------------------------------

    def take_dirty(self) -> List[int]:
        """Rows mutated since the last call; clears the set. The engine
        updates only these rows on the device-resident table."""
        rows = sorted(self._dirty)
        self._dirty.clear()
        return rows

    def stats(self, live_tokens: Optional[Mapping[Hashable, int]] = None) -> dict:
        out = self.pool.stats(live_tokens)
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out

    def publish_metrics(self, metrics, stats: Optional[dict] = None,
                        **labels) -> None:
        """Pool gauges plus prefix-sharing hit-rate under one registry."""
        st = stats if stats is not None else self.stats()
        self.pool.publish_metrics(metrics, stats=st, **labels)
        prefix = st.get("prefix")
        if prefix:
            metrics.gauge("prefix_hit_rate").labels(**labels).set(
                float(prefix["hit_rate"]))
            metrics.gauge("prefix_entries").labels(**labels).set(
                float(prefix["entries"]))
            metrics.gauge("prefix_lookups").labels(**labels).set(
                float(prefix["lookups"]))
