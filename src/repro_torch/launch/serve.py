"""Serving loop: continuous batching over a slotted KV cache.

The engine serves a *stream* of requests rather than one lockstep batch:
each of ``max_batch`` cache slots carries its own ``cache_len``, finished
sequences (EOS, length budget or cache capacity) retire immediately, and
queued requests are admitted into freed slots mid-stream.

Mechanics per decode step:
  - one batched decode over all slots with a per-slot (B,) cache_len
    vector; the cache is written in place (the JAX package donates it);
  - admission runs single-request prefill and copies the (L, 1, P, ...)
    prefill cache into the slot in place;
  - idle slots decode garbage that is masked out on the host — their frozen
    cache_len keeps the math well-defined, the decode scatter skips a slot
    whose position is past the cache, and the flash-decode kernels clamp
    their lengths to the cache.

KV layouts (``--kv-layout``):
  - ``contig`` reserves a (max_batch, max_seq) slab per layer;
  - ``paged`` stores KV in fixed-size blocks from a shared pool
    (``repro_torch.paging``): admission allocates just the blocks the prompt
    needs and ingests the prompt with *chunked paged prefill* — block-sized
    chunks written straight into pool blocks — decode allocates on block
    boundaries, and retirement returns blocks to the pool. The decode step
    routes each sequence through its (B, T) block table; only table rows
    that changed since the last step are re-shipped to the device.

Prefix sharing (paged; on by default, ``--no-prefix-cache`` disables):
admission hash-conses prompt-prefix blocks — a request whose prompt prefix
was already prefilled maps the *same physical blocks* via pool refcounts
and skips the prefill compute for every hit chunk (a full-prompt hit runs
one read-only chunk just to recompute the last token's logits). Divergence
is copy-on-write: the first decode append into a shared block allocates a
private copy and copies the donor block on the device.

Host swap tier (``--admission-policy swap``): under pool pressure, cold
resident sequences' blocks are copied to host memory and freed instead of
serializing admission (LRU by last swap-in/admit step, with a grace period
as second chance); swapped sequences restore — bitwise — into fresh blocks
when headroom returns, with priority over new admissions. ``shed`` rejects
the head-of-line request with a retry-after hint instead.

Sampling: greedy by default; ``--temperature/--top-k`` switch the emitted
stream to seeded sampling with a per-request PRNG key,
``fold_in(fold_in(PRNGKey(sample_seed), uid), index)`` — JAX's threefry
streams, reproduced bit for bit by ``repro_torch.prng`` — so a request's
stream is independent of how it was batched and is the JAX engine's token
for token. Keys are derived on the host and copied in with the step's other
inputs; the draw runs inside the decode step (inside its CUDA graph on the
card), so no (B, V) logits reach the host.

Speculative decoding (``--draft-depth k``, ``--draft-source``): a draft
source (``repro_torch.spec.draft``) proposes k cheap tokens per request,
one multi-token verify pass scores the whole window, and the engine emits
the accepted prefix plus one non-draft token per round. Greedy verification
makes it token-identical to non-speculative decoding; sampled mode is
distribution-faithful rejection sampling (``spec.verify.rejection_verify``,
on the card) on the same fold_in(seed, uid, index) streams. Rollback is
pure cache_len bookkeeping — rejected positions keep stale KV, masked dead
by the ragged-length kernels and overwritten next round.

``--attn-impl pallas`` routes prefill attention through the flash forward
kernel (contig) and decode attention through the flash-decode kernels
(``flash_decode``, ``flash_decode_paged``, ``flash_decode_spec``,
``flash_decode_spec_paged``; their plain versions on the CPU); paged
prefill attention is plain torch, as in the reference. ``auto`` consults
``kernels/backend.auto_decode_impl``.

Families (``ENGINE_FAMILIES``, the reference's): the dense decoders and the
moe family (deepseek-moe-16b, deepseek-v3-671b). Under MLA (deepseek-v3)
decode runs the latent-space kernels (``flash_decode_mla``,
``flash_decode_mla_paged``), prefill warns once and takes the chunked path
(the flash forward takes one head dim), and there is no verify step, so a
draft depth decodes one token a step. A moe layer's capacity counts every
token of a call, idle and retired slots' and bucketed prefill's padding
included, as in the reference: streams match the JAX engine's under the
same schedule.

Graceful degradation and the serving rungs (``engine.jobs.ServeJob``
migrates these live): a queued request past its ``deadline_steps`` is
rejected with ``"timeout"``; ``drain()`` refuses new work (``"draining"``)
and lets residents finish; ``hold_blocks()`` lets a co-tenant take pool
blocks residents have not reserved; ``set_slot_cap``, ``set_kv_dtype``,
``set_attn_impl`` and ``set_draft_depth`` are the rung knobs. A bf16 cache
under f32 weights (``set_kv_dtype("bfloat16")``, the bottom serving rung)
runs the decode kernels' mixed-dtype instantiations: f32 queries over a
bf16 cache, computed in f32.

Telemetry (``repro_torch.obs``; ``--telemetry-out DIR`` writes the bundle):
the reference's spans under its names and arguments (``serve.prefill``,
``serve.prefill_chunk``, ``serve.decode``, ``serve.spec_draft``,
``serve.spec_verify``, ``serve.cow_copy``, ``serve.swap_out``,
``serve.swap_in``) and the speculation metrics ``spec_drafted_total``,
``spec_accepted_total`` and ``spec_acceptance_rate``. Each span wraps the
engine's *call* of a step from the host, never the step's body: a CUDA
graph replays no Python, so a span inside a captured step would run once,
at capture. A span times the host's side of the call (the launches or the
replay, not the device's work), and adds no synchronization; with
telemetry off a site costs one attribute lookup and a shared no-op.

Not ported: the lockstep loop.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 8 --attn-impl pallas [--kv-layout paged] [--draft-depth 3] \\
      [--temperature 0.9 --top-k 32 --sample-seed 1] \\
      [--json-out serve.json] [--telemetry-out tel]
  PYTHONPATH=src python -m repro_torch.launch.obs_report tel
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.kernels.backend import auto_decode_impl, resolve_device
from repro_torch.launch.steps import (build_decode_step,
                                      build_paged_decode_step,
                                      build_paged_prefill_step,
                                      build_paged_spec_decode_step,
                                      build_prefill_step, build_sampler,
                                      build_spec_decode_step)
from repro_torch.models.registry import build_model, rebuild_model
from repro_torch.paging import BlockPoolExhausted, PagedKVCache
from repro_torch.spec.verify import greedy_verify, rejection_verify

# the families the continuous-batching engine serves (the reference's)
ENGINE_FAMILIES = ("dense", "moe")

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32 prompt tokens
    max_new_tokens: int
    # graceful degradation: a queued request that has not been admitted
    # within deadline_steps engine steps of submission is dropped with a
    # "timeout" rejection instead of waiting forever (None = patient)
    deadline_steps: Optional[int] = None
    submitted_at: int = -1  # engine decode_steps at submit(); set by submit


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: List[int]  # generated token ids (first comes from prefill logits)
    reason: str  # "eos" | "length"
    prompt_len: int


@dataclasses.dataclass
class Rejected:
    """A request the engine declined instead of serving: load shedding under
    pool pressure, a queued-deadline timeout, or a drain. ``retry_after`` is
    the engine's estimate (in decode steps) of when resubmission could
    succeed — the serving analogue of an HTTP 503 Retry-After."""
    uid: int
    reason: str  # "shed" | "timeout" | "draining"
    retry_after: int


@dataclasses.dataclass
class SwappedSeq:
    """A mid-stream sequence whose KV blocks were evicted to host memory:
    the host copy of its blocks (logical order), the slot bookkeeping, and
    its worst-case block reservation. Restore is bitwise."""
    uid: int
    generated: List[int]
    cache_len: int
    budget: int
    next_token: int
    host_kv: Dict[str, torch.Tensor]  # leaves (L, n_blocks, block_size, ...)
    n_blocks: int
    worst: int  # worst-case block reservation to restore
    swapped_at: int  # engine decode_steps at swap-out (FIFO restore order)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a model's KV-cache decode path."""

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 eos_id: Optional[int] = None, cache_dtype=torch.float32,
                 kv_layout: str = "contig", block_size: int = 16,
                 num_blocks: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, sample_seed: int = 0,
                 bucket_prompts: bool = False,
                 admission_policy: str = "serialize",
                 max_queue: Optional[int] = None, prefix_cache: bool = True,
                 swap_grace: int = 2, draft_depth: int = 0,
                 draft_source=None, jit: bool = True):
        if model.cfg.family not in ENGINE_FAMILIES:
            raise ValueError(f"continuous batching needs a slotted KV cache; "
                             f"family {model.cfg.family!r} is served by the "
                             f"reference's lockstep path, not ported yet")
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"kv_layout must be contig|paged, got {kv_layout!r}")
        if admission_policy not in ("serialize", "shed", "swap"):
            raise ValueError(f"admission_policy must be serialize|shed|swap, "
                             f"got {admission_policy!r}")
        if admission_policy == "swap" and kv_layout != "paged":
            raise ValueError("admission_policy='swap' needs the paged layout "
                             "(there are no blocks to evict under contig)")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.kv_layout = kv_layout
        self.block_size = block_size
        self.bucket_prompts = bucket_prompts
        self.jit = bool(jit)
        # serving-rung knobs (engine.jobs.ServeJob migrates these live); the
        # as-built settings are what a None override restores
        self.slot_cap: Optional[int] = None
        self._base_model = model
        self._base_cache_dtype = cache_dtype
        self._attn_impl_override: Optional[str] = None
        # whether the last step() ran a compiled decode or verify step that
        # did not replay (its eager first call, or its capture): a job
        # timing steps leaves those out of its estimates
        self.last_step_compiled = False

        self.cache_len = np.zeros(max_batch, np.int32)
        self.tokens = np.zeros((max_batch, 1), np.int32)
        self.slot_uid: List[Optional[int]] = [None] * max_batch
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.generated: List[List[int]] = [[] for _ in range(max_batch)]

        self.queue: Deque[Request] = collections.deque()
        self.finished: Dict[int, Finished] = {}
        # under pool pressure: "serialize" stalls the queue behind its head,
        # "shed" rejects the head with a retry-after hint, "swap" parks cold
        # residents on the host (paged only)
        self.admission_policy = admission_policy
        if max_queue is None and admission_policy == "shed":
            max_queue = 2 * max_batch
        self.max_queue = max_queue
        self.accepting = True  # drain() flips this; submit() then rejects
        self.rejected: Dict[int, Rejected] = {}
        self.shed_count = 0
        self.timeout_count = 0
        self._held_blocks = 0  # pool blocks held by an external co-tenant
        self._hold_seq = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self._active_slot_steps = 0
        self._uid_prompt_len: Dict[int, int] = {}
        self.prefill_lengths: Dict[int, int] = {}  # padded length -> count
        # prefix sharing / chunked prefill / swap / dirty-row accounting
        self.prefill_chunks = 0          # chunk-prefill invocations
        self.prefill_chunks_skipped = 0  # prompt chunks skipped via prefix hit
        self.cow_copies = 0              # copy-on-write device block copies
        self.table_rows_shipped = 0      # dirty block-table rows sent to device
        self.table_uploads = 0           # full-table uploads (bulk dirt)
        self.swapped: Dict[int, SwappedSeq] = {}  # uid -> parked sequence
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_grace = max(0, int(swap_grace))
        # per-slot step of last admit/swap-in: LRU victim choice + grace
        self._resident_since = np.zeros(max_batch, np.int64)
        self.admission_waits: Dict[int, int] = {}  # uid -> steps queued
        self._stalled_steps = 0

        # speculative decoding: depth is a serving rung the arbiter walks
        self._base_draft_depth = max(0, int(draft_depth))
        self.draft_depth = self._base_draft_depth
        self.draft = draft_source
        if self.draft is None and self.draft_depth > 0:
            from repro_torch.spec.draft import NGramDraft
            self.draft = NGramDraft()
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

        # sampling: one draw a slot from its fold_in(seed, uid, index) key
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._sampler = None
        if self.temperature > 0.0:
            self._sampler = build_sampler(self.temperature, self.top_k)
            self._base_key = prng.PRNGKey(sample_seed)

        # device buffers of the steps' per-step inputs, by name and shape
        # (_dev): fixed addresses, filled by copy_ through pinned staging
        self._bufs: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        if kv_layout == "paged":
            # virtual capacity per sequence: T blocks; the default provisions
            # the contiguous equivalent, plus the null block
            blocks_per_seq = -(-max_seq // block_size)
            if num_blocks is None:
                num_blocks = max_batch * blocks_per_seq + 1
            self.kv = PagedKVCache(num_blocks, block_size, max_batch,
                                   blocks_per_seq, prefix_cache=prefix_cache)
            # worst-case blocks per resident request, so allocate-on-boundary
            # can never exhaust the pool mid-decode (accounting only)
            self._reserved: Dict[int, int] = {}
            self.cache = model.init_paged_cache(num_blocks, block_size,
                                                cache_dtype)
            # device-resident dense block table, updated row-wise from the
            # host table's dirty set instead of re-uploaded every step (a
            # copy: the host table keeps changing under it); always written
            # in place, never replaced
            self._dev_tables = torch.tensor(self.kv.tables, device=self.device)
            self.kv.take_dirty()  # the upload above covered the initial rows
        else:
            self.kv = None
            self.cache = model.init_cache(max_batch, max_seq, cache_dtype)
        # the cache's storage of each dtype set_kv_dtype has met
        self._kv_store: Dict[torch.dtype, Dict[str, torch.Tensor]] = {
            cache_dtype: self.cache}
        self._build_steps(model)

    def _build_steps(self, model) -> None:
        """(Re)build the steps for ``model`` under the active layout. The
        decode and verify steps are compiled (CUDA graphs on the card,
        launch/steps.CompiledStep); prefill and prefill chunks stay eager.
        Steps built before are dropped, and their graphs with them."""
        self._prefill = build_prefill_step(model)
        if self.kv is not None:
            self._decode = build_paged_decode_step(model, jit=self.jit,
                                                   sampler=self._sampler)
            self._prefill_chunk = build_paged_prefill_step(model)
            self._prefill_chunk_ro = build_paged_prefill_step(model,
                                                              write=False)
            self._spec_decode = build_paged_spec_decode_step(model, jit=self.jit) \
                if model.paged_spec_decode_step is not None else None
        else:
            self._decode = build_decode_step(model, jit=self.jit,
                                             sampler=self._sampler)
            self._spec_decode = build_spec_decode_step(model, jit=self.jit) \
                if model.spec_decode_step is not None else None

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request; returns False (with a ``Rejected`` record) when
        the engine is draining or ``shed`` finds the queue full. Malformed
        requests raise."""
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"prompt {req.uid} ({len(req.prompt)} tokens) "
                             f"does not fit max_seq={self.max_seq}")
        if self.kv is not None and \
                self._worst_blocks(req) > self.kv.pool.num_usable:
            raise ValueError(
                f"request {req.uid} ({len(req.prompt)} prompt + "
                f"{req.max_new_tokens} budget) can never be resident: pool "
                f"has {self.kv.pool.num_usable} blocks of {self.block_size}")
        if not self.accepting:
            self._reject(req, "draining")
            return False
        if self.admission_policy == "shed" and self.max_queue is not None \
                and len(self.queue) >= self.max_queue:
            self._reject(req, "shed")
            return False
        req.submitted_at = self.decode_steps
        self.queue.append(req)
        return True

    def drain(self) -> None:
        """Stop admitting: refuse new submissions, shed the waiting queue,
        let residents stream to completion. Idempotent."""
        if not self.accepting:
            return
        self.accepting = False
        while self.queue:
            self._reject(self.queue.popleft(), "draining")

    def _retry_after(self) -> int:
        """Steps until an admission could plausibly succeed: the shortest
        remaining generation budget among residents, or 1 when idle."""
        remaining = [int(self.slot_budget[s]) - len(self.generated[s])
                     for s in range(self.max_batch)
                     if self.slot_uid[s] is not None]
        return max(1, min(remaining)) if remaining else 1

    def _reject(self, req: Request, reason: str) -> None:
        self.rejected[req.uid] = Rejected(
            uid=req.uid, reason=reason, retry_after=self._retry_after())
        if reason == "shed":
            self.shed_count += 1
        elif reason == "timeout":
            self.timeout_count += 1

    def _expire_deadlines(self) -> None:
        """Drop queued requests whose admission deadline has passed. Only
        *waiting* requests time out — a request already resident owns its
        resources and streams to completion."""
        if not any(r.deadline_steps is not None for r in self.queue):
            return
        keep: List[Request] = []
        for req in self.queue:
            waited = self.decode_steps - req.submitted_at
            if req.deadline_steps is not None and \
                    waited > req.deadline_steps:
                self._reject(req, "timeout")
            else:
                keep.append(req)
        self.queue = collections.deque(keep)

    # -- external memory pressure (chaos / co-tenant apps) ------------------

    def hold_blocks(self, n: int) -> int:
        """Let a co-tenant (the chaos injector) take up to ``n`` KV blocks
        out of the pool. Holds only what residents have not reserved, so a
        live sequence can never be starved mid-decode. Under the swap policy,
        cold residents are evicted to host memory first so the co-tenant gets
        its blocks without starving admission afterwards. Returns the count
        actually held. No-op (0) under the contig layout."""
        if self.kv is None:
            return 0
        self.release_held()
        if self.admission_policy == "swap":
            # make room for the co-tenant by parking cold residents on host
            while self.kv.pool.num_usable - sum(self._reserved.values()) \
                    < int(n):
                victim = self._swap_victim()
                if victim is None:
                    break
                self._swap_out(victim)
        avail = self.kv.pool.num_usable - sum(self._reserved.values())
        take = max(0, min(int(n), avail, self.kv.pool.num_free))
        if take:
            self._hold_seq += 1
            self.kv.pool.allocate(("__hold__", self._hold_seq),
                                  take * self.block_size)
            self._held_blocks = take
        return take

    def release_held(self) -> None:
        """Return externally-held blocks to the pool (pressure clears)."""
        if self._held_blocks:
            self.kv.pool.free(("__hold__", self._hold_seq))
            self._held_blocks = 0

    # -- host-memory swap tier (admission_policy="swap") ---------------------

    def _swap_victim(self) -> Optional[int]:
        """LRU second-chance victim: the resident slot least recently
        admitted/swapped-in, skipping slots inside the grace window."""
        cands = [s for s in range(self.max_batch)
                 if self.slot_uid[s] is not None
                 and self.decode_steps - self._resident_since[s]
                 >= self.swap_grace]
        if not cands:
            return None
        return min(cands, key=lambda s: self._resident_since[s])

    def _swap_out(self, slot: int) -> None:
        """Copy a resident sequence's blocks to host memory, in logical
        order, and free them; swap-in may restore into any fresh blocks."""
        uid = self.slot_uid[slot]
        blocks = self.kv.slot_blocks(slot)
        with obs.get_telemetry().span("serve.swap_out", uid=uid,
                                      blocks=len(blocks)):
            phys = torch.tensor(blocks, dtype=torch.long, device=self.device)
            host = {name: pool[:, phys].cpu()
                    for name, pool in self.cache.items()}
            self.swapped[uid] = SwappedSeq(
                uid=uid, generated=list(self.generated[slot]),
                cache_len=int(self.cache_len[slot]),
                budget=int(self.slot_budget[slot]),
                next_token=int(self.tokens[slot, 0]), host_kv=host,
                n_blocks=len(blocks), worst=self._reserved.pop(slot),
                swapped_at=self.decode_steps)
            self.slot_uid[slot] = None
            self.kv.release(slot)
            if self.draft is not None:
                self.draft.release(slot)
            self.swap_outs += 1

    def _swap_in(self, slot: int, sw: SwappedSeq) -> None:
        """Restore a parked sequence into fresh pool blocks and resume."""
        with obs.get_telemetry().span("serve.swap_in", uid=sw.uid,
                                      blocks=sw.n_blocks):
            blocks = self.kv.admit(slot, sw.uid,
                                   sw.n_blocks * self.block_size)
            phys = torch.tensor(blocks, dtype=torch.long, device=self.device)
            for name, pool in self.cache.items():
                pool[:, phys] = sw.host_kv[name].to(self.device, pool.dtype)
        self._reserved[slot] = sw.worst
        self.slot_uid[slot] = sw.uid
        self.slot_budget[slot] = sw.budget
        self.cache_len[slot] = sw.cache_len
        self.tokens[slot, 0] = sw.next_token
        self.generated[slot] = list(sw.generated)
        self._resident_since[slot] = self.decode_steps
        if self.draft is not None:
            # the parked record keeps no prompt: the draft restarts from the
            # generated history alone (weaker proposals, never wrong ones)
            self.draft.admit(slot, sw.generated)
        self.swap_ins += 1

    def _try_swap_in(self) -> None:
        """Restore parked sequences (FIFO) into free slots while their
        worst-case reservation fits. Runs before admission each step."""
        for uid in sorted(self.swapped, key=lambda u: self.swapped[u].swapped_at):
            if self.slot_cap is not None and \
                    sum(1 for u in self.slot_uid if u is not None) >= \
                    self.slot_cap:
                return
            free = [s for s in range(self.max_batch)
                    if self.slot_uid[s] is None]
            if not free:
                return
            sw = self.swapped[uid]
            fits = (self._held_blocks + sum(self._reserved.values()) + sw.worst
                    <= self.kv.pool.num_usable) and \
                self.kv.pool.can_allocate(sw.n_blocks * self.block_size)
            if not fits:
                return  # FIFO: later (smaller) sequences must not starve it
            del self.swapped[uid]
            self._swap_in(free[0], sw)

    def _make_room(self, worst: int) -> bool:
        """Swap out LRU residents until a ``worst``-block reservation fits;
        False when no eligible victim remains."""
        while self._held_blocks + sum(self._reserved.values()) + worst \
                > self.kv.pool.num_usable:
            victim = self._swap_victim()
            if victim is None:
                return False
            self._swap_out(victim)
        return True

    def _worst_blocks(self, req: Request) -> int:
        """Blocks the request could ever own: prompt plus generation budget,
        capped by the cache-capacity retirement rule."""
        worst = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        return self.kv.pool.blocks_for(worst)

    def _prefill_len(self, P: int) -> int:
        """Contiguous admission prefill length: the true prompt length,
        rounded up to the next power of two under ``bucket_prompts``, capped
        at max_seq."""
        L = P
        if self.bucket_prompts:
            L = 1 << (max(L, 1) - 1).bit_length()
        return min(L, self.max_seq)

    def _stream_keys(self, n: int = 0) -> np.ndarray:
        """Every slot's sampling key, ``fold_in(fold_in(PRNGKey(seed), uid),
        index)`` with index the count of tokens the slot has emitted (an
        idle slot takes uid 0, as in the reference): (B, 2), or (B, n, 2)
        for the n emission indices a verify window may fill. Host numpy:
        the keys reach the device with the step's other inputs."""
        uids = np.asarray([0 if u is None else u for u in self.slot_uid],
                          np.int64)
        idxs = np.asarray([len(g) for g in self.generated], np.int64)
        if n:
            uids = np.broadcast_to(uids[:, None], (self.max_batch, n))
            idxs = idxs[:, None] + np.arange(n, dtype=np.int64)[None]
        return prng.fold_in(prng.fold_in(self._base_key, uids), idxs)

    def _pick_token(self, logits_row, uid: int, index: int) -> int:
        """logits_row: (V,) on the device. Greedy unless a sampler is
        configured; the draw runs on the logits' device.

        Sampling keys are a pure function of (seed, uid, index), so a
        request's sampled stream is independent of slot placement and batch
        composition."""
        if self._sampler is None:
            return int(logits_row.argmax())
        key = prng.fold_in(prng.fold_in(self._base_key, uid), index)
        return int(self._sampler(logits_row[None], torch.as_tensor(
            key[None], device=logits_row.device))[0])

    def _admit(self, slot: int, req: Request) -> None:
        P = len(req.prompt)
        if self.kv is not None:
            logits = self._paged_prefill(slot, req)
        else:
            Lp = self._prefill_len(P)
            self.prefill_lengths[Lp] = self.prefill_lengths.get(Lp, 0) + 1
            tokens = np.pad(np.asarray(req.prompt, np.int32), (0, Lp - P))
            batch = {"tokens": torch.as_tensor(tokens, device=self.device)[None]}
            if Lp != P:
                # causal attention keeps every position < P unaffected by the
                # right-padding; logits must come from the true last token
                batch["last_pos"] = P - 1
            with obs.get_telemetry().span("serve.prefill", uid=req.uid,
                                          prompt_len=P, padded_len=Lp):
                logits, pcache = self._prefill(self.params, batch)
                for name, buf in self.cache.items():  # splice into the slot
                    buf[:, slot:slot + 1, :Lp] = pcache[name].to(buf.dtype)
        first = self._pick_token(logits[0, -1], req.uid, 0)
        self.slot_uid[slot] = req.uid
        self.slot_budget[slot] = req.max_new_tokens
        self.cache_len[slot] = P
        self.tokens[slot, 0] = first
        self.generated[slot] = [first]
        self._uid_prompt_len[req.uid] = P
        self._resident_since[slot] = self.decode_steps
        self.admission_waits[req.uid] = max(
            0, self.decode_steps - max(req.submitted_at, 0))
        self.tokens_out += 1
        if self.draft is not None:
            self.draft.admit(slot, [int(t) for t in req.prompt])
            self.draft.commit(slot, [], first)  # first emission, no drafts
        if self._should_retire(slot, first):  # budget of 1, or prefill hit EOS
            self._retire(slot, "eos" if first == self.eos_id else "length")

    def _paged_prefill(self, slot: int, req: Request):
        """Chunked paged prefill with prefix sharing; returns last-token
        logits. Cache-hit prefix chunks are skipped (their blocks are
        mapped, already populated); only miss-suffix chunks run, writing
        prompt KV straight into the slot's pool blocks. A full-prompt hit
        still runs the *final* chunk read-only — shared blocks must not be
        rewritten, but the last position's logits are needed to emit the
        first token."""
        P = len(req.prompt)
        bs = self.block_size
        self._reserved[slot] = self._worst_blocks(req)
        shared, covered = self.kv.match_prefix(req.prompt)
        blocks = self.kv.admit(slot, req.uid, P, shared=shared)
        n_blocks = len(blocks)
        Lp = n_blocks * bs
        self.prefill_lengths[Lp] = self.prefill_lengths.get(Lp, 0) + 1
        table_row = torch.tensor(self.kv.tables[slot:slot + 1], device=self.device)
        padded = torch.as_tensor(
            np.pad(np.asarray(req.prompt, np.int32), (0, Lp - P)),
            device=self.device)
        first_miss = n_blocks if covered >= P else covered // bs
        logits = None
        tel = obs.get_telemetry()
        for c in range(first_miss, n_blocks):
            with tel.span("serve.prefill_chunk", uid=req.uid, chunk=c,
                          of=n_blocks):
                logits, _ = self._prefill_chunk(
                    self.params, self.cache, padded[None, c * bs:(c + 1) * bs],
                    c * bs, table_row, min(P - 1 - c * bs, bs - 1))
            self.prefill_chunks += 1
        self.prefill_chunks_skipped += first_miss
        if logits is None:  # every block hit: read-only last-chunk recompute
            c = n_blocks - 1
            with tel.span("serve.prefill_chunk", uid=req.uid, chunk=c,
                          of=n_blocks, readonly=True):
                logits, _ = self._prefill_chunk_ro(
                    self.params, self.cache, padded[None, c * bs:(c + 1) * bs],
                    c * bs, table_row, P - 1 - c * bs)
            self.prefill_chunks += 1
        self.kv.index_prompt(slot, req.prompt)
        return logits

    def _should_retire(self, slot: int, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            return True
        if len(self.generated[slot]) >= int(self.slot_budget[slot]):
            return True
        # the next decode writes at position cache_len; retire only once that
        # would fall off the cache — position max_seq-1 is still serveable
        return self.cache_len[slot] >= self.max_seq

    def _retire(self, slot: int, reason: str) -> None:
        uid = self.slot_uid[slot]
        self.finished[uid] = Finished(
            uid=uid, tokens=list(self.generated[slot]), reason=reason,
            prompt_len=self._uid_prompt_len.pop(uid))
        self.slot_uid[slot] = None
        if self.draft is not None:
            self.draft.release(slot)
        if self.kv is not None:
            # blocks go back to the pool; the slot's table row resets to the
            # null block so its masked idle-slot writes stay harmless
            self.kv.release(slot)
            self._reserved.pop(slot, None)
        # cache_len stays frozen (it may equal max_seq): the stale KV keeps
        # idle-slot math well-defined and is overwritten by the next
        # admission

    # -- serving-rung knobs ------------------------------------------------

    def set_draft_depth(self, k: Optional[int]) -> None:
        """Serving-rung knob: verify ``k`` draft tokens per engine step
        (0 disables speculation; ``None`` restores the as-built depth).

        Takes effect on the next step — residents and the KV cache are
        untouched, because rollback is already cache_len bookkeeping; greedy
        streams are token-identical at any depth."""
        depth = self._base_draft_depth if k is None else max(0, int(k))
        if depth == self.draft_depth:
            return
        self.draft_depth = depth
        if depth > 0 and self.draft is None:
            # late enable on an engine built without a source: self-draft
            # from each resident's own emitted history
            from repro_torch.spec.draft import NGramDraft
            self.draft = NGramDraft()
            for slot in range(self.max_batch):
                if self.slot_uid[slot] is not None:
                    self.draft.admit(slot, self.generated[slot])

    def set_slot_cap(self, cap: Optional[int]) -> None:
        """Cap concurrently-resident requests (decode microbatch cap).

        Takes effect at admission: resident sequences above a lowered cap
        keep streaming and the population shrinks as they retire — no
        request is ever evicted mid-decode. ``None`` removes the cap."""
        self.slot_cap = None if cap is None else max(1, int(cap))

    def set_kv_dtype(self, dtype=None) -> None:
        """Cast the live KV cache (``None`` restores the as-built dtype).

        Halving cache bytes (bf16) halves the bandwidth every decode step
        streams — the serving analogue of a bf16 training rung; the decode
        kernels read a bf16 cache under f32 queries and compute in f32.
        Lossy on the way down: re-upcasting does not recover the rounded
        bits.

        The values are copied into the cache's storage for that dtype, made
        the first time the dtype is met and kept: the compiled decode and
        verify steps' graphs address their cache, so a ladder that walks
        back replays them instead of capturing again (as the reference's
        jit keeps one executable per dtype). The storage of the dtype left
        keeps stale values, which the next copy into it overwrites whole."""
        if isinstance(dtype, str):
            dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                     "float16": torch.float16}[dtype]
        dtype = self._base_cache_dtype if dtype is None else dtype
        if all(a.dtype == dtype for a in self.cache.values()):
            return
        store = self._kv_store.get(dtype)
        if store is None:
            with torch.inference_mode(False):  # the splices write it in place
                store = {name: torch.empty_like(a, dtype=dtype)
                         for name, a in self.cache.items()}
            self._kv_store[dtype] = store
        for name, a in self.cache.items():
            store[name].copy_(a)
        self.cache = store

    def set_attn_impl(self, impl: Optional[str]) -> None:
        """Rebuild the decode, verify and prefill steps under a different
        attention impl (``None`` restores the as-built model). Params, cache
        and all slot bookkeeping carry over — only the steps change; the
        old compiled steps are dropped with their graphs."""
        if impl == self._attn_impl_override:
            return
        self._attn_impl_override = impl
        if impl is None:
            model = self._base_model
        else:
            # rebuild from the as-built model's own kwargs so only the
            # attention impl changes (chunk, remat, dtype, device carry over)
            model = rebuild_model(self._base_model, impl=impl)
        if model is self.model:
            return
        self.model = model
        self._build_steps(model)

    def compiled_steps(self) -> List:
        """The engine's compiled steps (those with capture counts)."""
        return [f for f in (self._decode, self._spec_decode)
                if hasattr(f, "captures")]

    # -- stepping ----------------------------------------------------------

    def _pool_pressure(self, req: Request) -> bool:
        """True when admitting ``req`` could starve a resident later: its
        worst case plus every resident's reservation plus externally held
        blocks would overrun the pool."""
        if self.kv is None:
            return False
        return self._held_blocks + sum(self._reserved.values()) + \
            self._worst_blocks(req) > self.kv.pool.num_usable

    def _admit_waiting(self) -> None:
        for slot in range(self.max_batch):
            while True:
                if not self.queue or not self.accepting:
                    return
                if self.slot_cap is not None and \
                        sum(1 for u in self.slot_uid if u is not None) >= \
                        self.slot_cap:
                    return
                if self.slot_uid[slot] is not None:
                    break  # occupied; try the next slot
                head = self.queue[0]
                if self._pool_pressure(head):
                    # the policy decides who pays: "serialize" stalls the
                    # whole queue behind the head (retried next step);
                    # "shed" rejects the head and lets the next request try
                    # the slot; "swap" parks cold residents on the host,
                    # falling back to serialize when all are grace-protected
                    if self.admission_policy == "swap" and \
                            self._make_room(self._worst_blocks(head)):
                        pass  # pressure cleared; fall through to admission
                    elif self.admission_policy == "shed":
                        self._reject(self.queue.popleft(), "shed")
                        break
                    else:
                        return
                req = self.queue.popleft()
                try:
                    self._admit(slot, req)
                except BlockPoolExhausted:
                    # unreachable for the engine's own traffic (the
                    # reservation check above); kv.admit fails atomically,
                    # so rolling back the reservation restores the engine
                    self._reserved.pop(slot, None)
                    if self.admission_policy == "shed":
                        self._reject(req, "shed")
                    else:
                        self.queue.appendleft(req)
                        return
                break

    def _append_positions(self, active: List[int], n: int) -> None:
        """Allocate-on-boundary for the next ``n`` cache positions of every
        active slot (n = 1 plain decode, k+1 speculative window). A
        copy-on-write event copies the shared block on the device, across
        every layer's pool, before the decode writes into it."""
        for slot in active:
            cl = int(self.cache_len[slot])
            for i in range(n):
                ev = self.kv.append(slot, cl + i)
                if ev is not None and ev.kind == "cow":
                    with obs.get_telemetry().span("serve.cow_copy",
                                                  slot=slot, src=ev.src,
                                                  dst=ev.block):
                        for pool in self.cache.values():  # (L, NB, bs, K, hd)
                            pool[:, ev.block] = pool[:, ev.src]
                    self.cow_copies += 1

    def _ship_dirty_tables(self) -> None:
        rows = self.kv.take_dirty()
        if not rows:
            return
        # ship only the rows that changed since last step; bulk dirt (e.g.
        # after a swap storm) falls back to one full upload
        if len(rows) > max(1, self.max_batch // 2):
            self._dev_tables.copy_(torch.as_tensor(self.kv.tables))
            self.table_uploads += 1
        else:
            for r in rows:
                self._dev_tables[r] = torch.as_tensor(self.kv.tables[r],
                                                      device=self.device)
        self.table_rows_shipped += len(rows)

    def _spec_k(self, active: List[int]) -> int:
        """Effective draft depth this step: the configured depth clamped so
        the verify window never writes past the cache and never allocates
        past a paged reservation. 0 falls back to the one-token step, as it
        does for a model without a verify step (MLA)."""
        if self.draft_depth < 1 or self.draft is None or self._spec_decode is None:
            return 0
        k = min(self.draft_depth,
                self.max_seq - 1 - max(int(self.cache_len[s]) for s in active),
                min(int(self.slot_budget[s]) - len(self.generated[s])
                    for s in active))
        return max(k, 0)

    def _dev(self, name: str, a: np.ndarray) -> torch.Tensor:
        """``a`` copied into the engine's device buffer ``name`` (one per
        name and shape, made on first use) through a pinned host buffer, and
        that device buffer returned: a step's inputs keep their addresses
        and no tensor is made per step. The copy is asynchronous; the step's
        own read-back (``.cpu()``) completes it before the next step writes
        the host buffer again."""
        key = (name, a.shape)
        bufs = self._bufs.get(key)
        if bufs is None:
            host = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                               pin_memory=self.device.type == "cuda")
            bufs = self._bufs[key] = (host, torch.empty_like(
                host, device=self.device))
        host, dev = bufs
        host.numpy()[...] = a
        dev.copy_(host, non_blocking=True)
        return dev

    def step(self) -> List[Tuple[int, int]]:
        """Admit waiting requests, run one batched decode, retire finishers.

        Returns (uid, token) pairs emitted this step.
        """
        self.last_step_compiled = False
        self._expire_deadlines()
        if self.swapped:
            self._try_swap_in()
        self._admit_waiting()
        active = [s for s in range(self.max_batch) if self.slot_uid[s] is not None]
        if not active:
            # nothing resident but work pending (parked on host with no
            # headroom): guard against a run() loop that never progresses
            if self.queue or self.swapped:
                self._stalled_steps += 1
                if self._stalled_steps > 10000:
                    raise RuntimeError(
                        f"engine stalled: {len(self.queue)} queued, "
                        f"{len(self.swapped)} swapped, no admissible slot "
                        f"for {self._stalled_steps} steps")
            return []
        self._stalled_steps = 0
        k = self._spec_k(active)
        if k >= 1:
            return self._step_speculative(active, k)
        # a sampled step draws inside itself, under each slot's stream key
        keys = () if self._sampler is None else \
            (self._dev("keys", self._stream_keys()),)
        tables = ()
        if self.kv is not None:
            self._append_positions(active, 1)
            self._ship_dirty_tables()
            tables = (self._dev_tables,)
        with obs.get_telemetry().span("serve.decode", batch=len(active)):
            next_tok, _, self.cache = self._decode(
                self.params, self.cache, self._dev("tokens", self.tokens),
                self._dev("cache_len", self.cache_len), *tables, *keys)
        self._note_compiled(self._decode)
        next_np = next_tok.cpu().numpy()
        self.decode_steps += 1
        self._active_slot_steps += len(active)
        emitted = []
        for slot in active:
            tok = int(next_np[slot, 0])
            self.generated[slot].append(tok)
            self.cache_len[slot] += 1
            self.tokens[slot, 0] = tok
            self.tokens_out += 1
            emitted.append((self.slot_uid[slot], tok))
            if self.draft is not None:
                # keep the draft's view of the stream current even while
                # speculation is off (depth walked to 0, or a clamped round)
                self.draft.commit(slot, [], tok)
            if self._should_retire(slot, tok):
                self._retire(slot, "eos" if (self.eos_id is not None and
                                             tok == self.eos_id) else "length")
        return emitted

    def _step_speculative(self, active: List[int], k: int) -> List[Tuple[int, int]]:
        """One speculative round: draft k tokens per active slot, score the
        (k+1)-token window [last_emitted, d_1..d_k] in ONE verify pass,
        emit the accepted prefix plus exactly one non-draft token.

        Rollback is pure cache_len bookkeeping: the verify pass wrote KV for
        every window position, but cache_len only advances over the emitted
        tokens — rejected positions' KV stays resident, masked dead by the
        ragged-length kernels, and is overwritten by the next round. Greedy
        verification makes the emitted stream token-identical to one-token
        greedy decode; sampled mode is distribution-faithful rejection
        sampling on the engine's fold_in(seed, uid, index) streams."""
        S = k + 1
        tel = obs.get_telemetry()
        with tel.span("serve.spec_draft", batch=len(active), k=k):
            drafts, dprobs = self.draft.propose(active, k)
        win = np.zeros((self.max_batch, S), np.int32)
        win[:, 0] = self.tokens[:, 0]
        probs_b = None
        if dprobs is not None:
            probs_b = np.zeros((self.max_batch, k, dprobs.shape[-1]),
                               np.float32)
        for row, slot in enumerate(active):
            win[slot, 1:] = drafts[row]
            if probs_b is not None:
                probs_b[slot] = dprobs[row]
        tables = ()
        if self.kv is not None:
            self._append_positions(active, S)
            self._ship_dirty_tables()
            tables = (self._dev_tables,)
        with tel.span("serve.spec_verify", batch=len(active), k=k):
            logits, self.cache = self._spec_decode(
                self.params, self.cache, self._dev("window", win),
                self._dev("cache_len", self.cache_len), *tables)
        self._note_compiled(self._spec_decode)
        # the compiled step's logits are its graph's buffer: verified here,
        # on the device, before the next call overwrites them
        if self._sampler is None:
            toks, n_emit = greedy_verify(logits,
                                         self._dev("drafts", win[:, 1:]))
        else:
            toks, n_emit = rejection_verify(
                logits, self._dev("drafts", win[:, 1:]),
                None if probs_b is None else self._dev("draft_probs", probs_b),
                self._dev("spec_keys", self._stream_keys(S)),
                temperature=self.temperature, top_k=self.top_k)
        tok_np = toks.cpu().numpy()
        n_np = n_emit.cpu().numpy()
        self.decode_steps += 1
        self._active_slot_steps += len(active)
        emitted: List[Tuple[int, int]] = []
        accepted_total = 0
        for slot in active:
            uid = self.slot_uid[slot]
            seq = [int(t) for t in tok_np[slot, :int(n_np[slot])]]
            self.spec_rounds += 1
            self.spec_drafted += k
            self.spec_accepted += len(seq) - 1
            accepted_total += len(seq) - 1
            retired = False
            for tok in seq:
                self.generated[slot].append(tok)
                self.cache_len[slot] += 1
                self.tokens[slot, 0] = tok
                self.tokens_out += 1
                emitted.append((uid, tok))
                if self._should_retire(slot, tok):
                    # the retire trims the round: later accepted tokens are
                    # dropped and their KV stays masked dead, like a
                    # rejection
                    self._retire(slot, "eos" if (self.eos_id is not None and
                                                 tok == self.eos_id)
                                 else "length")
                    retired = True
                    break
            if not retired:
                self.draft.commit(slot, seq[:-1], seq[-1])
        m = tel.metrics
        m.counter("spec_drafted_total",
                  "draft tokens proposed to the verifier").inc(k * len(active))
        m.counter("spec_accepted_total",
                  "draft tokens accepted by the verifier").inc(accepted_total)
        m.gauge("spec_acceptance_rate",
                "running accepted/drafted ratio").set(
            self.spec_accepted / max(1, self.spec_drafted))
        return emitted

    def _note_compiled(self, step) -> None:
        self.last_step_compiled = getattr(step, "last_call", None) in (
            "warmup", "capture")

    def run(self, requests: List[Request]) -> Dict[int, Finished]:
        for req in requests:
            self.submit(req)
        while self.has_work:
            self.step()
        return self.finished

    @property
    def has_work(self) -> bool:
        """True while anything is queued, resident, or swapped out."""
        return bool(self.queue) or bool(self.swapped) or \
            any(u is not None for u in self.slot_uid)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots active per decode step (batching efficiency)."""
        if not self.decode_steps:
            return 0.0
        return self._active_slot_steps / (self.decode_steps * self.max_batch)

    def kv_bytes(self, *, peak: bool = False) -> int:
        """KV-cache memory footprint in bytes.

        ``contig``: the whole (max_batch, max_seq) slab. ``paged``: pool
        bytes scaled to blocks in use (``peak`` gives the high-water mark) —
        what a block-granular allocator would have had to back.
        """
        total = sum(a.numel() * a.element_size() for a in self.cache.values())
        if self.kv is None:
            return total
        blocks = self.kv.pool.peak_blocks_in_use if peak \
            else self.kv.pool.blocks_in_use
        return int(total * blocks / self.kv.pool.num_blocks)

    def stats(self) -> Dict:
        """Engine-level stats (occupancy, prefill buckets, pool accounting,
        speculation) and the flash kernels' launch counts so far in this
        process (``kernels/flash_attention.launches``)."""
        out = {
            "decode_steps": self.decode_steps,
            "tokens_out": self.tokens_out,
            "occupancy": round(self.occupancy, 4),
            "kv_layout": self.kv_layout,
            "prefill_buckets": {str(k): v for k, v in
                                sorted(self.prefill_lengths.items())},
            "prefill_compiles": len(self.prefill_lengths),
            "kv_bytes": self.kv_bytes(),
            "admission_policy": self.admission_policy,
            "accepting": self.accepting,
            "shed": self.shed_count,
            "timeouts": self.timeout_count,
            "rejected": len(self.rejected),
        }
        waits = list(self.admission_waits.values())
        out["admission_wait_mean"] = \
            round(sum(waits) / len(waits), 3) if waits else 0.0
        out["admission_wait_max"] = max(waits) if waits else 0
        out["draft_depth"] = self.draft_depth
        if self.spec_rounds:
            out["spec_rounds"] = self.spec_rounds
            out["spec_drafted"] = self.spec_drafted
            out["spec_accepted"] = self.spec_accepted
            out["spec_acceptance"] = round(
                self.spec_accepted / max(1, self.spec_drafted), 4)
        if self.kv is not None:
            out["held_blocks"] = self._held_blocks
            out["prefill_chunks"] = self.prefill_chunks
            out["prefill_chunks_skipped"] = self.prefill_chunks_skipped
            out["cow_copies"] = self.cow_copies
            out["table_rows_shipped"] = self.table_rows_shipped
            out["table_uploads"] = self.table_uploads
            out["swapped"] = len(self.swapped)
            out["swap_outs"] = self.swap_outs
            out["swap_ins"] = self.swap_ins
            live = {self.slot_uid[s]: int(self.cache_len[s])
                    for s in range(self.max_batch)
                    if self.slot_uid[s] is not None}
            out["pool"] = self.kv.stats(live)
            out["peak_kv_bytes"] = self.kv_bytes(peak=True)
        out["kernel_launches"] = dict(flash_attention.launches)
        return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _synthetic_requests(rng, n: int, prompt_len: int, gen: int,
                        vocab: int) -> List[Request]:
    """A ragged request stream: prompt lengths and budgets vary per request
    so retirement and admission interleave instead of running in lockstep.
    The same seed gives the JAX package's CLI the same stream."""
    reqs = []
    for uid in range(n):
        p = max(2, prompt_len + int(rng.integers(-prompt_len // 2, prompt_len // 2 + 1)))
        g = max(1, gen + int(rng.integers(-gen // 2, gen // 2 + 1)))
        reqs.append(Request(uid=uid,
                            prompt=rng.integers(0, vocab, p).astype(np.int32),
                            max_new_tokens=g))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="serving slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests in the stream (default: 3x batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache capacity (default: 2*(prompt+gen))")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "naive", "pallas"),
                    help="attention path; pallas = the hand-written flash "
                         "kernels; auto resolves via "
                         "kernels/backend.auto_decode_impl")
    ap.add_argument("--kv-layout", default="contig",
                    choices=("contig", "paged"),
                    help="KV cache layout: contiguous per-slot slabs, or "
                         "block-pooled paged cache (repro_torch.paging)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged layout: token positions per KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged layout: physical blocks in the pool "
                         "(default: contiguous-equivalent capacity)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter for sampling (0 = full vocab)")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--admission-policy", default="serialize",
                    choices=("serialize", "shed", "swap"),
                    help="overload behavior: serialize queues behind the "
                         "head-of-line request; shed rejects with "
                         "retry-after; swap parks cold residents' blocks in "
                         "host memory (paged layout only)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged layout: disable prompt-prefix block sharing")
    ap.add_argument("--swap-grace", type=int, default=2,
                    help="swap policy: steps a just-admitted/restored "
                         "sequence is protected from swap-out")
    ap.add_argument("--draft-depth", type=int, default=0,
                    help="speculative decoding: draft tokens verified per "
                         "engine step (0 = off)")
    ap.add_argument("--draft-source", default="ngram",
                    help="where drafts come from: 'ngram' (self-drafting "
                         "n-gram head) or a registry arch name served "
                         "reduced as a draft model")
    ap.add_argument("--bucket-prompts", action="store_true",
                    help="round admission prefill lengths up to power-of-two "
                         "buckets")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--telemetry-out", default=None,
                    help="directory for the repro_torch.obs telemetry bundle "
                         "(metrics.jsonl, spans.jsonl, trace.json, "
                         "audit.json)")
    args = ap.parse_args(argv)

    # before the model and the engine are built, so every span lands
    tel = obs.enable() if args.telemetry_out else None
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise SystemExit("CNN archs have no decode path")
    max_seq = args.max_seq or 2 * (args.prompt_len + args.gen)
    impl = args.attn_impl
    if impl == "auto":
        impl = auto_decode_impl(max_seq, device=device)
    model = build_model(cfg, impl=impl, device=device)
    params = model.init(model.generator(0))
    rng = np.random.default_rng(args.seed)

    n_req = args.requests or 3 * args.batch
    reqs = _synthetic_requests(rng, n_req, args.prompt_len, args.gen,
                               cfg.vocab_size)
    draft = None
    if args.draft_depth > 0:
        from repro_torch.spec.draft import build_draft_source
        draft = build_draft_source(
            args.draft_source, target_cfg=cfg, max_batch=args.batch,
            max_seq=max_seq, temperature=args.temperature, top_k=args.top_k,
            seed=args.sample_seed, device=device)
    engine = ContinuousBatchingEngine(
        model, params, max_batch=args.batch, max_seq=max_seq,
        eos_id=args.eos_id, kv_layout=args.kv_layout,
        block_size=args.block_size, num_blocks=args.kv_blocks,
        temperature=args.temperature, top_k=args.top_k,
        sample_seed=args.sample_seed, bucket_prompts=args.bucket_prompts,
        admission_policy=args.admission_policy,
        prefix_cache=not args.no_prefix_cache, swap_grace=args.swap_grace,
        draft_depth=args.draft_depth, draft_source=draft)
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok_s = engine.tokens_out / max(dt, 1e-9)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} mode=continuous impl={impl} kv={args.kv_layout} "
          f"device={dev_name} slots={args.batch} requests={n_req} "
          f"tokens={engine.tokens_out} steps={engine.decode_steps} "
          f"occupancy={engine.occupancy:.2f} wall={dt*1e3:.0f}ms "
          f"({tok_s:.1f} tok/s) launches={dict(flash_attention.launches)}")
    if engine.spec_rounds:
        print(f"spec: depth={engine.draft_depth} source={args.draft_source} "
              f"accepted {engine.spec_accepted}/{engine.spec_drafted} drafts "
              f"({engine.spec_accepted / max(1, engine.spec_drafted):.2f})")
    st = engine.stats()
    if args.kv_layout == "paged":
        pool = st["pool"]
        print(f"pool: {pool['peak_blocks_in_use']}/{pool['num_blocks']} peak "
              f"blocks, peak KV {st['peak_kv_bytes']/1e6:.2f}MB; "
              f"chunks run={st['prefill_chunks']} "
              f"skipped={st['prefill_chunks_skipped']} "
              f"cow={st['cow_copies']} "
              f"swap out/in={st['swap_outs']}/{st['swap_ins']}")
    sample = finished[0].tokens[:12] if 0 in finished else []
    print("sample uid=0:", sample)
    if args.json_out:
        payload = obs.versioned({
            "arch": cfg.name, "impl": impl, "device": dev_name,
            "kv_layout": args.kv_layout, "slots": args.batch,
            "requests": n_req, "tokens": engine.tokens_out,
            "steps": engine.decode_steps,
            "occupancy": round(engine.occupancy, 4), "wall_s": dt,
            "tok_s": tok_s, "stats": st,
            "finished": {str(u): {"reason": f.reason, "n_tokens": len(f.tokens),
                                  "prompt_len": f.prompt_len}
                         for u, f in finished.items()},
        })
        with open(args.json_out, "w") as f:
            json.dump(obs.encode_record(payload), f, indent=1)
    if tel is not None:
        tel.save(args.telemetry_out)
        print(f"[obs] telemetry bundle -> {args.telemetry_out} "
              f"({len(tel.tracer.spans())} spans)")
    return finished


if __name__ == "__main__":
    main()
