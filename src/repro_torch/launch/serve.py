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
    whose position is past the cache, and the flash-decode kernel clamps
    its length to the cache.

``--attn-impl pallas`` routes prefill attention through the flash forward
kernel and decode attention through the flash-decode kernel (their plain
versions on the CPU); ``auto`` consults ``kernels/backend.auto_decode_impl``.

Ported so far: the contiguous layout with greedy decode under FIFO
serialize admission. Sampling, the paged layout and prefix sharing,
speculative decoding, shed/deadlines/drain/``hold_blocks``, the ``set_*``
rung knobs and telemetry spans are not ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 8 --attn-impl pallas
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

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.kernels.backend import auto_decode_impl, resolve_device
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models.registry import build_model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32 prompt tokens
    max_new_tokens: int


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: List[int]  # generated token ids (first comes from prefill logits)
    reason: str  # "eos" | "length"
    prompt_len: int


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a model's KV-cache decode path."""

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 eos_id: Optional[int] = None, cache_dtype=torch.float32,
                 bucket_prompts: bool = False):
        if model.cfg.family != "dense":
            raise ValueError(f"continuous batching is ported for the dense "
                             f"family, got {model.cfg.family!r}")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.bucket_prompts = bucket_prompts

        self.cache_len = np.zeros(max_batch, np.int32)
        self.tokens = np.zeros((max_batch, 1), np.int32)
        self.slot_uid: List[Optional[int]] = [None] * max_batch
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.generated: List[List[int]] = [[] for _ in range(max_batch)]

        self.queue: Deque[Request] = collections.deque()
        self.finished: Dict[int, Finished] = {}
        self.decode_steps = 0
        self.tokens_out = 0
        self._active_slot_steps = 0
        self._uid_prompt_len: Dict[int, int] = {}
        self.prefill_lengths: Dict[int, int] = {}  # padded length -> count

        self.cache = model.init_cache(max_batch, max_seq, cache_dtype)
        self._prefill = build_prefill_step(model)
        self._decode = build_decode_step(model)

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"prompt {req.uid} ({len(req.prompt)} tokens) "
                             f"does not fit max_seq={self.max_seq}")
        self.queue.append(req)

    def _prefill_len(self, P: int) -> int:
        """Admission prefill length: the true prompt length, rounded up to the
        next power of two under ``bucket_prompts``, capped at max_seq."""
        L = P
        if self.bucket_prompts:
            L = 1 << (max(L, 1) - 1).bit_length()
        return min(L, self.max_seq)

    def _admit(self, slot: int, req: Request) -> None:
        P = len(req.prompt)
        Lp = self._prefill_len(P)
        self.prefill_lengths[Lp] = self.prefill_lengths.get(Lp, 0) + 1
        tokens = np.pad(np.asarray(req.prompt, np.int32), (0, Lp - P))
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)[None]}
        if Lp != P:
            # causal attention keeps every position < P unaffected by the
            # right-padding; logits must come from the true last token
            batch["last_pos"] = P - 1
        logits, pcache = self._prefill(self.params, batch)
        for name, buf in self.cache.items():  # in-place splice into the slot
            buf[:, slot:slot + 1, :Lp] = pcache[name].to(buf.dtype)
        first = int(logits[0, -1].argmax())
        self.slot_uid[slot] = req.uid
        self.slot_budget[slot] = req.max_new_tokens
        self.cache_len[slot] = P
        self.tokens[slot, 0] = first
        self.generated[slot] = [first]
        self._uid_prompt_len[req.uid] = P
        self.tokens_out += 1
        if self._should_retire(slot, first):  # budget of 1, or prefill hit EOS
            self._retire(slot, "eos" if first == self.eos_id else "length")

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
        # cache_len stays frozen (it may equal max_seq): the stale KV keeps
        # idle-slot math well-defined and is overwritten by the next
        # admission's splice

    def _admit_waiting(self) -> None:
        """FIFO serialize admission: each free slot, in order, takes the head
        of the queue."""
        for slot in range(self.max_batch):
            if not self.queue:
                return
            if self.slot_uid[slot] is None:
                self._admit(slot, self.queue.popleft())

    # -- stepping ----------------------------------------------------------

    def step(self) -> List[Tuple[int, int]]:
        """Admit waiting requests, run one batched decode, retire finishers.

        Returns (uid, token) pairs emitted this step.
        """
        self._admit_waiting()
        active = [s for s in range(self.max_batch) if self.slot_uid[s] is not None]
        if not active:
            return []
        next_tok, _, self.cache = self._decode(
            self.params, self.cache,
            torch.as_tensor(self.tokens, device=self.device),
            torch.as_tensor(self.cache_len, device=self.device))
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
            if self._should_retire(slot, tok):
                self._retire(slot, "eos" if (self.eos_id is not None and
                                             tok == self.eos_id) else "length")
        return emitted

    def run(self, requests: List[Request]) -> Dict[int, Finished]:
        for req in requests:
            self.submit(req)
        while self.has_work:
            self.step()
        return self.finished

    @property
    def has_work(self) -> bool:
        """True while anything is queued or resident."""
        return bool(self.queue) or any(u is not None for u in self.slot_uid)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots active per decode step (batching efficiency)."""
        if not self.decode_steps:
            return 0.0
        return self._active_slot_steps / (self.decode_steps * self.max_batch)

    def kv_bytes(self) -> int:
        """KV-cache bytes: the whole (L, max_batch, max_seq, ...) slab."""
        return sum(a.numel() * a.element_size() for a in self.cache.values())

    def stats(self) -> Dict:
        """Engine-level stats and the flash kernels' launch counts so far in
        this process (``kernels/flash_attention.launches``)."""
        return {
            "decode_steps": self.decode_steps,
            "tokens_out": self.tokens_out,
            "occupancy": round(self.occupancy, 4),
            "kv_layout": "contig",
            "prefill_buckets": {str(k): v for k, v in
                                sorted(self.prefill_lengths.items())},
            "kv_bytes": self.kv_bytes(),
            "admission_policy": "serialize",
            "kernel_launches": dict(flash_attention.launches),
        }


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
    ap.add_argument("--bucket-prompts", action="store_true",
                    help="round admission prefill lengths up to power-of-two "
                         "buckets")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
    engine = ContinuousBatchingEngine(
        model, params, max_batch=args.batch, max_seq=max_seq,
        eos_id=args.eos_id, bucket_prompts=args.bucket_prompts)
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tok_s = engine.tokens_out / max(dt, 1e-9)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} mode=continuous impl={impl} kv=contig "
          f"device={dev_name} slots={args.batch} requests={n_req} "
          f"tokens={engine.tokens_out} steps={engine.decode_steps} "
          f"occupancy={engine.occupancy:.2f} wall={dt*1e3:.0f}ms "
          f"({tok_s:.1f} tok/s) launches={dict(flash_attention.launches)}")
    sample = finished[0].tokens[:12] if 0 in finished else []
    print("sample uid=0:", sample)
    if args.json_out:
        payload = {
            "arch": cfg.name, "impl": impl, "device": dev_name,
            "slots": args.batch, "requests": n_req,
            "tokens": engine.tokens_out, "steps": engine.decode_steps,
            "occupancy": round(engine.occupancy, 4), "wall_s": dt,
            "tok_s": tok_s, "stats": engine.stats(),
            "finished": {str(u): {"reason": f.reason, "n_tokens": len(f.tokens),
                                  "prompt_len": f.prompt_len}
                         for u, f in finished.items()},
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
    return finished


if __name__ == "__main__":
    main()
