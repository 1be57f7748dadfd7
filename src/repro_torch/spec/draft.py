"""Draft sources: where the k cheap tokens per request come from.

Two implementations behind one protocol:

* :class:`NGramDraft` — self-drafting n-gram head. No extra model: it
  predicts the continuation from the longest-suffix match over the
  request's own token history (prompt + emitted). Proposals are
  deterministic (one-hot), so rejection sampling degenerates to the exact
  q(d) accept test. Near-zero draft cost; shines on repetitive output.

* :class:`ModelDraft` — a small-config registry model with its own KV
  cache, run autoregressively k steps ahead of the target through the
  port's contiguous decode step. Rollback mirrors the target engine's:
  accepted proposal KVs are kept (they were computed from the very tokens
  that got accepted), the rest is masked dead by cache_len bookkeeping and
  overwritten in place next round. Proposals are the draft's argmax, or
  with ``temperature > 0`` draws from its own temperature/top-k
  distribution, which the rejection test takes as p.

Draft sources are host-side engine components: slots, numpy token lists,
and explicit admit/commit/release lifecycle calls from the serve engine.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DraftSource(Protocol):
    """Engine-facing lifecycle + proposal interface."""

    def admit(self, slot: int, prompt_tokens: Sequence[int]) -> None:
        """A request was admitted to ``slot`` with this prompt."""

    def release(self, slot: int) -> None:
        """The slot was retired/preempted; drop its draft state."""

    def commit(self, slot: int, accepted: Sequence[int], extra: int) -> None:
        """A verify round emitted ``accepted + [extra]``: the accepted
        prefix of the last proposal plus one non-draft token (greedy
        argmax / residual resample / bonus). Roll back rejected proposal
        state and ingest ``extra``."""

    def propose(self, slots: Sequence[int], k: int):
        """Propose ``k`` draft tokens for each slot. Returns
        ``(drafts, probs)``: drafts (len(slots), k) int32; probs
        (len(slots), k, V) float proposal distributions, or None for
        deterministic (one-hot) proposals."""


class NGramDraft:
    """Longest-suffix n-gram predictor over each slot's own history.

    ``observe`` maintains, per slot, one table per context length n
    (1..max_n) mapping the n-gram tuple to the token that most recently
    followed it. ``propose`` extends the history virtually: each predicted
    token is fed back as context (with a local overlay so in-window
    transitions chain), which lets the head ride multi-token cycles —
    exactly the structure greedy decode of small models collapses into.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError("max_n must be >= 1")
        self.max_n = max_n
        self._hist: dict = {}
        self._tabs: dict = {}

    def admit(self, slot, prompt_tokens):
        self.release(slot)
        self._hist[slot] = []
        self._tabs[slot] = [dict() for _ in range(self.max_n)]
        self._observe(slot, prompt_tokens)

    def release(self, slot):
        self._hist.pop(slot, None)
        self._tabs.pop(slot, None)

    def commit(self, slot, accepted, extra):
        self._observe(slot, list(accepted) + [int(extra)])

    def _observe(self, slot, tokens):
        h = self._hist[slot]
        tabs = self._tabs[slot]
        for t in tokens:
            t = int(t)
            for n in range(1, self.max_n + 1):
                if len(h) >= n:
                    tabs[n - 1][tuple(h[-n:])] = t
            h.append(t)

    def propose(self, slots, k):
        out = np.zeros((len(slots), k), np.int32)
        for row, slot in enumerate(slots):
            seq = list(self._hist.get(slot, []))
            tabs = self._tabs.get(slot) or [dict() for _ in range(self.max_n)]
            local = [dict() for _ in range(self.max_n)]
            for j in range(k):
                tok = None
                for n in range(min(self.max_n, len(seq)), 0, -1):
                    key = tuple(seq[-n:])
                    tok = local[n - 1].get(key)
                    if tok is None:
                        tok = tabs[n - 1].get(key)
                    if tok is not None:
                        break
                if tok is None:  # cold start: repeat the last token
                    tok = seq[-1] if seq else 0
                for n in range(1, self.max_n + 1):
                    if len(seq) >= n:
                        local[n - 1][tuple(seq[-n:])] = tok
                seq.append(tok)
                out[row, j] = tok
        return out, None


class ModelDraft:
    """Small registry model running k steps ahead of the target.

    Keeps a contiguous KV cache of its own, synchronized with the engine's
    emitted history through the lifecycle calls: ``admit`` queues the
    prompt, ``commit`` rolls the draft cache back to the accepted prefix
    (the accepted proposals' KV is already correct — it was computed from
    those very tokens) and queues the one non-draft emission, ``propose``
    first catches up the queue one batched decode step at a time, then
    rolls the window forward. Rejected positions keep stale KV, masked dead
    by cache_len and overwritten next round — the same rollback-by-
    bookkeeping the target engine uses.

    With ``temperature > 0`` proposals are sampled from the draft's own
    temperature/top-k distribution (returned as the rejection test's p);
    greedy proposals are argmax with one-hot p (probs=None). The draft's
    next-token logits stay on its device: the argmax, or the distribution
    ``launch.sampling.sample_probs`` shapes, is computed there, and the
    draw is the reference's own numpy call on those float32 probs
    (``np.random.default_rng(seed).choice``), so the port's proposals are
    the reference's but where two cumulative sums straddle the uniform.
    """

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 cache_dtype=None, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0):
        from repro_torch.launch.steps import build_decode_step

        self.model = model
        self.params = params
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.vocab_size = int(model.cfg.vocab_size)
        self._step = build_decode_step(model, greedy=False)
        self._cache = model.init_cache(self.max_batch, self.max_seq,
                                       cache_dtype or torch.float32)
        self.cache_len = np.zeros(self.max_batch, np.int32)
        self._pending: dict = {}
        self._base: dict = {}
        self._next_logits = torch.zeros((self.max_batch, self.vocab_size),
                                        dtype=torch.float32,
                                        device=model.device)
        self._rng = np.random.default_rng(seed)

    def admit(self, slot, prompt_tokens):
        self.cache_len[slot] = 0
        self._pending[slot] = [int(t) for t in prompt_tokens]
        self._base.pop(slot, None)

    def release(self, slot):
        self.cache_len[slot] = 0
        self._pending.pop(slot, None)
        self._base.pop(slot, None)

    def commit(self, slot, accepted, extra):
        base = self._base.pop(slot, None)
        if base is not None:
            self.cache_len[slot] = base + len(accepted)
        self._pending.setdefault(slot, []).append(int(extra))

    def _advance(self, feed):
        """One batched decode step. ``feed``: {slot: token} — those slots
        consume their token and advance; every other row ingests a dummy at
        its frozen position (overwritten later, output discarded)."""
        toks = np.zeros((self.max_batch, 1), np.int32)
        for slot, tok in feed.items():
            toks[slot, 0] = tok
        dev = self.model.device
        _, logits, self._cache = self._step(
            self.params, self._cache, torch.as_tensor(toks, device=dev),
            torch.as_tensor(self.cache_len, device=dev))
        fed = torch.as_tensor(list(feed), device=dev)
        self._next_logits[fed] = logits[fed, -1, :].float()
        for slot in feed:
            self.cache_len[slot] += 1

    def _catch_up(self, slots):
        while True:
            feed = {s: self._pending[s].pop(0)
                    for s in slots if self._pending.get(s)}
            if not feed:
                return
            self._advance(feed)

    def _pick(self, slots):
        """Next proposal per slot from its current next-token logits.
        Returns (tokens {slot: tok}, probs (n, V) float32 or None)."""
        rows = self._next_logits[torch.as_tensor(slots,
                                                 device=self.model.device)]
        if self.temperature <= 0.0:
            toks = rows.argmax(-1).to(torch.int32).cpu().numpy()
            return dict(zip(slots, toks)), None
        from repro_torch.launch.sampling import sample_probs
        probs = sample_probs(rows, self.temperature, self.top_k).cpu().numpy()
        toks = np.array([self._rng.choice(self.vocab_size, p=p / p.sum())
                         for p in probs], np.int32)
        return dict(zip(slots, toks)), probs

    def propose(self, slots, k):
        slots = list(slots)
        self._catch_up(slots)
        for s in slots:
            self._base[s] = int(self.cache_len[s])
        drafts = np.zeros((len(slots), k), np.int32)
        probs = (np.zeros((len(slots), k, self.vocab_size), np.float32)
                 if self.temperature > 0.0 else None)
        for j in range(k):
            feed, p = self._pick(slots)
            for row, s in enumerate(slots):
                drafts[row, j] = feed[s]
                if probs is not None:
                    probs[row, j] = p[row]
            if j < k - 1:  # the last proposal is never ingested here
                self._advance(feed)
        return drafts, probs


def build_draft_source(name: str, *, target_cfg=None, max_batch: int = 1,
                       max_seq: int = 1024, temperature: float = 0.0,
                       top_k: int = 0, seed: int = 0, ngram_max_n: int = 3,
                       device="cuda") -> "DraftSource":
    """Resolve a ``--draft-source`` string: ``"ngram"`` or a registry arch
    name (built ``.reduced()`` with fresh params from ``seed`` — the serving
    examples run random weights throughout). A registry draft must share
    the target's vocab; anything else would propose unverifiable ids."""
    if name == "ngram":
        return NGramDraft(max_n=ngram_max_n)

    from repro_torch.configs import REGISTRY
    from repro_torch.models.registry import build_model

    if name not in REGISTRY:
        raise ValueError(f"unknown draft source {name!r}: expected 'ngram' "
                         f"or one of {sorted(REGISTRY)}")
    cfg = REGISTRY[name].reduced()
    if target_cfg is not None and cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft model {name!r} vocab {cfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}")
    model = build_model(cfg, impl="naive", device=device)
    params = model.init(model.generator(seed))
    return ModelDraft(model, params, max_batch=max_batch, max_seq=max_seq,
                      temperature=temperature, top_k=top_k, seed=seed)
