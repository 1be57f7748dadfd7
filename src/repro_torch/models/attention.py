"""Attention: GQA self-attention with a KV-cache decode.

Three implementations of the core softmax-attention compute, under the JAX
package's impl names:
  naive   - materialize (Sq, Sk) scores; smoke tests + oracle
  chunked - online softmax over KV chunks in plain torch; never
            materializes Sq x Sk (``build_model``'s default)
  pallas  - the hand-written Hopper flash kernels (``kernels/ops.py``;
            their plain versions on the CPU), differentiable through
            their own backward kernels

Decode runs over the contiguous (B, Smax, K, hd) cache or a paged
(num_blocks, block_size, K, hd) pool addressed through a (B, T) block table,
one token at a time or a speculative window of S at once. MLA (deepseek-v3)
keeps a latent cache ({"latent", "k_rope"}: (B, Smax, r|rd), or paged
(num_blocks, block_size, r|rd)) and decodes in the latent space, with the
absorbed query. The cross-attention path of the JAX package is not ported
yet.
"""
from __future__ import annotations

import math
import os
import warnings

import torch

from repro_torch.models.common import apply_norm, apply_rope, dense_init
from repro_torch.paging.paged_cache import gather_paged_kv

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def gqa_params(gen: torch.Generator, cfg, dtype=torch.float32):
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }


def mla_params(gen: torch.Generator, cfg, dtype=torch.float32):
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype),
        "q_norm": {"scale": torch.ones((cfg.q_lora_rank,), dtype=dtype, device=dev)},
        "wq_b": dense_init(gen, cfg.q_lora_rank, cfg.n_heads * qk_dim, dtype),
        "wkv_a": dense_init(gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                            dtype),
        "kv_norm": {"scale": torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=dev)},
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype),
        "wo": dense_init(gen, cfg.n_heads * cfg.v_head_dim, cfg.d_model, dtype),
    }


def attn_params(gen: torch.Generator, cfg, dtype=torch.float32):
    if cfg.use_mla:
        return mla_params(gen, cfg, dtype)
    return gqa_params(gen, cfg, dtype)


# ---------------------------------------------------------------------------
# core attention computations
# ---------------------------------------------------------------------------


def naive_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Oracle attention. q:(B,Sq,H,hd) k,v:(B,Sk,K,hd).

    ``kv_len`` may be a scalar or a per-sequence (B,) tensor (ragged decode
    under continuous batching); rows must keep kv_len >= 1 to stay
    well-defined — a fully-masked row softmaxes to uniform, not zero.
    ``q_offset`` may likewise be a (B,) tensor: query row qi of sequence b
    then attends positions <= q_offset[b] + qi (the speculative-verify
    oracle, where each sequence's draft window starts at its own cache_len).
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    kv_idx = torch.arange(Sk, device=q.device)
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal and isinstance(q_offset, torch.Tensor) and q_offset.dim() > 0:
        # per-sequence window starts: (B, Sq) query positions
        q_idx = torch.arange(Sq, device=q.device)[None] + \
            q_offset.to(q.device).long()[:, None]
        mask = mask & (kv_idx[None, None, :] <= q_idx[:, :, None])
    elif causal:
        q_idx = torch.arange(Sq, device=q.device) + int(q_offset)
        mask = mask & (kv_idx[None, :] <= q_idx[:, None])[None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() > 0:  # per-sequence lengths
            mask = mask & (kv_idx[None, None, :] < kv_len[:, None, None])
        else:
            mask = mask & (kv_idx < kv_len)[None, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      chunk: int = 1024):
    """Flash-style online-softmax attention over KV chunks, in plain torch.

    Never materializes the (Sq, Sk) score matrix; live memory is
    O(Sq * chunk). KV heads are broadcast to H inside each chunk.
    ``REPRO_ATTN_BF16=1`` feeds the dots bf16 inputs (f32 statistics and
    accumulator), as the JAX package's chunked path does.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // K
    chunk = min(chunk, Sk)
    lowp = os.environ.get("REPRO_ATTN_BF16", "0") == "1"

    def dot_in(t):  # bf16-rounded dot inputs, f32 products and sums
        return t.to(torch.bfloat16).float() if lowp else t.float()

    qh = dot_in(q.transpose(1, 2).float() / math.sqrt(hd))  # (B,H,Sq,hd)
    q_idx = torch.arange(Sq, device=q.device) + q_offset

    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, vd), device=q.device)
    for c0 in range(0, Sk, chunk):
        k_blk, v_blk = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        n = k_blk.shape[1]
        kh = dot_in(k_blk.transpose(1, 2).repeat_interleave(G, dim=1))
        vh = dot_in(v_blk.transpose(1, 2).repeat_interleave(G, dim=1))
        s = qh @ kh.transpose(-1, -2)                            # (B,H,Sq,n)
        if causal:
            kv_idx = c0 + torch.arange(n, device=q.device)
            s = torch.where(kv_idx[None, :] <= q_idx[:, None], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + dot_in(p) @ vh
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_impl(q, k, v, *, causal, q_offset: int = 0, impl: str = "chunked",
                   chunk: int = 1024):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 chunk=chunk)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    raise ValueError(impl)


# ---------------------------------------------------------------------------
# GQA block forward (train / prefill) and decode
# ---------------------------------------------------------------------------


def gqa_forward(p, x, cfg, *, positions=None, causal=True, impl="chunked",
                chunk=1024, return_kv=False):
    """Self-attention over x: (B,S,d). Returns y, and the layer's (k, v)
    cache entries of shape (B,S,K,hd) when ``return_kv``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if positions is not None and cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_impl(q, k, v, causal=causal, impl=impl, chunk=chunk)
    y = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def init_gqa_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cpu"):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_gqa_pool(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                  device="cpu"):
    """Paged layout: KV blocks shared by all sequences, no batch dim."""
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _window_positions(cache_len, B: int, S: int, device) -> torch.Tensor:
    """(B, S) virtual positions cache_len..cache_len+S-1 (int64)."""
    cl = torch.as_tensor(cache_len, device=device).long().expand(B)
    return cl[:, None] + torch.arange(S, device=device)[None]


def _qkv_window(p, x, cache_len, cfg):
    """q (B,S,H,hd) and the window's new k, v (B,S,K,hd), roped at
    positions cache_len + qi."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k_new = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v_new = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.pos_embedding == "rope":
        pos = _window_positions(cache_len, B, S, x.device).to(torch.int32)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    return q, k_new, v_new


def _scatter_token(buf, new, cache_len) -> None:
    """Write ``new`` (B,1,...) into ``buf`` (B,Smax,...) at seq position
    ``cache_len``, in place (the JAX package returns a new buffer and donates
    the old one).

    Scalar ``cache_len`` (lockstep decode) is clamped into [0, Smax-1] as
    JAX's dynamic_update_slice clamps its start. A per-sequence (B,)
    ``cache_len`` (continuous batching) skips rows whose position is outside
    the cache, as the JAX one-hot select matches nothing there: an idle
    serving slot retired at cache_len == max_seq still decodes, and its write
    must not land anywhere.
    """
    Smax = buf.shape[1]
    cl = torch.as_tensor(cache_len, device=buf.device)
    if cl.dim() == 0:
        pos = int(cl.clamp(0, Smax - 1))
        buf[:, pos] = new[:, 0].to(buf.dtype)
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    pos = cl.long().clamp(0, Smax - 1)
    keep = ((cl < 0) | (cl >= Smax)).reshape((-1,) + (1,) * (buf.ndim - 2))
    # an out-of-range row writes back what its clamped position holds
    buf[rows, pos] = torch.where(keep, buf[rows, pos], new[:, 0].to(buf.dtype))


def gqa_decode(p, x, cache, cache_len, cfg, *, impl: str = "naive"):
    """One-token decode. x: (B,1,d); cache k/v: (B,Smax,K,hd), updated in
    place and returned.

    ``cache_len``: scalar (all sequences in lockstep) or (B,) int tensor
    (ragged continuous batching). ``impl``: ``naive`` materializes the
    (H, Smax) score rows; ``pallas`` runs the single-query flash-decode
    kernel, which reads only the cache_len-valid KV tiles once per GQA group.
    """
    B = x.shape[0]
    hd = cfg.head_dim
    q, k_new, v_new = _qkv_window(p, x, cache_len, cfg)
    _scatter_token(cache["k"], k_new, cache_len)
    _scatter_token(cache["v"], v_new, cache_len)
    lengths = torch.as_tensor(cache_len, device=x.device) + 1
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, cache["k"], cache["v"], lengths)
    else:
        out = naive_attention(q, cache["k"], cache["v"], causal=False,
                              kv_len=lengths)
    y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# paged cache and speculative windows
# ---------------------------------------------------------------------------


def _pool_index(pool, pos, block_table):
    """(physical block, offset) of virtual positions ``pos`` (B, S), routed
    through each row's block-table row: the logical block is clipped to
    [0, T-1] and the physical one to [0, num_blocks-1], as the reference
    clips them."""
    bs = pool.shape[1]
    table = torch.as_tensor(block_table, device=pool.device).long()
    blk = (pos // bs).clamp(0, table.shape[1] - 1)
    phys = torch.gather(table, 1, blk).clamp(0, pool.shape[0] - 1)
    return phys, pos % bs


def _scatter_token_paged(pool, new, cache_len, block_table) -> None:
    """Write ``new`` (B,1,...) into a block pool (num_blocks, block_size, ...)
    at virtual position ``cache_len`` of each sequence, routed through its
    block-table row, in place. Idle serving slots' rows point at the null
    block, so their masked-garbage writes never touch a live sequence's
    cache."""
    _scatter_tokens_paged(pool, new, cache_len, block_table)


def _scatter_tokens(buf, new, cache_len) -> None:
    """Write ``new`` (B,S,...) into ``buf`` (B,Smax,...) at seq positions
    cache_len..cache_len+S-1 (the speculative draft window), in place.

    Scalar ``cache_len`` starts one slice, clamped into [0, Smax-S] as JAX's
    dynamic_update_slice clamps it. Per-sequence (B,) ``cache_len`` writes
    each row's positions that fall inside the cache and skips the rest, as
    the reference's masked gather does: an out-of-range entry rewrites what
    a position this call leaves alone already holds (cache_len-1, or Smax-1
    when the whole window is past the cache), so no two entries of the
    index write different values to one place.
    """
    B, S = new.shape[:2]
    Smax = buf.shape[1]
    cl = torch.as_tensor(cache_len, device=buf.device)
    if cl.dim() == 0:
        start = min(max(int(cl), 0), Smax - S)
        buf[:, start:start + S] = new.to(buf.dtype)
        return
    pos = _window_positions(cl, B, S, buf.device)
    inside = (pos >= 0) & (pos < Smax)
    spare = (cl.long() - 1).clamp(0, Smax - 1)[:, None].expand(B, S)
    pos = torch.where(inside, pos, spare)
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    keep = (~inside).reshape(inside.shape + (1,) * (buf.ndim - 2))
    buf[rows, pos] = torch.where(keep, buf[rows, pos], new.to(buf.dtype))


def _scatter_tokens_paged(pool, new, cache_len, block_table) -> None:
    """Write ``new`` (B,S,...) into a block pool at virtual positions
    cache_len..cache_len+S-1 of each sequence, in place, with one indexed
    write for the whole window.

    Idle slots' rows point at null block 0, so several entries may name the
    same null-block position; a CUDA index write with duplicate indices
    keeps an arbitrary one of their values. That is harmless only because
    the target is the null block, which no live sequence reads: a live
    row's window positions land in its own private blocks (the engine
    copies a shared block on write before the call).
    """
    B, S = new.shape[:2]
    pos = _window_positions(cache_len, B, S, pool.device)
    phys, off = _pool_index(pool, pos, block_table)
    pool[phys, off] = new.to(pool.dtype)


def _scatter_chunk_paged(pool, new, start: int, block_table) -> None:
    """Write one block-aligned chunk ``new`` (B, block_size, ...) into a
    block pool at virtual positions [start, start + block_size), routed
    through each sequence's block-table row, in place. ``start`` must be a
    multiple of block_size — the chunk grid *is* the block grid, which is
    what lets prefix-cache hits skip whole chunks exactly."""
    pos = torch.full((new.shape[0], 1), int(start), dtype=torch.long,
                     device=pool.device)
    phys, _ = _pool_index(pool, pos, block_table)
    pool[phys[:, 0]] = new.to(pool.dtype)


def gqa_prefill_paged(p, x, cache, start: int, block_table, cfg, *,
                      write: bool = True):
    """One chunk of paged prefill: ingest block_size prompt positions
    starting at ``start`` straight into the KV pools (in place), then attend
    causally over everything written so far (gathered through the block
    table).

    ``write=False`` is the full-prefix-hit path: every block is already
    populated (by the donor sequence that prefilled the identical prefix),
    so the chunk only *reads* the pools to recompute the last position's
    activations for logits — no pool mutation, shared blocks stay intact.

    Attention is the naive oracle over the gathered pool, as in the
    reference; no kernel runs here.
    """
    B, C, _ = x.shape
    q, k_new, v_new = _qkv_window(p, x, start, cfg)
    if write:
        _scatter_chunk_paged(cache["k"], k_new, start, block_table)
        _scatter_chunk_paged(cache["v"], v_new, start, block_table)
    out = naive_attention(q, gather_paged_kv(cache["k"], block_table),
                          gather_paged_kv(cache["v"], block_table),
                          causal=True, q_offset=int(start))
    y = out.reshape(B, C, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


def gqa_decode_paged(p, x, cache, cache_len, block_table, cfg, *,
                     impl: str = "naive"):
    """One-token GQA decode over a paged KV cache.

    cache: {"k","v"} pools of shape (num_blocks, block_size, K, hd) shared by
    every sequence, updated in place; ``block_table`` (B, T) int32 names
    each sequence's blocks. Math is identical to :func:`gqa_decode` on the
    contiguous cache the table describes: scatter the new token's KV at
    virtual position ``cache_len``, then attend over positions
    < cache_len + 1. ``naive`` gathers the contiguous view through the table
    (the oracle); ``pallas`` runs the paged flash-decode kernel.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv_window(p, x, cache_len, cfg)
    _scatter_token_paged(cache["k"], k_new, cache_len, block_table)
    _scatter_token_paged(cache["v"], v_new, cache_len, block_table)
    lengths = torch.as_tensor(cache_len, device=x.device) + 1
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention_paged(q, cache["k"], cache["v"],
                                          block_table, lengths)
    else:
        out = naive_attention(q, gather_paged_kv(cache["k"], block_table),
                              gather_paged_kv(cache["v"], block_table),
                              causal=False, kv_len=lengths)
    y = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


def gqa_decode_spec(p, x, cache, cache_len, cfg, *, impl: str = "naive"):
    """Speculative multi-token decode: verify S draft positions in one pass.

    x: (B,S,d) — the last accepted token followed by S-1 draft tokens, so
    position qi of the window sits at cache slot cache_len + qi. All S
    tokens' KV are written into the cache in place (rollback is the
    *caller's* cache_len bookkeeping: rejected tail KVs stay resident but
    are masked dead by every later call's length arguments), then each
    position attends causally inside the window on top of its sequence's
    history: positions < cache_len + qi + 1. Returns (B,S,d) activations.
    """
    B, S, _ = x.shape
    q, k_new, v_new = _qkv_window(p, x, cache_len, cfg)
    _scatter_tokens(cache["k"], k_new, cache_len)
    _scatter_tokens(cache["v"], v_new, cache_len)
    cl = torch.as_tensor(cache_len, device=x.device)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention_spec(q, cache["k"], cache["v"], cl)
    else:
        out = naive_attention(q, cache["k"], cache["v"], causal=True,
                              q_offset=cl)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


def gqa_decode_spec_paged(p, x, cache, cache_len, block_table, cfg, *,
                          impl: str = "naive"):
    """Speculative multi-token decode over a paged KV cache.

    Same verify-window math as :func:`gqa_decode_spec`; the S draft KVs are
    written through the block table (the engine appends boundary blocks
    for positions cache_len..cache_len+S-1 before the call), and rollback is
    again pure cache_len bookkeeping.
    """
    B, S, _ = x.shape
    q, k_new, v_new = _qkv_window(p, x, cache_len, cfg)
    _scatter_tokens_paged(cache["k"], k_new, cache_len, block_table)
    _scatter_tokens_paged(cache["v"], v_new, cache_len, block_table)
    cl = torch.as_tensor(cache_len, device=x.device)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention_spec_paged(q, cache["k"], cache["v"],
                                               block_table, cl)
    else:
        out = naive_attention(q, gather_paged_kv(cache["k"], block_table),
                              gather_paged_kv(cache["v"], block_table),
                              causal=True, q_offset=cl)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): latent KV cache; decode uses the absorbed form
# ---------------------------------------------------------------------------

_MLA_PALLAS_WARNED = False  # one-time impl-fallback warning (mla_forward)


def _mla_qkv(p, x, cfg, positions):
    """q_nope (B,S,H,nope), q_rope (B,S,H,rd) roped, the normalised latent
    (B,S,r) and k_rope (B,S,rd) roped."""
    B, S, _ = x.shape
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm") @ p["wq_b"]
    q = q.reshape(B, S, cfg.n_heads, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    kv_a = x @ p["wkv_a"]
    latent = apply_norm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank], "rmsnorm")
    k_rope = kv_a[..., cfg.kv_lora_rank:].reshape(B, S, 1, rope_d)
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope[..., 0, :]


def _mla_heads(q_nope, q_rope, latent, k_rope, wkv_b, cfg):
    """Per-head q (B,Sq,H,nope+rd), k (B,S,H,nope+rd) and v (B,S,H,v) from
    the latents, the ``latent @ wkv_b`` expansion the prefill paths share."""
    B, S = latent.shape[:2]
    nope, v_dim = cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = (latent @ wkv_b).reshape(B, S, cfg.n_heads, nope + v_dim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, cfg.n_heads, k_rope.shape[-1]).to(k_nope.dtype)], -1)
    return torch.cat([q_nope, q_rope], -1), k, v


def mla_forward(p, x, cfg, *, positions, impl="chunked", chunk=1024,
                return_cache=False):
    """MLA self-attention over x: (B,S,d). Returns y, and the layer's
    {"latent", "k_rope"} cache entries (B,S,r|rd) when ``return_cache``.

    Under ``impl="pallas"`` the flash forward cannot run (it takes one head
    dim for q, k and v, and MLA's qk dim nope + rope differs from v_dim), so
    prefill and training take the chunked online-softmax path, with the
    reference's one-time ``RuntimeWarning``. Decode has its own latent-space
    kernel (``mla_decode``).
    """
    B, S, _ = x.shape
    nope, v_dim = cfg.qk_nope_head_dim, cfg.v_head_dim
    if impl == "pallas" and nope + cfg.qk_rope_head_dim != v_dim:
        global _MLA_PALLAS_WARNED
        if not _MLA_PALLAS_WARNED:
            _MLA_PALLAS_WARNED = True
            warnings.warn(
                f"MLA prefill cannot use impl='pallas' (qk head dim "
                f"{nope + cfg.qk_rope_head_dim} != v head dim {v_dim}); "
                f"falling back to 'chunked'. Decode still uses the fused "
                f"latent-space kernel.", RuntimeWarning, stacklevel=2)
        impl = "chunked"
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, positions)
    q, k, v = _mla_heads(q_nope, q_rope, latent, k_rope, p["wkv_b"], cfg)
    out = attention_impl(q, k, v, causal=True, impl=impl, chunk=chunk)
    y = out.reshape(B, S, cfg.n_heads * v_dim) @ p["wo"]
    if return_cache:
        return y, {"latent": latent, "k_rope": k_rope}
    return y


def init_mla_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cpu"):
    return {"latent": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                                  device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype,
                                  device=device)}


def init_mla_pool(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                  device="cpu"):
    return {"latent": torch.zeros((num_blocks, block_size, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((num_blocks, block_size, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_naive_latent_ctx(q_lat, q_rope, lat, kr, kv_len, scale):
    """Latent-space attention oracle shared by the contiguous and paged
    decode paths: scores = q_lat . latent + q_rope . k_rope, values = latent.
    Returns the (B, 1, H, r) f32 context."""
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), lat.float())
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())) * scale
    kv_idx = torch.arange(lat.shape[1], device=lat.device)
    kv_len = torch.as_tensor(kv_len, device=lat.device)
    if kv_len.dim() > 0:  # ragged continuous batch
        valid = (kv_idx[None] < kv_len[:, None])[:, None, None]
    else:
        valid = (kv_idx < kv_len)[None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bsr->bqhr", probs, lat.float())


def _mla_absorbed_q(p, q_nope, cfg):
    """Absorb W_UK into the query; returns (q_lat (B,1,H,r) f32, w_uv)."""
    nope, v_dim = cfg.qk_nope_head_dim, cfg.v_head_dim
    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, cfg.n_heads, nope + v_dim)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
    return q_lat, w_uv


def _mla_out(p, ctx, w_uv, x, cfg):
    """(ctx (B,1,H,r) . W_UV) -> wo, in x's dtype."""
    B = x.shape[0]
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.float()).to(x.dtype)
    return out.reshape(B, 1, cfg.n_heads * cfg.v_head_dim) @ p["wo"]


def mla_decode(p, x, cache, cache_len, cfg, *, impl: str = "naive"):
    """Absorbed-matrix MLA decode: attention runs in the latent space.

    scores = q_nope . W_UK^T . latent  +  q_rope . k_rope
    out    = (probs . latent) . W_UV -> wo
    x: (B,1,d); cache {"latent" (B,Smax,r), "k_rope" (B,Smax,rd)}, updated
    in place and returned. ``cache_len`` scalar or (B,); ``impl="pallas"``
    runs the latent-space decode kernel (``flash_decode_mla``).
    """
    B = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    pos = _window_positions(cache_len, B, 1, x.device).to(torch.int32)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, x, cfg, pos)
    _scatter_token(cache["latent"], latent_new, cache_len)
    _scatter_token(cache["k_rope"], k_rope_new, cache_len)
    q_lat, w_uv = _mla_absorbed_q(p, q_nope, cfg)
    lengths = torch.as_tensor(cache_len, device=x.device) + 1
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        ctx = kops.decode_attention_mla(q_lat, q_rope.float(), cache["latent"],
                                        cache["k_rope"], lengths, scale=scale)
    else:
        ctx = _mla_naive_latent_ctx(q_lat, q_rope, cache["latent"], cache["k_rope"],
                                    lengths, scale)
    return _mla_out(p, ctx, w_uv, x, cfg), cache


def mla_decode_paged(p, x, cache, cache_len, block_table, cfg, *,
                     impl: str = "naive"):
    """Absorbed-matrix MLA decode over paged latent pools.

    cache: {"latent": (num_blocks, block_size, r), "k_rope": (num_blocks,
    block_size, rd)} shared physical blocks, updated in place;
    ``block_table`` (B, T) int. Same latent-space math as :func:`mla_decode`,
    with the per-sequence cache reached through the table (gathered for
    ``naive``, read through it by the kernel for ``pallas``).
    """
    B = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    pos = _window_positions(cache_len, B, 1, x.device).to(torch.int32)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, x, cfg, pos)
    _scatter_token_paged(cache["latent"], latent_new, cache_len, block_table)
    _scatter_token_paged(cache["k_rope"], k_rope_new, cache_len, block_table)
    q_lat, w_uv = _mla_absorbed_q(p, q_nope, cfg)
    lengths = torch.as_tensor(cache_len, device=x.device) + 1
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        ctx = kops.decode_attention_mla_paged(q_lat, q_rope.float(), cache["latent"],
                                              cache["k_rope"], block_table, lengths,
                                              scale=scale)
    else:
        ctx = _mla_naive_latent_ctx(q_lat, q_rope,
                                    gather_paged_kv(cache["latent"], block_table),
                                    gather_paged_kv(cache["k_rope"], block_table),
                                    lengths, scale)
    return _mla_out(p, ctx, w_uv, x, cfg), cache


def mla_prefill_paged(p, x, cache, start: int, block_table, cfg, *,
                      write: bool = True):
    """One chunk of paged MLA prefill over latent pools.

    Ingests the chunk's normalised latent and rope key into the pools (in
    place), then reconstructs per-head K/V from the gathered latents (the
    same ``latent @ wkv_b`` expansion :func:`mla_forward` uses, in f32 as
    the reference computes it here) and attends causally with ``q_offset``
    ``start``. ``write=False``, as in :func:`gqa_prefill_paged`: a read-only
    recompute on a full prefix hit.
    """
    B, C, _ = x.shape
    pos = (int(start) + torch.arange(C, dtype=torch.int32, device=x.device))
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, x, cfg, pos[None].expand(B, C))
    if write:
        _scatter_chunk_paged(cache["latent"], latent_new, start, block_table)
        _scatter_chunk_paged(cache["k_rope"], k_rope_new, start, block_table)
    lat = gather_paged_kv(cache["latent"], block_table).float()
    kr = gather_paged_kv(cache["k_rope"], block_table).float()
    q, k, v = _mla_heads(q_nope, q_rope, lat, kr, p["wkv_b"].float(), cfg)
    out = naive_attention(q, k, v, causal=True, q_offset=int(start))
    y = out.reshape(B, C, cfg.n_heads * cfg.v_head_dim) @ p["wo"]
    return y, cache
