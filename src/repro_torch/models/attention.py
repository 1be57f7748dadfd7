"""Attention: GQA self-attention with a KV-cache decode.

Three implementations of the core softmax-attention compute, under the JAX
package's impl names:
  naive   - materialize (Sq, Sk) scores; smoke tests + oracle
  chunked - online softmax over KV chunks in plain torch; never
            materializes Sq x Sk (``build_model``'s default)
  pallas  - the hand-written Hopper flash kernels (``kernels/ops.py``;
            their plain versions on the CPU), differentiable through
            their own backward kernels

The MLA, cross-attention and paged/speculative decode paths of the JAX
package are not ported yet.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.models.common import apply_rope, dense_init

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


# ---------------------------------------------------------------------------
# core attention computations
# ---------------------------------------------------------------------------


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len=None):
    """Oracle attention. q:(B,Sq,H,hd) k,v:(B,Sk,K,hd).

    ``kv_len`` may be a scalar or a per-sequence (B,) tensor (ragged decode
    under continuous batching); rows must keep kv_len >= 1 to stay
    well-defined — a fully-masked row softmaxes to uniform, not zero.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    kv_idx = torch.arange(Sk, device=q.device)
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        q_idx = torch.arange(Sq, device=q.device) + q_offset
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


def _decode_positions(cache_len, B, device):
    """(B,1) rope positions from a scalar or per-sequence cache_len."""
    cl = torch.as_tensor(cache_len, device=device)
    if cl.dim() == 0:
        return cl.to(torch.int32).expand(B, 1)
    return cl.to(torch.int32)[:, None]


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
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k_new = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.pos_embedding == "rope":
        pos = _decode_positions(cache_len, B, x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
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
