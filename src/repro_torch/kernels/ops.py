"""Dispatch wrappers that put the model's layouts onto the kernels.

The model code reaches these through ``impl="pallas"``, the impl name the
JAX package uses for its Pallas kernels; here it means the hand-written
Hopper kernels of ``kernels/flash_attention.py``, ``kernels/depthwise_conv.py``
and ``kernels/rmsnorm.py`` (their plain versions on the CPU).
"""
from __future__ import annotations

from repro_torch.kernels.depthwise_conv import depthwise_conv as _dw
from repro_torch.kernels.flash_attention import (flash_attention_mha, flash_decode,
                                                 flash_decode_paged,
                                                 flash_decode_spec,
                                                 flash_decode_spec_paged)
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm


def rmsnorm(x, scale, eps: float = 1e-5):
    """x: (..., d); scale: (d,). Differentiable (the backward is a kernel)."""
    return _rmsnorm(x, scale, eps=eps)


def depthwise_conv(x, w):
    """x: (B,H,W,C); w: (kh,kw,C); stride 1, SAME padding, odd kernel dims.
    Forward only, as in the reference: a backward through it raises."""
    return _dw(x, w)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Sk,K,hd) with K dividing H (GQA broadcast).

    The KV heads are broadcast to the H query heads before the kernel, so the
    MHA kernel never sees GQA. The broadcast is an expand and a reshape: its
    backward sums dk and dv over the G query heads of each group, as JAX's
    broadcast transpose does.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if K != H:
        G = H // K
        k = k[:, :, :, None, :].expand(B, Sk, K, G, hd).reshape(B, Sk, H, hd)
        v = v[:, :, :, None, :].expand(B, Sk, K, G, v.shape[-1]).reshape(
            B, Sk, H, v.shape[-1])
    out = flash_attention_mha(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              q_offset=q_offset)
    return out.transpose(1, 2)


def decode_attention(q, k, v, lengths):
    """Single-token GQA decode against a ragged KV cache, fused.

    q: (B, 1, H, hd) — the new token's queries (cache already updated).
    k,v: (B, Smax, K, hd) cache buffers; lengths: (B,) or scalar valid counts.

    The KV heads are NOT broadcast to H: the kernel's block holds the whole
    (G = H // K) query group, so each cache tile is read once per KV head.
    """
    B, _, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, K, H // K, hd)  # (B,1,H,hd) -> grouped, same head order
    out = flash_decode(qg, k, v, lengths)
    return out.reshape(B, 1, H, v.shape[-1])


def decode_attention_paged(q, k_pool, v_pool, block_table, lengths):
    """Single-token GQA decode against a paged (block-pooled) KV cache.

    q: (B, 1, H, hd); k_pool/v_pool: (num_blocks, block_size, K, hd[v])
    shared physical blocks; block_table: (B, T) int32; lengths: (B,) or
    scalar valid counts. Same grouped-query streaming as
    ``decode_attention``, with the kernel translating positions through the
    block table.
    """
    B, _, H, hd = q.shape
    K = k_pool.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    out = flash_decode_paged(qg, k_pool, v_pool, block_table, lengths)
    return out.reshape(B, 1, H, v_pool.shape[-1])


def decode_attention_spec(q, k, v, lengths):
    """Speculative multi-token GQA verify against a ragged KV cache, fused.

    q: (B, S, H, hd) — the S draft positions' queries (draft KVs already
    scattered at positions lengths[b]..lengths[b]+S-1). k,v: (B, Smax, K,
    hd[v]) cache buffers; lengths: (B,) or scalar BASE valid counts (before
    the drafts). Draft position qi attends cache positions
    < lengths[b] + qi + 1 — causal inside the verify block. One kernel call
    verifies all S positions; the keys of each KV head are split across
    blocks, and each block reads its range once for up to 24 of the S*G
    rows, so every position's bytes stream from device memory once per KV
    head while S*G fits one row block.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    # (B,S,H,hd) -> (B,K,S,G,hd): group the G heads sharing each KV head,
    # keeping draft order explicit so the kernel maps row r -> qi = r // G
    qg = q.reshape(B, S, K, H // K, hd).transpose(1, 2)
    out = flash_decode_spec(qg, k, v, lengths)
    return out.transpose(1, 2).reshape(B, S, H, v.shape[-1])


def decode_attention_spec_paged(q, k_pool, v_pool, block_table, lengths):
    """Speculative multi-token GQA verify against a paged KV cache.

    q: (B, S, H, hd); pools/table/lengths as in ``decode_attention_paged``,
    with ``lengths`` the BASE valid counts and the block table covering the
    draft positions (boundary blocks appended before the verify call).
    """
    B, S, H, hd = q.shape
    K = k_pool.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).transpose(1, 2)
    out = flash_decode_spec_paged(qg, k_pool, v_pool, block_table, lengths)
    return out.transpose(1, 2).reshape(B, S, H, v_pool.shape[-1])
