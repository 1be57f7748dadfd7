"""Dispatch wrappers that put the model's layouts onto the kernels.

The model code reaches these through ``impl="pallas"``, the impl name the
JAX package uses for its Pallas kernels; here it means the hand-written
Hopper kernels of ``kernels/flash_attention.py`` (their plain versions on
the CPU).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_mha, flash_decode


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Sk,K,hd) with K dividing H (GQA broadcast).

    The KV heads are broadcast to the H query heads before the kernel, so the
    MHA kernel never sees GQA.
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
