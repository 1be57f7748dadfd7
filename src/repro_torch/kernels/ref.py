"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, written step by step
in torch. The kernel wrappers run these for tensors on the CPU; the tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.paging.paged_cache import gather_paged_kv

NEG_INF = -1e30  # mask value of the JAX kernels (not -inf)


def _dot_inputs(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """f32 operand of a kernel dot; ``lowp`` rounds it to bf16 first."""
    x = x.float()
    return x.to(torch.bfloat16).float() if lowp else x


def ref_flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0,
                            lowp: bool = False):
    """q: (B,H,Sq,hd); k,v: (B,H,Sk,hd) -> (o (B,H,Sq,hd) in q's dtype,
    lse (B,H,Sq) f32 with lse = m + log l).

    Masked scores take ``NEG_INF``; ``l`` is clamped at 1e-30 as in
    ``repro/kernels/flash_attention.py::_fwd_kernel``.
    """
    hd = q.shape[-1]
    Sq, Sk = q.shape[2], k.shape[2]
    qs = _dot_inputs(q.float() * (1.0 / math.sqrt(hd)), lowp)
    s = qs @ _dot_inputs(k, lowp).transpose(-1, -2)  # (B,H,Sq,Sk) f32
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kj <= qi, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (_dot_inputs(p, lowp) @ _dot_inputs(v, lowp)) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _bwd_terms(q, k, v, do, lse, delta, causal: bool, q_offset: int,
               lowp: bool):
    """The shared part of the backward kernels: the dot inputs (bf16-rounded
    under ``lowp``), p = exp(scale * q k^T - lse) with masked entries 0, and
    ds = p * (do v^T - delta), all f32."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    Sq, Sk = q.shape[2], k.shape[2]
    qc, kc, vc, doc = (_dot_inputs(t, lowp) for t in (q, k, v, do))
    s = scale * (qc @ kc.transpose(-1, -2))                       # (B,H,Sq,Sk)
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(Sk, device=q.device)[None, :]
        p = torch.where(kj <= qi, p, torch.zeros_like(p))
    dp = doc @ vc.transpose(-1, -2)
    ds = p * (dp - delta.float()[..., None])
    return scale, qc, kc, doc, p, ds


def ref_flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                     q_offset: int = 0, lowp: bool = False):
    """dq (B,H,Sq,hd) f32 = scale * ds k, as ``_dq_kernel`` computes it."""
    scale, _, kc, _, _, ds = _bwd_terms(q, k, v, do, lse, delta, causal,
                                        q_offset, lowp)
    return scale * (_dot_inputs(ds, lowp) @ kc)


def ref_flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                      q_offset: int = 0, lowp: bool = False):
    """(dk, dv) (B,H,Sk,hd) f32: dk = scale * ds^T q and dv = p^T do, as
    ``_dkv_kernel`` computes them (p and ds rounded to bf16 under ``lowp``)."""
    scale, qc, _, doc, p, ds = _bwd_terms(q, k, v, do, lse, delta, causal,
                                          q_offset, lowp)
    dk = scale * (_dot_inputs(ds, lowp).transpose(-1, -2) @ qc)
    dv = _dot_inputs(p, lowp).transpose(-1, -2) @ doc
    return dk, dv


def ref_flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0, lowp: bool = False):
    """(dq, dk, dv) f32 of flash attention, step by step.

    q, o, do: (B,H,Sq,hd); k, v: (B,H,Sk,hd); lse: (B,H,Sq) f32, the
    forward's log-sum-exp rows. With delta = rowsum(do * o) (the reference
    wrapper ``_bwd_call`` computes it in f32 outside the kernels):

      p  = exp(scale * q k^T - lse), 0 where masked
      ds = p * (do v^T - delta)
      dq = scale * ds k;  dk = scale * ds^T q;  dv = p^T do
    """
    delta = (do.float() * o.float()).sum(-1)
    scale, qc, kc, doc, p, ds = _bwd_terms(q, k, v, do, lse, delta, causal,
                                           q_offset, lowp)
    dsc = _dot_inputs(ds, lowp)
    dq = scale * (dsc @ kc)
    dk = scale * (dsc.transpose(-1, -2) @ qc)
    dv = _dot_inputs(p, lowp).transpose(-1, -2) @ doc
    return dq, dk, dv


def ref_flash_decode(q, k, v, lengths, *, scale: Optional[float] = None,
                     lowp: bool = False):
    """Single-query decode over a ragged cache.

    q: (B,K,G,hd); k: (B,Smax,K,hd); v: (B,Smax,K,hdv); lengths: (B,) int.
    Row b attends positions < min(lengths[b], Smax); a row of length 0
    returns zeros. Returns (B,K,G,hdv) in q's dtype.
    """
    B, K, G, hd = q.shape
    Smax = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int64)
    lengths = lengths.expand(B).clamp(0, Smax)
    qs = _dot_inputs(q.float() * scale, lowp)                      # (B,K,G,hd)
    kt = _dot_inputs(k, lowp).permute(0, 2, 3, 1)                  # (B,K,hd,S)
    s = qs @ kt                                                    # (B,K,G,S)
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]                 # (B,1,1,S)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    # explicit zeros past the length: a length-0 row then sums to l = 0 and
    # returns 0 / 1e-30 = 0, as the kernel's never-visited tiles do
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (_dot_inputs(p, lowp) @ _dot_inputs(v, lowp).transpose(1, 2)) / l
    return out.to(q.dtype)


def ref_flash_decode_paged(q, k_pool, v_pool, block_table, lengths, *,
                           scale: Optional[float] = None, lowp: bool = False):
    """Single-query decode over a paged cache: the contiguous view the
    (clipped) block table describes, then ``ref_flash_decode``.

    q: (B,K,G,hd); pools: (NB,bs,K,hd[v]); block_table: (B,T) int;
    lengths: (B,) int, clamped to T*bs. Returns (B,K,G,hdv).
    """
    return ref_flash_decode(q, gather_paged_kv(k_pool, block_table),
                            gather_paged_kv(v_pool, block_table), lengths,
                            scale=scale, lowp=lowp)


def ref_flash_decode_spec(q, k, v, lengths, *, scale: Optional[float] = None,
                          lowp: bool = False):
    """Speculative verify of S draft positions over a contiguous cache.

    q: (B,K,S,G,hd); k: (B,Smax,K,hd); v: (B,Smax,K,hdv); lengths: (B,) int
    BASE counts. Draft row qi of sequence b attends positions
    < min(lengths[b] + qi + 1, Smax), masked with ``NEG_INF`` and with
    explicit zeros past the mask. Returns (B,K,S,G,hdv) in q's dtype.
    """
    B, K, S, G, hd = q.shape
    Smax = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    base = torch.as_tensor(lengths, device=q.device).to(torch.int64).expand(B)
    qs = _dot_inputs(q.float() * scale, lowp).reshape(B, K, S * G, hd)
    s = qs @ _dot_inputs(k, lowp).permute(0, 2, 3, 1)              # (B,K,SG,Smax)
    limit = base[:, None] + torch.arange(S, device=q.device)[None] + 1  # (B,S)
    limit = limit[:, :, None].expand(B, S, G).reshape(B, 1, S * G, 1)
    valid = torch.arange(Smax, device=q.device) < limit            # (B,1,SG,Smax)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (_dot_inputs(p, lowp) @ _dot_inputs(v, lowp).transpose(1, 2)) / l
    return out.reshape(B, K, S, G, v.shape[-1]).to(q.dtype)


def ref_flash_decode_spec_paged(q, k_pool, v_pool, block_table, lengths, *,
                                scale: Optional[float] = None,
                                lowp: bool = False):
    """``ref_flash_decode_spec`` over the contiguous view a (clipped) block
    table describes: q (B,K,S,G,hd), pools (NB,bs,K,hd[v]), table (B,T),
    BASE lengths (B,). Returns (B,K,S,G,hdv)."""
    return ref_flash_decode_spec(q, gather_paged_kv(k_pool, block_table),
                                 gather_paged_kv(v_pool, block_table), lengths,
                                 scale=scale, lowp=lowp)


def ref_flash_decode_mla(q_lat, q_rope, latent, k_rope, lengths, *, scale: float,
                         lowp: bool = False):
    """MLA decode in the latent space over contiguous caches, as the
    reference's ``ops.decode_attention_mla`` computes it: keys the
    concatenation [latent | k_rope] (a copy of the cache), values the
    latent, one KV head for all H query rows, then ``ref_flash_decode``.

    q_lat: (B,H,r); q_rope: (B,H,rd); latent: (B,Smax,r); k_rope:
    (B,Smax,rd); lengths: (B,) int. Returns (B,H,r) in q_lat's dtype.
    """
    q = torch.cat([q_lat, q_rope.to(q_lat.dtype)], -1)[:, None]   # (B,1,H,r+rd)
    kv = torch.cat([latent, k_rope.to(latent.dtype)], -1)[:, :, None]
    return ref_flash_decode(q, kv, latent[:, :, None], lengths, scale=scale,
                            lowp=lowp)[:, 0]


def ref_flash_decode_mla_paged(q_lat, q_rope, latent_pool, k_rope_pool,
                               block_table, lengths, *, scale: float,
                               lowp: bool = False):
    """``ref_flash_decode_mla`` over the contiguous caches a (clipped) block
    table describes: pools (NB,bs,r) and (NB,bs,rd), table (B,T)."""
    return ref_flash_decode_mla(q_lat, q_rope,
                                gather_paged_kv(latent_pool, block_table),
                                gather_paged_kv(k_rope_pool, block_table),
                                lengths, scale=scale, lowp=lowp)


def ref_rmsnorm(x, scale, eps: float = 1e-5):
    """x: (..., d); scale: (d,). ``x * rsqrt(mean(x^2) + eps) * scale`` with
    the statistic in f32, returned in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def ref_rmsnorm_bwd(x, scale, g, eps: float = 1e-5):
    """(dx in x's dtype, dscale in scale's dtype) of ``ref_rmsnorm`` for the
    output cotangent ``g``, from the formulas of the reference's backward
    kernel (``src/repro/kernels/rmsnorm.py``): with
    ``r = rsqrt(mean(x^2) + eps)`` and ``gs = g * scale``, all in f32,

      dx     = r * gs - x * r^3 * mean(gs * x)
      dscale = sum over rows of g * x * r
    """
    xf, sf, gf = x.float(), scale.float(), g.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    gs = gf * sf
    dot = (gs * xf).mean(-1, keepdim=True)
    dx = r * gs - xf * (r * r * r) * dot
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def ref_depthwise_conv(x, w):
    """x: (B,H,W,C); w: (kh,kw,C) with odd kh and kw; stride 1, SAME
    padding. Returns (B,H,W,C) in x's dtype.

    Tap by tap, as the kernel sums: the input zero-padded by (kh-1)/2 rows
    and (kw-1)/2 columns on each side, then for each tap (a, c) in row-major
    order ``acc += x[h+a-ph, w+c-pw] * w[a, c]`` in f32.
    """
    B, H, W, C = x.shape
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph))
    wf = w.float()
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for a in range(kh):
        for c in range(kw):
            acc = acc + xp[:, a:a + H, c:c + W, :] * wf[a, c]
    return acc.to(x.dtype)
