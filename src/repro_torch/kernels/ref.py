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
