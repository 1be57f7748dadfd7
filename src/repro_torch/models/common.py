"""Shared layer primitives (plain PyTorch, functional params-as-dicts).

Weights keep the JAX package's layout: a projection is ``x @ W`` with ``W``
of shape (d_in, d_out).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None):
    """N(0, 1) * scale with scale = 1/sqrt(d_in) by default, as the JAX
    package draws it (the numbers differ: the generators differ)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * s).to(dtype)


def norm_params(cfg, dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * p["scale"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(x.dtype)


def activate(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp_params(gen: torch.Generator, cfg, d_ff: Optional[int] = None,
               dtype=torch.float32):
    ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, cfg.d_model, ff, dtype),
         "w_down": dense_init(gen, ff, cfg.d_model, dtype)}
    if cfg.activation != "relu2":  # gated (SwiGLU / GeGLU)
        p["w_gate"] = dense_init(gen, cfg.d_model, ff, dtype)
    return p


def apply_mlp(p, x, activation: str):
    h = activate(x @ p.get("w_gate", p["w_up"]), activation)
    if "w_gate" in p:
        h = h * (x @ p["w_up"])
    return h @ p["w_down"]


# --- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) rotated by split halves; positions: (..., S).
    Angles are computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(embed, tokens):
    return F.embedding(tokens, embed)


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE in f32; labels == -1 are ignored."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    nll = logz - gold
    valid = (labels >= 0) if mask is None else mask & (labels >= 0)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)
