"""Gradient/update compression with error feedback (the JAX package's
``optim/compression.py``).

Two composable schemes; the residual of what compression dropped is carried
into the next round, preserving convergence:

  int8 quantization  - per-tensor symmetric scale; 4x over fp32
  top-k sparsify     - keep the k largest-magnitude entries per tensor
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tree import tree_map


def quantize_int8(x):
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q, scale):
    return q.float() * scale


def topk_sparsify(x, frac: float):
    """Keep the int(frac*n) (at least 1) largest-|.| entries; returns
    (values, indices)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_densify(values, idx, shape):
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=values.dtype, device=values.device)
    out[idx] = values
    return out.reshape(shape)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """scheme: none | int8 | topk:<frac> | int8+topk:<frac>"""
    scheme: str = "none"

    @property
    def topk_frac(self) -> Optional[float]:
        for part in self.scheme.split("+"):
            if part.startswith("topk:"):
                return float(part.split(":")[1])
        return None

    @property
    def use_int8(self) -> bool:
        return "int8" in self.scheme

    def ratio(self) -> float:
        """Compressed bytes / fp32 bytes (for the collective roofline term)."""
        r = 1.0
        if self.topk_frac is not None:
            r *= self.topk_frac * 2  # values + int32 indices
        if self.use_int8:
            r *= 0.25 if self.topk_frac is None else 0.625  # idx stays int32
        return min(r, 1.0)

    def init_error(self, grads):
        if self.scheme == "none":
            return ()
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    @torch.no_grad()
    def roundtrip(self, grads, error):
        """Returns (decompressed grads as seen by the receiver, new error)."""
        if self.scheme == "none":
            return grads, error

        frac = self.topk_frac

        def one(g, e):
            gf = g.float() + e
            if frac is not None:
                vals, idx = topk_sparsify(gf, frac)
                if self.use_int8:
                    q, s = quantize_int8(vals)
                    vals = dequantize_int8(q, s)
                dec = topk_densify(vals, idx, gf.shape)
            else:
                q, s = quantize_int8(gf)
                dec = dequantize_int8(q, s)
            return dec.to(g.dtype), gf - dec

        pairs = tree_map(one, grads, error)
        dec = tree_map(lambda g, pair: pair[0], grads, pairs)
        err = tree_map(lambda g, pair: pair[1], grads, pairs)
        return dec, err
