"""Shared logits shaping for every sampling consumer.

One implementation of temperature/top-k masking feeds both the engine's
sampler (``launch.steps.build_sampler``) and the speculative verifier
(``repro_torch.spec.verify.rejection_verify``). Rejection sampling is only
distribution-faithful if the accept test and the fallback sample agree on
the target distribution — keeping the masking here makes drift between the
two structurally impossible.

Everything runs where the logits are, with no host round trip, so a
captured decode step can draw inside its graph.
"""
from __future__ import annotations

import torch

from repro_torch import prng


def mask_logits(logits: torch.Tensor, temperature: float,
                top_k: int = 0) -> torch.Tensor:
    """(..., V) raw logits -> fp32 temperature-scaled, top-k-masked logits.

    ``top_k > 0`` masks everything below the k-th largest logit to -inf:
    every logit tied with the k-th survives, as in the reference (a mask
    built from ``topk``'s indices would keep exactly k). Works on any
    leading batch shape — (B, V) engine rows and (B, S, V) speculative
    verify windows share the exact same shaping.
    """
    if temperature <= 0.0:
        raise ValueError("mask_logits needs temperature > 0; greedy "
                         "decoding never shapes logits")
    # a true division (a device tensor divisor, made by a fill kernel): a
    # Python scalar divisor becomes a multiply by its reciprocal on the card
    t = torch.full((), float(temperature), dtype=torch.float32,
                   device=logits.device)
    lg = logits.float() / t
    if top_k:
        kth = torch.topk(lg, int(top_k), dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def sample_probs(logits: torch.Tensor, temperature: float,
                 top_k: int = 0) -> torch.Tensor:
    """The sampling distribution implied by (temperature, top_k): softmax of
    the masked logits. This is the q(x) the rejection test accepts against
    and the distribution the faithfulness property test checks."""
    return torch.softmax(mask_logits(logits, temperature, top_k), dim=-1)


def categorical(keys: torch.Tensor, logits: torch.Tensor, temperature: float,
                top_k: int = 0) -> torch.Tensor:
    """Sample one token per leading row. keys: (B, 2) int64 per-row PRNG
    keys (the engine's fold_in(seed, uid, index) streams, on the logits'
    device); logits: (B, V). Returns (B,) int32."""
    lg = mask_logits(logits, temperature, top_k)
    return prng.categorical(keys, lg).to(torch.int32)
