"""Serve step functions over a ``Model``.

PyTorch runs eagerly, so ``build_*_step`` wrap the model's functions in
``torch.inference_mode`` instead of jitting them. Where the JAX package
donates the KV cache to a jitted step (``donate_argnums``), the port writes
the cache in place and returns the same buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import Model


def build_prefill_step(model: Model):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def build_decode_step(model: Model, *, greedy: bool = True):
    """One-token decode step: (params, cache, tokens, cache_len) ->
    (next_tok (B,1) int32 on the device or None, logits, cache).

    The cache is updated in place — O(1) cache traffic per token, as the JAX
    package gets from donating it — and the returned cache is the same
    object. ``cache_len`` may be a scalar (lockstep) or (B,) vector
    (continuous batching). ``greedy=False`` skips the argmax.
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, cache_len):
        logits, cache = model.decode_step(params, cache, tokens, cache_len)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None] \
            if greedy else None
        return next_tok, logits, cache

    return decode_step


@torch.inference_mode()
def greedy_decode_tokens(model: Model, params, tokens, *, steps: int,
                         max_len: int, cache_dtype=torch.float32):
    """Greedy-decode ``steps`` tokens from ``tokens`` (B,1) with a fresh
    cache in lockstep (scalar cache_len); returns the (B, steps) numpy array
    of token ids."""
    cache = model.init_cache(tokens.shape[0], max_len, cache_dtype)
    t, out = tokens, []
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, t, i)
        t = logits[:, -1:, :].argmax(-1).to(torch.int32)
        out.append(t.cpu().numpy())
    return np.concatenate(out, 1)
