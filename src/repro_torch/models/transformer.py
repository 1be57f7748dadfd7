"""Decoder-only LM assembly, dense family.

Parameters are the JAX package's tree: ``params["layers"]`` holds every
layer's weights stacked on a leading axis, as ``init_decoder`` makes them
there, and each loop below takes layer ``i`` as a view. The KV cache keeps
the JAX layout too: ``{"k", "v"}`` of shape (L, B, Smax, K, hd), so the
tests compare caches directly. The MoE, VLM, SSM and hybrid families are
not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (gqa_decode, gqa_forward, gqa_params,
                                          init_gqa_cache)
from repro_torch.models.common import (apply_mlp, apply_norm, dense_init,
                                       embed_tokens, mlp_params, norm_params)


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} (mla={cfg.use_mla}, moe={cfg.is_moe}) is "
            f"not yet ported to repro_torch; the dense GQA decoder is")


def _layer(layers, i: int):
    """Layer ``i``'s weights as views into the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_dense_layer(gen: torch.Generator, cfg, dtype=torch.float32):
    return {"ln1": norm_params(cfg, dtype, gen.device),
            "ln2": norm_params(cfg, dtype, gen.device),
            "attn": gqa_params(gen, cfg, dtype),
            "mlp": mlp_params(gen, cfg, dtype=dtype)}


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_decoder(gen: torch.Generator, cfg, dtype=torch.float32):
    """Params drawn from ``gen`` on ``gen.device`` with ``init_decoder``'s
    distributions: embed N(0, 0.02^2), projections N(0, 1/d_in), norms 1."""
    _check_family(cfg)
    params = {"embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                    device=gen.device) * 0.02).to(dtype),
              "ln_f": norm_params(cfg, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    params["layers"] = _stack([init_dense_layer(gen, cfg, dtype)
                               for _ in range(cfg.n_layers)])
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def dense_block(p, h, cfg, positions, impl, chunk, return_kv=False):
    """Standard pre-norm block. Returns h, or (h, kv) when ``return_kv``."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    if return_kv:
        a, kv = gqa_forward(p["attn"], x, cfg, positions=positions, impl=impl,
                            chunk=chunk, return_kv=True)
    else:
        a = gqa_forward(p["attn"], x, cfg, positions=positions, impl=impl,
                        chunk=chunk)
    h = h + a
    h = h + apply_mlp(p["mlp"], apply_norm(p["ln2"], h, cfg.norm), cfg.activation)
    return (h, kv) if return_kv else h


def _logits(params, cfg, h):
    h = apply_norm(params["ln_f"], h, cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def forward_decoder(params, cfg, tokens, *, impl="chunked", chunk=1024,
                    return_cache=False):
    """Returns (logits, h), or (last-position logits, (h, cache)) when
    ``return_cache``; the cache is {"k", "v"} of shape (L, B, S, K, hd)."""
    _check_family(cfg)
    B, S = tokens.shape
    h = embed_tokens(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = positions[None].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if return_cache:
            h, kv = dense_block(lp, h, cfg, positions, impl, chunk, return_kv=True)
            ks.append(kv["k"])
            vs.append(kv["v"])
        else:
            h = dense_block(lp, h, cfg, positions, impl, chunk)
    if return_cache:
        # prefill semantics: only the last position's logits are needed
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        return _logits(params, cfg, h[:, -1:]), (h, cache)
    return _logits(params, cfg, h), h


def _last_logits(params, cfg, h, last_pos=None):
    """Logits of the last *valid* prompt position. ``last_pos=None`` means the
    final position; an index selects earlier — the bucketed-prefill case,
    where the prompt is right-padded to a bucket length and causality keeps
    every position < true length unaffected."""
    if last_pos is None:
        return _logits(params, cfg, h[:, -1:])
    last_pos = int(last_pos)
    return _logits(params, cfg, h[:, last_pos:last_pos + 1])


def prefill_decoder(params, cfg, tokens, *, impl="chunked", chunk=1024,
                    last_pos=None):
    """Single-pass prefill: returns (logits (B,1,V), cache (L,B,S,K,hd)).

    ``last_pos`` supports bucketed admission: prompts padded up to a bucket
    length still report the logits of their true last token.
    """
    logits, (h, cache) = forward_decoder(params, cfg, tokens, impl=impl,
                                         chunk=chunk, return_cache=True)
    if last_pos is not None:
        logits = _last_logits(params, cfg, h, last_pos)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache_decoder(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cpu"):
    _check_family(cfg)
    layer = init_gqa_cache(cfg, batch, max_len, dtype, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in layer.items()}


def decode_step_decoder(params, cfg, cache, tokens, cache_len, *, impl="chunked"):
    """One-token decode. tokens: (B,1) int; cache_len: scalar or (B,) int.

    ``impl="pallas"`` selects the flash-decode kernel for every KV-cache
    attention in the stack; any other impl uses the naive decode oracle (the
    prefill impls chunked/pallas apply to full-sequence attention, so decode
    maps them onto {naive, pallas}). The cache is updated in place (the JAX
    package donates it instead) and returned.
    """
    _check_family(cfg)
    dimpl = "pallas" if impl == "pallas" else "naive"
    h = embed_tokens(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        lcache = {"k": cache["k"][i], "v": cache["v"][i]}  # views: written in place
        x = apply_norm(lp["ln1"], h, cfg.norm)
        a, _ = gqa_decode(lp["attn"], x, lcache, cache_len, cfg, impl=dimpl)
        h = h + a
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm),
                          cfg.activation)
    return _logits(params, cfg, h), cache
