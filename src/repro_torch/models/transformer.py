"""Decoder-only LM assembly, dense family.

Parameters are the JAX package's tree: ``params["layers"]`` holds every
layer's weights stacked on a leading axis, as ``init_decoder`` makes them
there, and each pass below takes all layers' views with one ``unbind(0)``
per stacked leaf (``_layer_views``): its backward stacks the layers'
gradients once, where indexing layer ``i`` as ``v[i]`` would write a
zero-filled gradient the size of the whole stacked leaf for every layer
(~4 GB of writes per layer at llama3.2-1b's full width). ``remat``
checkpoints each block as the reference's ``jax.checkpoint`` policies do
(``_maybe_remat``). The KV cache keeps the JAX layout too: ``{"k", "v"}``
of shape (L, B, Smax, K, hd), so the tests compare caches directly; the
paged layout keeps its (L, num_blocks, block_size, K, hd) pools.

The moe family (deepseek) splits the stack as the reference's ``scan``s do:
``params["dense_layers"]`` holds the first ``first_k_dense`` layers (an MLP
of ``dense_d_ff``), ``params["layers"]`` the MoE layers, and
``params["mtp"]`` the multi-token-prediction head. ``loss_decoder`` adds
the MoE layers' summed router aux loss and, where the config has an MTP
head (deepseek-v3), 0.3 times its cross-entropy on token t+2, as the
reference does. Under MLA (deepseek-v3) the cache is {"latent", "k_rope"}
of shape (L, B, Smax, r|rd), or (L, num_blocks, block_size, r|rd) pools.
The VLM, SSM and hybrid families are not ported yet.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models.attention import (attn_params, gqa_decode,
                                          gqa_decode_paged, gqa_decode_spec,
                                          gqa_decode_spec_paged, gqa_forward,
                                          gqa_prefill_paged, init_gqa_cache,
                                          init_gqa_pool, init_mla_cache,
                                          init_mla_pool, mla_decode,
                                          mla_decode_paged, mla_forward,
                                          mla_prefill_paged)
from repro_torch.models.common import (apply_mlp, apply_norm, cross_entropy,
                                       dense_init, embed_tokens, mlp_params,
                                       norm_params)
from repro_torch.models.moe import apply_moe, moe_params


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch; the dense "
            f"and moe decoders are")


def _layer_views(layers, n: int):
    """Every layer's weights as views into the stacked tree, one ``unbind``
    per leaf: a list of ``n`` trees."""
    def walk(node):
        if isinstance(node, dict):
            subs = {k: walk(v) for k, v in node.items()}
            return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
        return node.unbind(0)

    return walk(layers)


# the products without batch dimensions: ``x @ W`` with a 2-D weight, which
# matmul folds to one of these (the attention's batched products reach bmm)
_NO_BATCH_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions (the projections), recompute
    everything else (norms, activations, rope, the attention's batched
    products and the flash kernels' outputs)."""
    return CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


# the reference's REMAT_POLICIES as ``checkpoint`` context functions
REMAT_POLICIES = {
    "dots": functools.partial(create_selective_checkpoint_contexts, _dots_policy),
    "full": noop_context_fn,  # nothing_saveable: only the block's inputs
}


def _maybe_remat(fn, remat: str):
    """The reference's rematerialization switch, applied per dense block:
    ``torch.utils.checkpoint`` keeps the block's inputs (and under ``"dots"``
    its projections' outputs) and recomputes the rest in the backward. The
    RNG state is not kept: the decoder draws nothing, and reading the CUDA
    RNG state cannot be captured in a CUDA graph."""
    if remat == "none":
        return fn
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; "
                         f"known: {['none', *REMAT_POLICIES]}")
    context_fn = REMAT_POLICIES[remat]

    def block(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn,
                          **kwargs)

    return block


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_dense_layer(gen: torch.Generator, cfg, dtype=torch.float32,
                     moe: bool = False, d_ff: Optional[int] = None):
    p = {"ln1": norm_params(cfg, dtype, gen.device),
         "ln2": norm_params(cfg, dtype, gen.device),
         "attn": attn_params(gen, cfg, dtype)}
    if moe:
        p["moe"] = moe_params(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_params(gen, cfg, d_ff=d_ff, dtype=dtype)
    return p


def _copy_into(dst, src, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def _init_stacked(n: int, make_layer):
    """``n`` layers from ``make_layer()`` stacked on a leading axis, built in
    place: each stacked leaf is allocated once, from the first layer's
    shapes, and layer i is drawn by the i-th call and copied into slot i, so
    the draws come in the order a per-layer list would take them while at
    most one layer lives beside the stack (a list then ``torch.stack`` would
    hold every layer twice). One layer is viewed, not copied. No layer is
    drawn for ``n == 0``, as ``jax.vmap`` over no keys draws none: the
    layer's shapes come from a run under ``FakeTensorMode``, which neither
    allocates nor advances the generator."""
    if n == 0:
        with FakeTensorMode():
            first = make_layer()
    else:
        first = make_layer()

    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return (node[None] if n == 1 else
                torch.empty((n,) + tuple(node.shape), dtype=node.dtype,
                            device=node.device))

    out = alloc(first)
    if n > 1:
        _copy_into(out, first, 0)
        del first
        for i in range(1, n):
            _copy_into(out, make_layer(), i)
    return out


def _n_first_dense(cfg) -> int:
    """Leading dense layers of the stack: ``first_k_dense`` for a moe
    config, none otherwise."""
    return cfg.first_k_dense if cfg.is_moe else 0


def init_decoder(gen: torch.Generator, cfg, dtype=torch.float32):
    """Params drawn from ``gen`` on ``gen.device`` with ``init_decoder``'s
    distributions: embed N(0, 0.02^2), projections N(0, 1/d_in), norms 1."""
    _check_family(cfg)
    params = {"embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                    device=gen.device) * 0.02).to(dtype),
              "ln_f": norm_params(cfg, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    kd = _n_first_dense(cfg)
    if kd:
        params["dense_layers"] = _init_stacked(kd, lambda: init_dense_layer(
            gen, cfg, dtype, d_ff=cfg.dense_d_ff or cfg.d_ff))
    params["layers"] = _init_stacked(cfg.n_layers - kd, lambda: init_dense_layer(
        gen, cfg, dtype, moe=cfg.is_moe))
    if cfg.is_moe and cfg.n_mtp_modules:
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype),
            "block": init_dense_layer(gen, cfg, dtype, d_ff=cfg.dense_d_ff or cfg.d_ff),
            "ln": norm_params(cfg, dtype, gen.device)}
    return params


def _stack_views(params, cfg) -> list:
    """Every layer's weights as views, in depth order: a moe stack's
    ``dense_layers`` first, then ``layers``."""
    kd = _n_first_dense(cfg)
    views = _layer_views(params["dense_layers"], kd) if kd else []
    return views + _layer_views(params["layers"], cfg.n_layers - kd)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn(p, x, cfg, moe_cf):
    """The block's MLP, or its MoE layer: (out, the router's aux loss or None)."""
    if "moe" in p:
        return apply_moe(p["moe"], x, cfg, capacity_factor=moe_cf)
    return apply_mlp(p["mlp"], x, cfg.activation), None


def dense_block(p, h, cfg, positions, impl, chunk, return_kv=False, moe_cf=1.25):
    """Standard pre-norm block: GQA attention (MLA under ``cfg.use_mla``),
    then the MLP or the MoE layer. Returns (h, aux), or (h, aux, kv) when
    ``return_kv``; aux is the MoE layer's router loss, None for an MLP."""
    x = apply_norm(p["ln1"], h, cfg.norm)
    kv = None
    if cfg.use_mla:
        out = mla_forward(p["attn"], x, cfg, positions=positions, impl=impl,
                          chunk=chunk, return_cache=return_kv)
    else:
        out = gqa_forward(p["attn"], x, cfg, positions=positions, impl=impl,
                          chunk=chunk, return_kv=return_kv)
    a, kv = out if return_kv else (out, None)
    h = h + a
    m, aux = _ffn(p, apply_norm(p["ln2"], h, cfg.norm), cfg, moe_cf)
    h = h + m
    return (h, aux, kv) if return_kv else (h, aux)


def _logits(params, cfg, h):
    h = apply_norm(params["ln_f"], h, cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def forward_decoder(params, cfg, tokens, *, impl="chunked", chunk=1024,
                    remat="none", return_cache=False, moe_cf=1.25,
                    with_aux=False):
    """Returns (logits, h), or (last-position logits, (h, cache)) when
    ``return_cache``; the cache is {"k", "v"} of shape (L, B, S, K, hd)
    ({"latent", "k_rope"} (L, B, S, r|rd) under MLA). ``with_aux`` puts the
    summed MoE router loss second, as the reference returns it: (logits,
    aux, h) or (logits, aux, (h, cache))."""
    _check_family(cfg)
    block = _maybe_remat(dense_block, remat)
    B, S = tokens.shape
    h = embed_tokens(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = positions[None].expand(B, S)
    aux = torch.zeros((), device=tokens.device)
    kvs = []
    for lp in _stack_views(params, cfg):
        if return_cache:
            h, a, kv = block(lp, h, cfg, positions, impl, chunk, return_kv=True,
                             moe_cf=moe_cf)
            kvs.append(kv)
        else:
            h, a = block(lp, h, cfg, positions, impl, chunk, moe_cf=moe_cf)
        if a is not None:
            aux = aux + a
    if return_cache:
        # prefill semantics: only the last position's logits are needed
        cache = {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}
        out = (_logits(params, cfg, h[:, -1:]), (h, cache))
    else:
        out = (_logits(params, cfg, h), h)
    return (out[0], aux, out[1]) if with_aux else out


def _mtp_loss(params, cfg, h, tokens, impl, chunk):
    """The MTP head's cross-entropy (deepseek-v3): token t+2 predicted from
    the last layer's h_t and the embedding of token t+1, through one dense
    block at positions 0..S-3 (not rematerialised, as in the reference)."""
    mtp = params["mtp"]
    emb_next = embed_tokens(params["embed"], tokens[:, 1:-1])
    u = torch.cat([h[:, :-2], emb_next], dim=-1) @ mtp["proj"]
    B, S2 = tokens.shape[0], tokens.shape[1] - 2
    pos = torch.arange(S2, dtype=torch.int32, device=tokens.device)[None].expand(B, S2)
    u, _ = dense_block(mtp["block"], u, cfg, pos, impl, chunk)
    logits = _logits(params, cfg, apply_norm(mtp["ln"], u, cfg.norm))
    return cross_entropy(logits, tokens[:, 2:])


def loss_decoder(params, cfg, batch, *, impl="chunked", chunk=1024,
                 remat="none", moe_cf=1.25):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S), plus the
    MoE layers' summed router aux loss (zero for the dense family), plus
    0.3 times the MTP term where ``cfg.n_mtp_modules`` and the params hold
    ``"mtp"``: the reference's ``loss_decoder``."""
    tokens = batch["tokens"]
    logits, aux, h = forward_decoder(params, cfg, tokens, impl=impl, chunk=chunk,
                                     remat=remat, moe_cf=moe_cf, with_aux=True)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:]) + aux
    if cfg.n_mtp_modules and "mtp" in params:
        loss = loss + 0.3 * _mtp_loss(params, cfg, h, tokens, impl, chunk)
    return loss


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
                    last_pos=None, moe_cf=1.25):
    """Single-pass prefill: returns (logits (B,1,V), cache (L,B,S,...)).

    ``last_pos`` supports bucketed admission: prompts padded up to a bucket
    length still report the logits of their true last token.
    """
    logits, (h, cache) = forward_decoder(params, cfg, tokens, impl=impl,
                                         chunk=chunk, return_cache=True,
                                         moe_cf=moe_cf)
    if last_pos is not None:
        logits = _last_logits(params, cfg, h, last_pos)
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache_decoder(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cpu"):
    _check_family(cfg)
    layer = (init_mla_cache if cfg.use_mla else init_gqa_cache)(
        cfg, batch, max_len, dtype, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in layer.items()}


def init_paged_cache_decoder(cfg, num_blocks: int, block_size: int,
                             dtype=torch.bfloat16, device="cpu"):
    """Paged KV layout: per-layer (num_blocks, block_size, ...) pools with a
    leading layer axis. One block-table row addresses the same physical
    block index in every layer's pool, so the table is shared across the
    stack."""
    _check_family(cfg)
    layer = (init_mla_pool if cfg.use_mla else init_gqa_pool)(
        cfg, num_blocks, block_size, dtype, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in layer.items()}


def _layer_cache(cache, i: int) -> dict:
    """Layer ``i``'s cache entries as views, so the layer writes in place."""
    return {k: v[i] for k, v in cache.items()}


def paged_prefill_step_decoder(params, cfg, cache, tokens, start: int,
                               block_table, *, last_pos=None,
                               write: bool = True, moe_cf=1.25):
    """One block-sized chunk of paged prefill.

    tokens: (B, block_size) int — one chunk of the (right-padded) prompt;
    ``start`` is its first virtual position, always a block multiple so the
    chunk occupies exactly one block-table column. KV is written straight
    into the (L, num_blocks, block_size, ...) pools, in place — there is no
    contiguous (1, P, ...) prefill cache to splice afterwards.
    ``write=False`` recomputes activations against already-populated
    (prefix-hit) blocks without touching the pools.

    Returns (logits, cache): logits of position ``last_pos`` within the
    chunk (``None`` = final position), as :func:`_last_logits`. A moe
    chunk routes its own tokens, so its capacity drops are the chunk's, as
    in the reference.
    """
    _check_family(cfg)
    prefill = mla_prefill_paged if cfg.use_mla else gqa_prefill_paged
    h = embed_tokens(params["embed"], tokens)
    for i, lp in enumerate(_stack_views(params, cfg)):
        x = apply_norm(lp["ln1"], h, cfg.norm)
        a, _ = prefill(lp["attn"], x, _layer_cache(cache, i), start, block_table,
                       cfg, write=write)
        h = h + a
        h = h + _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm), cfg, moe_cf)[0]
    return _last_logits(params, cfg, h, last_pos), cache


def decode_step_decoder(params, cfg, cache, tokens, cache_len, *, impl="chunked",
                        block_table=None, moe_cf=1.25):
    """One-token decode. tokens: (B,1) int; cache_len: scalar or (B,) int.

    ``impl="pallas"`` selects the flash-decode kernel for every KV-cache
    attention in the stack (the latent-space kernel under MLA); any other
    impl uses the naive decode oracle (the prefill impls chunked/pallas
    apply to full-sequence attention, so decode maps them onto {naive,
    pallas}). The cache is updated in place (the JAX package donates it
    instead) and returned.

    ``block_table`` (B, T) int switches to the paged layout: ``cache`` leaves
    are (L, num_blocks, block_size, ...) pools and every layer resolves the
    same table row to its own pool.
    """
    _check_family(cfg)
    dimpl = "pallas" if impl == "pallas" else "naive"
    h = embed_tokens(params["embed"], tokens)
    for i, lp in enumerate(_stack_views(params, cfg)):
        lcache = _layer_cache(cache, i)
        x = apply_norm(lp["ln1"], h, cfg.norm)
        if cfg.use_mla and block_table is not None:
            a, _ = mla_decode_paged(lp["attn"], x, lcache, cache_len, block_table,
                                    cfg, impl=dimpl)
        elif cfg.use_mla:
            a, _ = mla_decode(lp["attn"], x, lcache, cache_len, cfg, impl=dimpl)
        elif block_table is not None:
            a, _ = gqa_decode_paged(lp["attn"], x, lcache, cache_len,
                                    block_table, cfg, impl=dimpl)
        else:
            a, _ = gqa_decode(lp["attn"], x, lcache, cache_len, cfg, impl=dimpl)
        h = h + a
        h = h + _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm), cfg, moe_cf)[0]
    return _logits(params, cfg, h), cache


def spec_decode_step_decoder(params, cfg, cache, tokens, cache_len, *,
                             impl="chunked", block_table=None, moe_cf=1.25):
    """Speculative verify step.

    tokens: (B, S) int — the last accepted token followed by S-1 draft
    tokens; window position qi occupies cache slot cache_len + qi. One pass
    scores every draft: the returned logits are (B, S, V), where row qi is
    the target model's next-token distribution *given* the window prefix
    through position qi — row 0 scores the first draft token, row S-1 is
    the bonus distribution past the last draft. The KV cache comes back
    with all S positions written (in place); the caller's accept/rollback is
    pure cache_len bookkeeping. ``block_table`` selects the paged layout as
    in :func:`decode_step_decoder`. MLA has no verify window, as in the
    reference.
    """
    _check_family(cfg)
    if cfg.use_mla:
        raise ValueError("speculative decode is not implemented for MLA "
                         "attention (absorbed-q verify window pending)")
    dimpl = "pallas" if impl == "pallas" else "naive"
    h = embed_tokens(params["embed"], tokens)
    for i, lp in enumerate(_stack_views(params, cfg)):
        lcache = _layer_cache(cache, i)
        x = apply_norm(lp["ln1"], h, cfg.norm)
        if block_table is not None:
            a, _ = gqa_decode_spec_paged(lp["attn"], x, lcache, cache_len,
                                         block_table, cfg, impl=dimpl)
        else:
            a, _ = gqa_decode_spec(lp["attn"], x, lcache, cache_len, cfg,
                                   impl=dimpl)
        h = h + a
        h = h + _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm), cfg, moe_cf)[0]
    return _logits(params, cfg, h), cache
