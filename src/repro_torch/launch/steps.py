"""Train and serve step functions over a ``Model``.

PyTorch runs eagerly, so ``build_*_step`` return plain functions where the
JAX package returns functions to jit. Serve steps run under
``torch.inference_mode``. Where the JAX package donates a buffer to a jitted
step (the KV cache, the train state), the port writes it in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.optim.compression import Compressor
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


def _batch_to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(model: Model, optimizer: Optimizer, *, microbatch: int = 1,
                     lr: float = 0.05, compressor: Optional[Compressor] = None):
    """Returns f(state, batch) -> (state, metrics), state = {params, opt, err,
    step}, metrics = {loss, grad_norm} as 0-d f32 tensors on the device.

    Microbatched gradient accumulation runs as a Python loop where the
    reference scans: the batch's leading axis splits into ``microbatch``
    contiguous slices, gradients and losses are summed in slice order and
    divided by ``microbatch``. Then the optional compression round trip with
    error feedback, then the optimizer.

    The state is updated in place: the parameters, the optimizer's moments
    and the error-feedback residuals are written into the tensors the
    caller passed, and the returned state holds those same tensors (the
    reference returns new arrays; at llama3.2-1b's full width a copy of the
    state would cost ~20 GB). The caller that needs the old state keeps a
    copy.
    """
    comp = compressor or Compressor("none")

    def value_and_grad(params, mb):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]  # same storage
        it = iter(live)
        loss = model.loss(tree_map(lambda _: next(it), params), mb)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(state, batch):
        params = state["params"]
        batch = _batch_to(batch, model.device)
        if microbatch == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"microbatch {microbatch} does not divide "
                                 f"batch {b}")
            n = b // microbatch
            loss, grads = None, None
            for i in range(microbatch):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                li, gi = value_and_grad(params, mb)
                if grads is None:
                    loss, grads = li, gi
                else:
                    loss = loss + li
                    tree_map(lambda a, g: a.add_(g), grads, gi)
                del gi
            loss = loss / microbatch
            tree_map(lambda g: g.div_(microbatch), grads)

        err = state.get("err", ())
        if comp.scheme != "none":
            grads, err = comp.roundtrip(grads, err)
            tree_map(lambda e, new: e.copy_(new), state["err"], err)
            err = state["err"]

        updates, opt_state = optimizer.update(grads, state["opt"], params, lr)
        params = apply_updates(params, updates)
        del updates
        with torch.no_grad():
            gnorm = sum(g.float().square().sum() for g in tree_leaves(grads))
        new_state = {"params": params, "opt": opt_state, "err": err,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": torch.sqrt(gnorm)}

    return train_step


def init_train_state(model: Model, optimizer: Optimizer, gen: torch.Generator,
                     compressor: Optional[Compressor] = None):
    """Fresh state; parameters drawn from ``gen`` (the reference takes a JAX
    PRNG key: the two give different numbers from one seed)."""
    params = model.init(gen)
    comp = compressor or Compressor("none")
    return {"params": params, "opt": optimizer.init(params),
            "err": comp.init_error(params) if comp.scheme != "none" else (),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def cast_params(params, dtype):
    """Floating leaves cast to ``dtype`` (new tensors where the dtype
    changes, the same ones where it does not)."""
    with torch.no_grad():
        return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                        params)


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


def build_paged_decode_step(model: Model, *, greedy: bool = True):
    """One-token decode step over a paged KV cache.

    Same contract as :func:`build_decode_step` (pools updated in place,
    ``greedy=False`` skips the argmax) with one extra argument: the (B, T)
    int32 block table routing each sequence's virtual cache positions to
    physical pool blocks.
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, cache_len, block_table):
        logits, cache = model.paged_decode_step(params, cache, tokens,
                                                cache_len, block_table)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None] \
            if greedy else None
        return next_tok, logits, cache

    return decode_step


def build_paged_prefill_step(model: Model, *, write: bool = True):
    """One block-sized chunk of paged prefill, writing prompt KV straight
    into the pool blocks the chunk's block-table column names:
    f(params, cache, tokens, start, block_table, last_pos) -> (logits,
    cache). ``write=True`` ingests in place; ``write=False`` is the
    read-only full-prefix-hit recompute and leaves the pools untouched."""
    @torch.inference_mode()
    def prefill_chunk(params, cache, tokens, start, block_table, last_pos):
        return model.paged_prefill_step(params, cache, tokens, start,
                                        block_table, last_pos, write)

    return prefill_chunk


def build_spec_decode_step(model: Model):
    """Speculative verify step: score a (B, S) draft window in one pass,
    f(params, cache, tokens, cache_len) -> (logits (B, S, V), cache), the
    cache updated in place. Row qi of the logits is the target model's
    next-token distribution after window position qi, which greedy
    verification consumes (an argmax chain)."""
    @torch.inference_mode()
    def spec_step(params, cache, tokens, cache_len):
        return model.spec_decode_step(params, cache, tokens, cache_len)

    return spec_step


def build_paged_spec_decode_step(model: Model):
    """Speculative verify step over a paged KV cache (block-table routed):
    f(params, cache, tokens, cache_len, block_table) -> (logits, cache)."""
    @torch.inference_mode()
    def spec_step(params, cache, tokens, cache_len, block_table):
        return model.paged_spec_decode_step(params, cache, tokens, cache_len,
                                            block_table)

    return spec_step


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
