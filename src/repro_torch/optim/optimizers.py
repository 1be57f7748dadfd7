"""Optimizers over parameter trees (the JAX package's ``optim/optimizers.py``).

Optimizer = (init(params) -> state, update(grads, state, params, lr) ->
(updates, state)), as in the reference. The paper trains with plain SGD
lr=0.05 (§5.1); Adam exists for the beyond-paper experiments and the LM
examples. Moments stay f32 under bf16 params, as in the reference.

Unlike the reference's pure functions, ``update`` writes the momentum,
Adam moments and Adam's step count ``t`` in place and returns the same
state objects: the train step owns its state, a new copy of the moments
would cost 2 x 4 bytes per parameter (~10 GB at llama3.2-1b's full width),
and a compiled step (``launch/steps.CompiledStep``) replays what it
captured, so a new ``t`` would freeze the bias correction at its captured
step. ``apply_updates`` adds in place too. Callers that need the old state
keep a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (updates, state)
    bytes_per_param: int  # optimizer-state bytes (for the memory roofline)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    if momentum == 0.0:
        def init(params):
            return ()

        @torch.no_grad()
        def update(grads, state, params, lr):
            return tree_map(lambda g: -lr * g, grads), state

        return Optimizer("sgd", init, update, 0)

    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        def step(m, g):
            m.mul_(momentum).add_(g)  # momentum * m + g
            return -lr * (momentum * m + g) if nesterov else -lr * m

        return tree_map(step, state, grads), state

    return Optimizer("sgd_momentum", init, update, 4)


def adam(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        device = tree_leaves(params)[0].device
        return {"m": z, "v": tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"].add_(1)
        tf = t.float()
        bc1 = 1 - torch.pow(b1, tf)  # a scalar base: no host tensor
        bc2 = 1 - torch.pow(b2, tf)

        def upd(m_, v_, g, p):
            g = g.float()
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g.square())
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        updates = tree_map(upd, state["m"], state["v"], grads, params)
        return updates, {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer("adam", init, update, 8)


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, written into ``params`` in place and returned."""
    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
