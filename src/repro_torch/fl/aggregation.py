"""Server aggregation rules: FedAvg, FedProx (client proximal), FedYogi.

The JAX package's ``fl/aggregation.py`` over trees of tensors (nested dicts,
lists and tuples; ``repro_torch.tree.tree_map``). Each rule takes trees on
any device and returns new tensors on the global parameters' device; the
arithmetic is the reference's, in its order: f32 accumulation, Python-float
weights, each result cast back to its leaf's dtype. The reference computes
all three outside any kernel, and so does the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.tree import tree_map


def fedavg(global_params, client_deltas: Sequence[Any],
           weights: Optional[Sequence[float]] = None):
    """global += weighted mean of client deltas (McMahan et al.)."""
    n = len(client_deltas)
    if weights is None:
        weights = [1.0 / n] * n
    total = sum(weights)
    ws = [w / total for w in weights]

    @torch.no_grad()
    def combine(g, *leaves):
        acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for w, leaf in zip(ws, leaves):
            acc = acc + w * leaf.to(g.device, torch.float32)
        return (g.float() + acc).to(g.dtype)

    return tree_map(combine, global_params, *client_deltas)


def fedprox_grad(local_params, global_params, mu: float):
    """Proximal-term gradient mu*(w - w_global) added to client grads."""
    @torch.no_grad()
    def prox(w, g):
        return mu * (w.to(g.device, torch.float32) - g.float())

    return tree_map(prox, local_params, global_params)


@dataclasses.dataclass
class FedYogi:
    """Adaptive server optimizer (Reddi et al., cited by the paper)."""
    lr: float = 0.01
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3
    state: Any = None

    def init(self, params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        self.state = {"m": z, "v": tree_map(
            lambda p: torch.full(p.shape, self.eps ** 2, dtype=torch.float32,
                                 device=p.device), params)}

    @torch.no_grad()
    def step(self, global_params, client_deltas, weights=None):
        if self.state is None:
            self.init(global_params)
        n = len(client_deltas)
        weights = weights or [1.0 / n] * n
        total = sum(weights)
        delta = tree_map(
            lambda g, *ls: sum(w / total * l.to(g.device, torch.float32)
                               for w, l in zip(weights, ls)),
            global_params, *client_deltas)
        m = tree_map(lambda m_, d: self.b1 * m_ + (1 - self.b1) * d,
                     self.state["m"], delta)
        v = tree_map(
            lambda v_, d: v_ - (1 - self.b2) * torch.square(d)
            * torch.sign(v_ - torch.square(d)),
            self.state["v"], delta)
        self.state = {"m": m, "v": v}
        return tree_map(
            lambda p, m_, v_: (p.float() + self.lr * m_
                               / (torch.sqrt(v_) + self.eps)).to(p.dtype),
            global_params, m, v)
