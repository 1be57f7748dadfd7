"""Mixture-of-Experts layer (fine-grained, shared + routed top-k, capacity
drop): the single-device path of the JAX package's ``models/moe.py``.

Token-choice top-k routing in f32 after the router product, then per expert
its top-``capacity`` tokens by gate value (over-capacity tokens are dropped,
Switch-style; ``_capacity`` counts all T tokens of the call, so drops depend
on what rides along in the batch), the expert MLPs as batched products
(``torch.bmm``: the reference leaves them to XLA, outside any Pallas
kernel), and the gated results summed back into token order.

The combine is deterministic. The reference scatter-adds every (expert,
slot) row into its token (``.at[].add``); ``index_add_`` on CUDA would sum a
token's contributions with atomics, in an order that changes from run to
run and breaks captured-against-eager and run-against-run stream
comparisons. Here each token gathers its own k slots through an inverse
map (expert, token) -> slot and adds them one after another in ascending
expert order, the order the reference's scatter meets them in; slots of
dropped tokens read a zero row. Tokens that fill an expert's capacity with
a zero gate contribute exactly zero in the reference, so only a token's
routed experts are gathered. The backward needs no such care: the dispatch
gather ``x_flat[sel_i]`` sends its rows back through an accumulating
``index_put_``, which on CUDA sorts the indices and sums each token's rows
in that order, and two backward calls at deepseek-moe-16b's full-width
layer (T 2048, E 64, top-6) give the same bits on an H100
(``tests/test_torch_cuda.py::test_moe_backward_gives_the_same_bits_twice``).

The mesh and wide expert-parallel paths of the reference wait for the
port's multi-card slice: ``apply_moe`` raises if it is given a mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import activate, dense_init


def moe_params(gen: torch.Generator, cfg, dtype=torch.float32):
    """Router (d, E), stacked expert weights (E, d, ff) / (E, ff, d) drawn
    N(0, 1/d) and N(0, 1/ff) as the reference draws them (one expert at a
    time here, so a full-width draw needs no (E, d, ff) f32 temporary), and
    the shared experts as one MLP of ``n_shared_experts * ff``."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dev = gen.device

    def stacked(rows, cols, scale):
        w = torch.empty((E, rows, cols), dtype=dtype, device=dev)
        for e in range(E):
            w[e] = (torch.randn((rows, cols), generator=gen, device=dev) * scale).to(dtype)
        return w

    p = {"router": dense_init(gen, d, E, dtype),
         "experts": {"w_gate": stacked(d, ff, 1.0 / math.sqrt(d)),
                     "w_up": stacked(d, ff, 1.0 / math.sqrt(d)),
                     "w_down": stacked(ff, d, 1.0 / math.sqrt(ff))}}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared"] = {"w_gate": dense_init(gen, d, sff, dtype),
                       "w_up": dense_init(gen, d, sff, dtype),
                       "w_down": dense_init(gen, sff, d, dtype)}
    return p


def _top(x_flat, router_w, cfg):
    """The router's f32 probs (T, E) and each token's renormalised top-k
    gates and experts (T, k)."""
    logits = (x_flat @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_g, top_i


def _dense_gates(probs, top_g, top_i, cfg):
    """Dense (T, E) gates and the switch-style load-balance aux loss."""
    gates = torch.zeros_like(probs).scatter(1, top_i, top_g)
    f = (gates > 0).float().mean(0)  # fraction routed to each expert
    aux = cfg.n_experts * torch.sum(f * probs.mean(0)) * cfg.router_aux_coef
    return gates, aux


def _route(x_flat, router_w, cfg):
    """Token-choice top-k routing. Returns dense gates (T, E) and the aux
    loss, as the reference's ``_route``."""
    return _dense_gates(*_top(x_flat, router_w, cfg), cfg)


def _expert_compute(xb, w_gate, w_up, w_down, activation):
    """xb: (E, C, d) -> (E, C, d)."""
    h = activate(torch.bmm(xb, w_gate), activation)
    h = h * torch.bmm(xb, w_up)
    return torch.bmm(h, w_down)


def _moe_local(x_flat, gates, top_i, experts, capacity: int, activation: str):
    """Routed output of every expert: per expert its top-``capacity``
    tokens by gate value (the rest dropped), the expert MLP, the gate cast
    to the output's dtype, then each token's routed slots summed in
    ascending expert order (the deterministic combine of the module
    docstring). ``top_i`` (T, k): each token's routed experts."""
    T, d = x_flat.shape
    E = gates.shape[1]
    cap = min(capacity, T)
    sel_g, sel_i = torch.topk(gates.T, cap, dim=-1)  # (E, C)
    xb = x_flat[sel_i.reshape(-1)].reshape(E, cap, d)
    yb = _expert_compute(xb, experts["w_gate"], experts["w_up"],
                         experts["w_down"], activation)
    yb = yb * sel_g[..., None].to(yb.dtype)  # gate == 0 rows contribute nothing
    # slot of (expert, token), or the zero row E*C where the token was not kept
    slot = torch.full((E, T), E * cap, dtype=torch.long, device=x_flat.device)
    slot.scatter_(1, sel_i, torch.arange(E * cap, device=x_flat.device).reshape(E, cap))
    rows = torch.cat([yb.reshape(E * cap, d), yb.new_zeros((1, d))])
    experts_in_order = torch.sort(top_i, dim=-1).values  # (T, k)
    tok = torch.arange(T, device=x_flat.device)
    y = rows[slot[experts_in_order[:, 0], tok]]
    for j in range(1, top_i.shape[1]):
        y = y + rows[slot[experts_in_order[:, j], tok]]
    return y


def _capacity(T: int, cfg, capacity_factor: float, min_capacity: int) -> int:
    cap = math.ceil(T * cfg.top_k / cfg.n_experts * capacity_factor)
    return min(T, max(min_capacity, cap))


def apply_moe(p, x, cfg, capacity_factor: float = 1.25, mesh=None,
              activation: Optional[str] = None, min_capacity: int = 4):
    """x: (B, S, d) -> (y, aux_loss). Over-capacity tokens are dropped
    (Switch-style); ``min_capacity`` keeps small decode batches drop-free.
    The reference's single-shard path; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "apply_moe's mesh and expert-parallel paths are not ported: "
            "repro_torch runs the MoE layer on one card (mesh=None)")
    act = activation or cfg.activation
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    probs, top_g, top_i = _top(x_flat, p["router"], cfg)
    gates, aux = _dense_gates(probs, top_g, top_i, cfg)
    capacity = _capacity(B * S, cfg, capacity_factor, min_capacity)
    y = _moe_local(x_flat, gates, top_i, p["experts"], capacity, act)
    if "shared" in p:
        sh = p["shared"]
        h = activate(x_flat @ sh["w_gate"], act) * (x_flat @ sh["w_up"])
        y = y + h @ sh["w_down"]
    return y.reshape(B, S, d).to(x.dtype), aux
