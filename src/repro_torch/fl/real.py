"""The real FedAvg cohort (the paper's Table 4, real-training mode).

The port's counterpart of ``run_real`` in the JAX package's
``benchmarks/table4_fl.py``: a ResNet trained by FedAvg over a cohort of
clients. Each round, each client starts from the global parameters and takes
``local_steps`` plain-SGD steps on its own stream of ``synthetic_cnn_batch``
(``np.random.default_rng([round, client])``, seeded as the reference seeds
it, so both packages draw the same batches); its delta (local − global)
stays on the device, and :func:`~repro_torch.fl.aggregation.fedavg` averages
the cohort's deltas into the next global parameters.

One local train state serves every client: the global parameters are copied
into it in place at each client's start. The compiled local step
(``launch/steps.CompiledStep``) holds the addresses of the state it
captured, so it captures once for the whole cohort; a fresh state per client
would capture again for each, and a graph's buffers are never freed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import synthetic_cnn_batch
from repro_torch.fl.aggregation import fedavg
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import CompiledStep, build_train_step
from repro_torch.models import build_model
from repro_torch.optim.optimizers import sgd
from repro_torch.tree import tree_map


@dataclasses.dataclass
class RealResult:
    losses: List[float]  # each round's mean over clients of their last local loss
    params: Any  # the final global parameters
    captures: int  # CUDA graph captures of the local step (0 eager)
    step_s: List[float]  # wall seconds of each local step, in order
    agg_s: List[float]  # wall seconds of each round's fedavg


def run_real(cfg, *, n_clients: int = 8, rounds: int = 6, local_steps: int = 4,
             batch: int = 16, lr: float = 0.05, seed: int = 0,
             device="cuda", jit: bool = True, params=None,
             on_aggregate: Optional[Callable] = None) -> RealResult:
    """FedAvg of ``n_clients`` clients over ``rounds`` rounds on ``cfg``.

    ``params``: a tree of tensors to start from (copied onto ``device``);
    None draws them from a torch generator seeded with ``seed``. ``jit``
    compiles the local step (a CUDA graph on the card; eager on the CPU).
    ``on_aggregate(rnd, global_params, deltas, new_params)``, if given, sees
    each round's aggregation. Step and aggregation times are wall seconds
    with the device synchronized on both sides.
    """
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    if params is None:
        glob = model.init(model.generator(seed))
    else:
        glob = tree_map(lambda p: p.detach().to(dev, copy=True), params)
    train_step = build_train_step(model, sgd(), lr=lr)
    step = CompiledStep(train_step, "fl_local_step", state_argnums=(0,)) \
        if jit else train_step
    local = {"params": tree_map(torch.clone, glob), "opt": (), "err": (),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, step_s, agg_s = [], [], []
    for rnd in range(rounds):
        deltas, client_losses = [], []
        for c in range(n_clients):
            rng = np.random.default_rng([rnd, c])
            with torch.no_grad():
                tree_map(lambda l, g: l.copy_(g), local["params"], glob)
            for _ in range(local_steps):
                b = synthetic_cnn_batch(rng, batch, cfg.image_size,
                                        cfg.in_channels, cfg.n_classes)
                sync()
                t0 = time.perf_counter()
                local, metrics = step(local, b)
                sync()
                step_s.append(time.perf_counter() - t0)
            client_losses.append(float(metrics["loss"]))
            with torch.no_grad():
                deltas.append(tree_map(lambda l, g: l - g, local["params"],
                                       glob))
        sync()
        t0 = time.perf_counter()
        new = fedavg(glob, deltas)
        sync()
        agg_s.append(time.perf_counter() - t0)
        if on_aggregate is not None:
            on_aggregate(rnd, glob, deltas, new)
        glob = new
        losses.append(float(np.mean(client_losses)))
    return RealResult(losses=losses, params=glob,
                      captures=getattr(step, "captures", 0), step_s=step_s,
                      agg_s=agg_s)
