"""Large-scale FL simulation (paper §5.3): 2400 clients, energy loans,
time-to-accuracy, online-device counts.

Statistical accuracy model (FedScale-style): global accuracy approaches a
task ceiling as total useful samples accumulate, with diminishing returns and
participation-dependent round gain. It deliberately models only what the
paper's macro claims depend on — rounds completed per wall-clock unit and how
many devices stay online — not the optimization trajectory itself (the real
optimization path is exercised by :func:`repro_torch.fl.real.run_real`, the
real FedAvg cohort).

A copy of the JAX package's ``fl/simulator.py``, which is numpy only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fl.client import SwanClient
from repro_torch.fl.selection import OortSelector, random_selection
from repro_torch.fl.traces import make_client_traces
from repro_torch.runtime.fault import StragglerPolicy

DEVICE_MIX = ("pixel3", "s10e", "oneplus8", "mi10", "tab_s6")

TASK_CEILING = {"resnet34": 0.63, "shufflenet-v2": 0.49, "mobilenet-v2": 0.56}
TASK_TAU = {"resnet34": 2.5e5, "shufflenet-v2": 3.5e6, "mobilenet-v2": 3.5e6}


@dataclasses.dataclass
class FLConfig:
    workload: str = "shufflenet-v2"
    n_clients: int = 2400
    clients_per_round: int = 100
    rounds: int = 500
    policy: str = "swan"  # swan | baseline
    selector: str = "random"  # random | oort
    round_deadline_s: float = 600.0
    interference_prob: float = 0.15  # fraction of rounds a client sees a foreground app
    seed: int = 0


@dataclasses.dataclass
class RoundLog:
    t_min: float
    accuracy: float
    online: int
    participated: int
    round_s: float
    energy_j: float
    shortfall: int = 0  # accepted-vs-target gap when the deadline binds


@dataclasses.dataclass
class FLResult:
    rounds: List[RoundLog]

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for r in self.rounds:
            if r.accuracy >= target:
                return r.t_min
        return None

    @property
    def final_accuracy(self) -> float:
        return self.rounds[-1].accuracy if self.rounds else 0.0

    @property
    def total_energy_j(self) -> float:
        return sum(r.energy_j for r in self.rounds)


def run_fl(cfg: FLConfig) -> FLResult:
    rng = np.random.default_rng(cfg.seed)
    traces = make_client_traces(max(1, cfg.n_clients // 24), seed=cfg.seed,
                                tz_shifts=24)[:cfg.n_clients]
    clients = [
        SwanClient(i, DEVICE_MIX[i % len(DEVICE_MIX)], traces[i], cfg.workload,
                   policy=cfg.policy, seed=cfg.seed,
                   n_samples=int(rng.lognormal(4.5, 1.0)) + 16)
        for i in range(cfg.n_clients)
    ]
    oort = OortSelector() if cfg.selector == "oort" else None
    straggler = StragglerPolicy(over_provision=1.3, deadline_factor=2.0)

    t_min = 0.0
    samples_seen = 0.0
    ceiling = TASK_CEILING[cfg.workload]
    tau = TASK_TAU[cfg.workload]
    logs: List[RoundLog] = []
    last_day = 0

    for rnd in range(cfg.rounds):
        day = int(t_min // 1440)
        if day != last_day:
            for c in clients:
                c.end_of_day()
            last_day = day
        online = [c.cid for c in clients if c.isActive(t_min)]
        if not online:
            t_min += 10.0
            continue
        k = min(cfg.clients_per_round, len(online))
        invite = straggler.n_to_invite(k)
        if oort is not None:
            chosen = oort.select(rng, online, invite, cfg.round_deadline_s)
        else:
            chosen = random_selection(rng, online, invite)
        lats, energies, reports = [], [], []
        for cid in chosen:
            c = clients[cid]
            interf = float(rng.random() < cfg.interference_prob) * rng.uniform(0.5, 2.0)
            rep = c.run_local_step(t_min, interference=interf)
            lats.append(rep.latency_s)
            energies.append(rep.energy_j)
            reports.append((cid, rep))
        outcome = straggler.accept(lats, k, deadline_s=cfg.round_deadline_s)
        accepted = outcome.indices
        round_s = min(max((lats[i] for i in accepted), default=0.0), cfg.round_deadline_s)
        useful = len(accepted)
        if oort is not None:
            for i in accepted:
                cid, rep = reports[i]
                loss = max(0.1, 2.3 * (1 - samples_seen / (samples_seen + tau)))
                oort.report(cid, loss, clients[cid].n_samples, rep.latency_s)
        samples_seen += sum(clients[reports[i][0]].n_samples * 0.2 for i in accepted)
        acc = ceiling * (1.0 - math.exp(-samples_seen / tau))
        t_min += round_s / 60.0 + 0.5  # +30s aggregation/communication
        logs.append(RoundLog(t_min=t_min, accuracy=acc, online=len(online),
                             participated=useful, round_s=round_s,
                             energy_j=float(np.sum(energies)),
                             shortfall=outcome.shortfall))
    return FLResult(logs)


def compare_policies(workload: str, *, rounds: int = 300, n_clients: int = 480,
                     clients_per_round: int = 50, seed: int = 0) -> Dict[str, FLResult]:
    out = {}
    for policy in ("baseline", "swan"):
        cfg = FLConfig(workload=workload, n_clients=n_clients, rounds=rounds,
                       clients_per_round=clients_per_round, policy=policy, seed=seed)
        out[policy] = run_fl(cfg)
    return out
