"""Fault tolerance & straggler mitigation policies.

At fleet scale, Swan's "interference" becomes node failure / preemption /
stragglers. Two standard mitigations implemented here, both driven by the same
profiles the Swan planner maintains:

- FaultModel: exponential per-node MTBF; decides which nodes die during a
  step window. Drives both the FL simulator and the elastic-train example.
- StragglerPolicy: over-provisioned participation + deadline. Select
  ceil(K * over_provision) participants, accept the first K results within
  ``deadline_factor * median_latency`` (FedScale/Papaya-style); the laggards'
  work is dropped, so one slow node never stalls the round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class FaultModel:
    mtbf_steps: float  # mean steps between failures per node
    recovery_steps: float = 50.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def step_failures(self, n_nodes: int) -> np.ndarray:
        """Bool mask of nodes that fail during this step.

        ``mtbf_steps <= 0`` means "no time between failures": every node
        fails every step, deterministically — not a division blow-up into a
        probability of 1e9 that happens to behave the same by accident."""
        if n_nodes <= 0:
            return np.zeros(0, dtype=bool)
        if self.mtbf_steps <= 0:
            return np.ones(n_nodes, dtype=bool)
        return self._rng.random(n_nodes) < 1.0 / self.mtbf_steps

    def recovery_time(self) -> int:
        return int(self._rng.exponential(self.recovery_steps)) + 1


@dataclasses.dataclass(frozen=True)
class AcceptOutcome:
    """Result of a round's acceptance decision.

    ``indices`` are the accepted participants, fastest first. ``shortfall``
    is how far the round fell short of its target (accepted vs min(k,
    invited)) — callers must see a short round rather than having laggards
    silently accepted for them.
    """
    indices: np.ndarray
    invited: int
    target: int
    deadline_s: float

    @property
    def shortfall(self) -> int:
        return max(0, min(self.target, self.invited) - int(self.indices.size))

    def __len__(self) -> int:
        return int(self.indices.size)

    def __iter__(self) -> Iterator[int]:
        return iter(int(i) for i in self.indices)


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    over_provision: float = 1.3
    deadline_factor: float = 2.0

    def n_to_invite(self, k: int) -> int:
        return max(k, math.ceil(k * self.over_provision))

    def accept(self, latencies: Sequence[float], k: int, *,
               deadline_s: Optional[float] = None) -> AcceptOutcome:
        """First-k finishers within the deadline — and the deadline is
        binding. A round where fewer than k nodes beat it completes short
        (graceful degradation); the shortfall is surfaced on the outcome, it
        is never papered over by accepting laggards. The effective deadline
        is ``deadline_factor * median_latency``, clamped by the absolute
        ``deadline_s`` when given. An empty round (every invited node died)
        accepts nobody rather than warning about the median of nothing."""
        lat = np.asarray(latencies, dtype=np.float64)
        if lat.size == 0 or k <= 0:
            bound = float(deadline_s) if deadline_s is not None else 0.0
            return AcceptOutcome(indices=np.zeros(0, dtype=np.int64),
                                 invited=int(lat.size), target=max(0, k),
                                 deadline_s=bound)
        order = np.argsort(lat, kind="stable")
        med = float(np.median(lat))
        deadline = med * self.deadline_factor
        if deadline_s is not None:
            deadline = min(deadline, float(deadline_s))
        accepted = [int(i) for i in order if lat[i] <= deadline][:k]
        return AcceptOutcome(indices=np.asarray(accepted, dtype=np.int64),
                             invited=int(lat.size), target=int(k),
                             deadline_s=deadline)
