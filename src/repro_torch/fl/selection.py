"""Participant selection: uniform random + Oort-style utility (Lai et al.).

A copy of the JAX package's ``fl/selection.py``, which is numpy only.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def random_selection(rng: np.random.Generator, available: Sequence[int], k: int) -> List[int]:
    avail = list(available)
    if len(avail) <= k:
        return avail
    return list(rng.choice(avail, size=k, replace=False))


class OortSelector:
    """Utility = statistical utility * (deadline/latency)^alpha, with
    epsilon-greedy exploration of never-tried clients."""

    def __init__(self, alpha: float = 2.0, epsilon: float = 0.2):
        self.alpha = alpha
        self.epsilon = epsilon
        self.stat_util: Dict[int, float] = {}
        self.latency: Dict[int, float] = {}

    def report(self, client: int, loss: float, n_samples: int, latency_s: float):
        self.stat_util[client] = abs(loss) * np.sqrt(max(n_samples, 1))
        self.latency[client] = latency_s

    def select(self, rng: np.random.Generator, available: Sequence[int], k: int,
               deadline_s: float) -> List[int]:
        avail = list(available)
        if len(avail) <= k:
            return avail
        explored = [c for c in avail if c in self.stat_util]
        fresh = [c for c in avail if c not in self.stat_util]
        n_explore = min(len(fresh), max(1, int(k * self.epsilon))) if fresh else 0
        n_exploit = k - n_explore

        def utility(c):
            u = self.stat_util[c]
            lat = self.latency.get(c, deadline_s)
            if lat > deadline_s:
                u *= (deadline_s / lat) ** self.alpha
            return u

        exploit = sorted(explored, key=utility, reverse=True)[:n_exploit]
        explore = list(rng.choice(fresh, size=n_explore, replace=False)) if n_explore else []
        chosen = exploit + explore
        if len(chosen) < k:
            rest = [c for c in avail if c not in chosen]
            chosen += list(rng.choice(rest, size=min(k - len(chosen), len(rest)),
                                      replace=False))
        return chosen
