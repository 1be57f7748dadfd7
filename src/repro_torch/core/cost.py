"""Swan §4.3: cost ordering + pruning of dominated execution choices.

Rules (paper, quoted):
  1. using more cores of the same type is costlier,
  2. any number of low-latency cores is costlier than any number of
     low-power cores,
  3. Prime cores are costlier than low-latency cores.

Both choice kinds encode these as a lexicographic ``cost_key()``; pruning then
removes every choice that is dominated — i.e. some other choice is at least as
fast AND at least as cheap (one strictly) — so every surviving "downgrade"
genuinely relinquishes compute while every survivor offers a real
latency/cost trade-off (this is what removes ShuffleNet's 4-core choice, O2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ChoiceProfile:
    """One explored execution choice + its measured/estimated profile."""
    choice: Any
    latency_s: float  # per local step
    energy_j: float  # per local step
    power_w: float
    cost_key: Tuple
    memory_bytes: int = 0  # per-device peak (TPU choices)
    meta: Optional[dict] = None

    @property
    def name(self) -> str:
        return getattr(self.choice, "name", str(self.choice))


def total_order(profiles: Sequence[ChoiceProfile]) -> List[ChoiceProfile]:
    """Sort by increasing expected training time (paper §4.3 step 1)."""
    return sorted(profiles, key=lambda p: (p.latency_s, p.cost_key))


def pareto_prune(profiles: Sequence[ChoiceProfile]) -> List[ChoiceProfile]:
    """Drop choices dominated on (latency, cost_key).

    Walk in increasing-latency order keeping the running cheapest cost; a
    choice survives only if it is strictly cheaper than everything faster
    than it (equivalently: each successive survivor must relinquish
    resources). The fastest choice always survives.
    """
    ordered = total_order(profiles)
    kept: List[ChoiceProfile] = []
    best_cost: Optional[Tuple] = None
    for p in ordered:
        if best_cost is None or p.cost_key < best_cost:
            kept.append(p)
            best_cost = p.cost_key
    return kept


def ladder(profiles: Sequence[ChoiceProfile]) -> List[ChoiceProfile]:
    """Pruned choices as a downgrade ladder: fastest/costliest first."""
    return pareto_prune(profiles)


def pick_fastest(profiles: Sequence[ChoiceProfile],
                 *, memory_limit: Optional[int] = None,
                 energy_budget_j: Optional[float] = None) -> ChoiceProfile:
    """The choice Swan runs under no interference (paper §4.3)."""
    feasible = [p for p in profiles
                if (memory_limit is None or p.memory_bytes <= memory_limit)
                and (energy_budget_j is None or p.energy_j <= energy_budget_j)]
    if not feasible:
        raise ValueError("no feasible execution choice under the given constraints")
    return total_order(feasible)[0]


def ladder_sensitivities(n: int, *, head: float = 1.0, floor: float = 0.1,
                         decay: float = 0.4) -> List[float]:
    """Interference sensitivity by ladder position (fastest first).

    The pruning invariant (each survivor relinquishes resources the faster
    ones hold) means each downgrade overlaps less with a co-tenant's demand;
    model that as geometric decay toward a floor. engine/rungs.py uses this to
    turn a ChoiceProfile ladder into Rungs whose simulated interference
    shrinks as the engine steps down — the mechanism behind Table 3's
    foreground-impact recovery.
    """
    return [max(floor, head * decay ** i) for i in range(max(n, 1))]


def pick_most_efficient(profiles: Sequence[ChoiceProfile],
                        *, memory_limit: Optional[int] = None) -> ChoiceProfile:
    feasible = [p for p in profiles
                if memory_limit is None or p.memory_bytes <= memory_limit]
    if not feasible:
        raise ValueError("no feasible execution choice")
    return min(feasible, key=lambda p: p.energy_j)
