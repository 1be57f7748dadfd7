"""The Swan planner: explore -> prune -> order -> select (+ fleet amortization).

``explore_soc`` is the paper's on-device exploration: one unexplored choice is
benchmarked per training request (work-conserving: the benchmark batches are
real training). ``fleet_explore`` is §4.2's coordinator amortization: the
choice list is partitioned among devices of the same SoC model, and the merged
profiles are shipped to every device, so each user bears 1/N of the
exploration cost and new devices skip it entirely.

``SwanPlan`` is what a device (or pod) runs with: the pruned ladder plus the
selected operating point.

A copy of the JAX package's ``core/planner.py``. On the card the choices are
``engine.rungs.Rung``s explored through ``ExplorationState`` with
``core.profiler.profile_rung`` as the profiler, then planned by
``plan_from_profiles``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import energy as E
from repro_torch.core.choices import CoreChoice, enumerate_core_choices
from repro_torch.core.controller import SwanController
from repro_torch.core.cost import (ChoiceProfile, ladder, pareto_prune,
                                   pick_fastest, pick_most_efficient,
                                   total_order)
from repro_torch.core.profiler import greedy_baseline_profile, profile_soc_choice


@dataclasses.dataclass
class SwanPlan:
    workload: str
    device: str
    profiles: List[ChoiceProfile]  # all explored
    ladder: List[ChoiceProfile]  # pruned, fastest first
    selected: ChoiceProfile

    def controller(self, **kw) -> SwanController:
        return SwanController(self.ladder, **kw)

    def rung_ladder(self, **overrides):
        """The pruned ladder as executable engine Rungs (plans of
        MeshChoices, with ``mesh_shape=None``, or of the Rungs that
        ``core.profiler.profile_rung`` measured — SoC CoreChoices have no
        step)."""
        from repro_torch.engine.rungs import rungs_from_ladder
        return rungs_from_ladder(self.ladder, **overrides)

    @property
    def explored_names(self) -> List[str]:
        return [p.name for p in self.profiles]


class ExplorationState:
    """Per-device incremental exploration (paper §4.1 'Monitoring' +
    'Exploring Execution Choices'): explores only while idle & discharging."""

    def __init__(self, choices: Sequence, profiler: Callable):
        self.pending = list(choices)
        self.profiler = profiler
        self.done: List[ChoiceProfile] = []

    @property
    def complete(self) -> bool:
        return not self.pending

    def explore_one(self, *, idle: bool = True, discharging: bool = True) -> Optional[ChoiceProfile]:
        if not idle or not discharging or self.complete:
            return None
        choice = self.pending.pop(0)
        prof = self.profiler(choice)
        self.done.append(prof)
        return prof


def explore_soc(device: str, workload: str,
                choices: Optional[Sequence[CoreChoice]] = None) -> SwanPlan:
    model = E.SOC_MODELS[device]
    choices = choices if choices is not None else enumerate_core_choices(model)
    profiles = [profile_soc_choice(c, model, workload) for c in choices]
    lad = ladder(profiles)
    return SwanPlan(workload=workload, device=device, profiles=profiles,
                    ladder=lad, selected=pick_fastest(profiles))


def fleet_explore(device: str, workload: str, n_devices: int) -> Dict[int, List[str]]:
    """§4.2 coordinator amortization: split the choice list among same-model
    devices; returns {device_rank: [choice names to explore]}."""
    model = E.SOC_MODELS[device]
    choices = enumerate_core_choices(model)
    assignment: Dict[int, List[str]] = {i: [] for i in range(n_devices)}
    for i, c in enumerate(choices):
        assignment[i % n_devices].append(c.name)
    return assignment


def merge_fleet_profiles(parts: Sequence[Sequence[ChoiceProfile]]) -> List[ChoiceProfile]:
    """Merge per-device exploration shards (dedupe by choice name, keep the
    median-latency report to resist stragglers/outliers)."""
    by_name: Dict[str, List[ChoiceProfile]] = {}
    for shard in parts:
        for p in shard:
            by_name.setdefault(p.name, []).append(p)
    merged = []
    for name, ps in by_name.items():
        ps = sorted(ps, key=lambda p: p.latency_s)
        merged.append(ps[len(ps) // 2])
    return total_order(merged)


def plan_from_profiles(workload: str, device: str,
                       profiles: Sequence[ChoiceProfile],
                       *, objective: str = "fastest",
                       memory_limit: Optional[int] = None) -> SwanPlan:
    lad = ladder(list(profiles))
    sel = (pick_most_efficient(profiles, memory_limit=memory_limit)
           if objective == "efficient"
           else pick_fastest(profiles, memory_limit=memory_limit))
    return SwanPlan(workload=workload, device=device, profiles=list(profiles),
                    ladder=lad, selected=sel)
