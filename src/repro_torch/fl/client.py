"""The standardized client interface (paper §4.1): isActive + run_local_step.

A SwanClient owns: a device model, a battery trace + energy loan, a Swan plan
(explored execution-choice profiles) and a controller. ``run_local_step``
returns the wall-time and energy its active execution choice costs — the FL
simulator charges these against the loan; the distributed-framework
standard-interface contract (PySyft-style) is exactly these two methods.

A copy of the JAX package's ``fl/client.py`` over the port's planner
(``core.planner.explore_soc``, ``core.profiler.greedy_baseline_profile``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import energy as E
from repro_torch.core.controller import SwanController
from repro_torch.core.planner import SwanPlan, explore_soc
from repro_torch.core.profiler import greedy_baseline_profile
from repro_torch.fl.traces import BatteryTrace


@dataclasses.dataclass
class LocalStepReport:
    latency_s: float
    energy_j: float
    choice_name: str


class SwanClient:
    def __init__(self, cid: int, device: str, trace: BatteryTrace, workload: str,
                 *, policy: str = "swan", n_samples: int = 200,
                 local_steps: int = 10, seed: int = 0):
        self.cid = cid
        self.device = device
        self.model = E.SOC_MODELS[device]
        self.trace = trace
        self.workload = workload
        self.policy = policy
        self.n_samples = n_samples
        self.local_steps = local_steps
        self.loan = E.EnergyLoan(
            battery_j=self.model.battery_j,
            daily_charge_j=0.55 * self.model.battery_j,
            daily_usage_j=0.5 * self.model.battery_j)
        if policy == "swan":
            self.plan: SwanPlan = explore_soc(device, workload)
            self.controller: Optional[SwanController] = self.plan.controller()
            self._profile = self.plan.selected
        else:  # PyTorch-greedy baseline (§5.1)
            self._profile = greedy_baseline_profile(self.model, workload)
            self.plan = None
            self.controller = None
        self._rng = np.random.default_rng(seed + cid)

    # -- standardized interface ------------------------------------------------
    def isActive(self, minute: float) -> bool:
        level, state = self.trace.at(minute)
        if not self.loan.available(level):
            return False
        # accept while charging, or above minimum level (paper §4.1 step 3)
        return state >= 0 or level > 0.35

    def run_local_step(self, minute: float, *, interference: float = 0.0) -> LocalStepReport:
        """One local training round (local_steps mini-batches)."""
        prof = self._profile
        if self.controller is not None and interference > 0:
            # observed latency inflated by the interferer -> controller migrates
            observed = prof.latency_s * (1.0 + interference)
            prof = self.controller.observe_step(observed)
            self._profile = prof
        elif self.controller is not None:
            prof = self.controller.observe_step(prof.latency_s)
            self._profile = prof
        jitter = self._rng.uniform(0.95, 1.1)
        lat = prof.latency_s * self.local_steps * jitter
        energy = prof.energy_j * self.local_steps * jitter
        level, state = self.trace.at(minute)
        if state <= 0:  # only discharging time draws the loan
            self.loan.borrow(energy)
        return LocalStepReport(latency_s=lat, energy_j=energy, choice_name=prof.name)

    def end_of_day(self):
        self.loan.repay_daily()
