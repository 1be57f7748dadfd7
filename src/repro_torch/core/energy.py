"""Smartphone SoC power and energy models: a copy of the SoC half of the JAX
package's ``core/energy.py``.

Smartphone SoCs (the paper's §5 devices): per-core-class throughput/power
synthesized to reproduce the paper's published *relative* behavior —
Fig. 1b core ordering, Fig. 2's power<->energy inversion (O1), the
depthwise cache-thrash slowdown (O2), and Table 2's speedup bands (O3).
GreenHub raw data and the physical phones are unavailable; constants are
calibrated so benchmarks land inside the paper's reported ranges, which is
the strongest reproduction available (DESIGN.md §8). The baseline's lack
of affinity pinning appears as ``migration_penalty`` (the paper's own
implementation insight: Swan pins threads via sched_setaffinity, stock
PyTorch does not).

The reference's TPU v5e constants and ``tpu_power`` are left out: they serve
only its HLO roofline profiler, which the port does not have.

Energy-loan accounting (paper §5.1 "Real-world energy budget"): daily charger
income and daily non-FL usage are fixed per device; the loan tracks FL energy
and a device is unavailable whenever trace_level - loan would cross the
critical battery level.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


# --- Smartphone SoC models ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoreClass:
    name: str  # little | big | prime
    gflops: float  # effective matmul throughput per core
    power_w: float  # active power per core


@dataclasses.dataclass(frozen=True)
class SocModel:
    name: str
    cores: Tuple[CoreClass, ...]  # one entry PER core, index = core id
    base_power_w: float  # screen-off platform power
    battery_j: float
    thrash_coef: float  # depthwise cache-thrash coefficient (device-specific)
    migration_penalty: float  # unpinned-baseline slowdown (1.0 = none)
    parallel_overhead: float = 0.04  # OMP sync cost per extra thread

    @property
    def core_ids(self) -> Tuple[int, ...]:
        return tuple(range(len(self.cores)))

    def classes(self) -> Dict[str, Tuple[int, ...]]:
        out: Dict[str, list] = {}
        for i, c in enumerate(self.cores):
            out.setdefault(c.name, []).append(i)
        return {k: tuple(v) for k, v in out.items()}


def _soc(name, n_little, little_gf, n_big, big_gf, n_prime, prime_gf,
         little_w, big_w, prime_w, base_w, battery_j, thrash, mig):
    cores = tuple([CoreClass("little", little_gf, little_w)] * n_little
                  + [CoreClass("big", big_gf, big_w)] * n_big
                  + [CoreClass("prime", prime_gf, prime_w)] * n_prime)
    return SocModel(name, cores, base_w, battery_j, thrash, mig)


# Calibrated per DESIGN.md §8; relative core ordering follows paper Fig. 1b,
# thrash/migration constants solved in closed form against Table 2 speedups.
SOC_MODELS: Dict[str, SocModel] = {
    "pixel3": _soc("pixel3", 4, 0.5, 4, 3.2, 0, 0.0,
                   0.25, 1.6, 0.0, 0.8, 40e3, thrash=2.01, mig=1.0),
    "s10e": _soc("s10e", 4, 0.55, 3, 5.5, 1, 6.5,
                 0.3, 2.0, 3.5, 0.9, 43e3, thrash=20.4, mig=2.1),
    "oneplus8": _soc("oneplus8", 4, 0.6, 3, 6.0, 1, 7.2,
                     0.3, 2.1, 3.6, 0.9, 60e3, thrash=8.56, mig=2.1),
    "mi10": _soc("mi10", 4, 0.6, 3, 6.1, 1, 7.3,
                 0.3, 2.1, 3.6, 0.9, 66e3, thrash=8.68, mig=2.1),
    "tab_s6": _soc("tab_s6", 4, 0.55, 3, 5.6, 1, 6.6,
                   0.3, 2.0, 3.5, 1.0, 98e3, thrash=12.0, mig=1.9),
}

# workload memory-intensity (fraction of time in depthwise-like memory-bound
# ops; drives O2): resnet is matmul-dominated, shuffle/mobile are depthwise.
WORKLOAD_MEM_INTENSITY = {"resnet34": 0.01, "mobilenet-v2": 0.733, "shufflenet-v2": 0.9}
# per-sample forward+backward GFLOPs at batch 16 (relative scale is what matters)
WORKLOAD_GFLOPS_PER_STEP = {"resnet34": 18.0, "mobilenet-v2": 2.5, "shufflenet-v2": 1.9}


# --- battery / energy loan ----------------------------------------------------

@dataclasses.dataclass
class EnergyLoan:
    """Paper §5.1: fixed daily charger income & usage; FL energy is a loan.

    The device is unavailable whenever applying the loan to the trace's
    battery level would put it below the critical level.
    """
    battery_j: float
    daily_charge_j: float
    daily_usage_j: float
    critical_frac: float = 0.15
    loan_j: float = 0.0

    def borrow(self, joules: float) -> None:
        self.loan_j += joules

    def repay(self, joules: float) -> None:
        """Pay the loan down by ``joules`` (a charger tick; the runtime calls
        this while a ChargingTrace is active). The loan never goes negative —
        charging beyond the loan tops the battery, it does not bank credit."""
        self.loan_j = max(0.0, self.loan_j - max(joules, 0.0))

    def repay_daily(self) -> None:
        surplus = max(self.daily_charge_j - self.daily_usage_j, 0.0)
        self.loan_j = max(0.0, self.loan_j - surplus)

    def available(self, trace_level_frac: float) -> bool:
        effective = trace_level_frac - self.loan_j / self.battery_j
        return effective > self.critical_frac
