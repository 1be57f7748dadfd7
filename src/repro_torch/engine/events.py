"""Event sources the TrainSession reacts to.

Three kinds, matching the paper's migration triggers:

- InterferenceTrace: synthetic co-tenant bursts (the ``--interference-trace``
  CLI flag). A burst multiplies the *observed* step latency the controller
  sees; how much of it a rung actually feels is scaled by that rung's
  ``interference_sensitivity`` — downgrading relinquishes the contended
  resource, so cheap rungs see a smaller multiplier (paper Fig. 4b / Table 3).
- ThermalTrace (paper §3.3): sustained-load throttling with its own
  hysteresis constants. Unlike a scripted burst it is *closed-loop*: heat
  accumulates with the active rung's power draw (proxied by its
  interference sensitivity), the throttle engages above ``trigger_temp``
  and — crucially — releases only below ``release_temp`` < trigger, so the
  slowdown persists until a downgrade actually sheds enough heat.
- Device-loss events (FaultModel-sampled or scripted): hard interference that
  routes through SwanController.force_downgrade and forces a remesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.fault import FaultModel


@dataclasses.dataclass(frozen=True)
class Burst:
    start: int  # first slowed step (inclusive)
    stop: int  # first clean step again (exclusive)
    slowdown: float  # latency multiplier at full sensitivity

    def active(self, step: int) -> bool:
        return self.start <= step < self.stop


@dataclasses.dataclass(frozen=True)
class InterferenceTrace:
    bursts: Tuple[Burst, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "InterferenceTrace":
        """Parse ``"start:stop:slowdown[,start:stop:slowdown...]"``,
        e.g. ``"40:80:2.5,120:140:3"``."""
        bursts = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(f"bad burst {part!r}; want start:stop:slowdown")
            start, stop, slow = int(fields[0]), int(fields[1]), float(fields[2])
            if stop <= start or slow < 1.0:
                raise ValueError(f"bad burst {part!r}: need stop>start, slowdown>=1")
            bursts.append(Burst(start, stop, slow))
        return cls(tuple(sorted(bursts, key=lambda b: b.start)))

    def slowdown(self, step: int) -> float:
        """Full-sensitivity multiplier at ``step`` (max over active bursts)."""
        active = [b.slowdown for b in self.bursts if b.active(step)]
        return max(active) if active else 1.0

    def effective_slowdown(self, step: int, sensitivity: float) -> float:
        """Multiplier actually felt by a rung with the given sensitivity."""
        return 1.0 + (self.slowdown(step) - 1.0) * sensitivity

    def active(self, step: int) -> bool:
        return self.slowdown(step) > 1.0

    def to_json(self) -> List[dict]:
        return [dataclasses.asdict(b) for b in self.bursts]


@dataclasses.dataclass
class ThermalTrace:
    """Closed-loop thermal throttling (paper §3.3).

    A normalized die temperature integrates ``heat_rate * sensitivity``
    (the active rung's power draw) against a constant ``cool_rate`` each
    step. Hysteresis: the throttle engages when temperature crosses
    ``trigger_temp`` and releases only once it has fallen below
    ``release_temp`` — a downgraded rung whose heat generation drops under
    ``cool_rate`` therefore *recovers* after a cooling interval, while a
    rung that keeps burning stays throttled indefinitely. This is the
    dynamic a step-scripted burst cannot express: the slowdown's duration
    depends on what the controller migrates to.

    Stateful: ``effective_slowdown`` advances the simulation one step per
    call, in step order — exactly how TrainSession drives its trace.
    """
    heat_rate: float = 0.05     # temp gained per step at sensitivity 1.0
    cool_rate: float = 0.02     # temp shed per step, always
    slowdown: float = 2.5       # throttle multiplier at full sensitivity
    trigger_temp: float = 1.0   # throttle engages at/above this
    release_temp: float = 0.5   # ...and releases at/below this (hysteresis)
    temp: float = dataclasses.field(default=0.0, init=False)
    throttled: bool = dataclasses.field(default=False, init=False)
    _last_step: int = dataclasses.field(default=-1, init=False)

    def __post_init__(self):
        if self.heat_rate <= 0 or self.cool_rate <= 0:
            raise ValueError("heat_rate and cool_rate must be > 0")
        if self.slowdown < 1.0:
            raise ValueError(f"slowdown must be >= 1, got {self.slowdown}")
        if not 0 <= self.release_temp < self.trigger_temp:
            raise ValueError("need 0 <= release_temp < trigger_temp")

    @classmethod
    def parse(cls, spec: str) -> "ThermalTrace":
        """Parse ``"heat:cool:slowdown"`` or
        ``"heat:cool:slowdown:trigger:release"`` (the ``--thermal-trace``
        flag), e.g. ``"0.05:0.02:2.5"``."""
        fields = [f.strip() for f in spec.split(":")]
        if len(fields) not in (3, 5):
            raise ValueError(f"bad thermal spec {spec!r}; want "
                             f"heat:cool:slowdown[:trigger:release]")
        heat, cool, slow = (float(f) for f in fields[:3])
        kw = {}
        if len(fields) == 5:
            kw = {"trigger_temp": float(fields[3]),
                  "release_temp": float(fields[4])}
        return cls(heat_rate=heat, cool_rate=cool, slowdown=slow, **kw)

    def effective_slowdown(self, step: int, sensitivity: float) -> float:
        """Advance to ``step`` under the active rung's power draw; return the
        latency multiplier that rung observes.

        The thermal state advances at most once per distinct ``step`` (the
        first call's sensitivity is the power draw that heats the die), so
        re-evaluating the same step for several candidate rungs — the
        adaptive-vs-static curve pattern — reads the throttle without
        secretly re-heating it."""
        if step != self._last_step:
            self._last_step = step
            self.temp = max(0.0, self.temp
                            + self.heat_rate * sensitivity - self.cool_rate)
            if not self.throttled and self.temp >= self.trigger_temp:
                self.throttled = True
            elif self.throttled and self.temp <= self.release_temp:
                self.throttled = False
        if not self.throttled:
            return 1.0
        return 1.0 + (self.slowdown - 1.0) * sensitivity

    def active(self, step: int) -> bool:
        return self.throttled

    def to_json(self) -> dict:
        return {"heat_rate": self.heat_rate, "cool_rate": self.cool_rate,
                "slowdown": self.slowdown, "trigger_temp": self.trigger_temp,
                "release_temp": self.release_temp}


@dataclasses.dataclass(frozen=True)
class ChargingTrace:
    """Charger plug/unplug schedule: ``(start, stop, watts)`` intervals.

    While an interval is active the runtime repays the shared EnergyLoan at
    ``watts`` joules per tick (the same normalized units jobs borrow in), so
    a recharging battery walks the loan back under critical and re-enables
    rung upgrades — the recovery half of the paper's energy-loan accounting
    (§5.1), which ``repay_daily`` only models at day granularity.
    """
    intervals: Tuple[Tuple[int, int, float], ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "ChargingTrace":
        """Parse ``"start:stop:watts[,start:stop:watts...]"``,
        e.g. ``"40:80:5"`` (the ``--charging-trace`` flag)."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(f"bad charge interval {part!r}; want "
                                 f"start:stop:watts")
            start, stop, watts = int(fields[0]), int(fields[1]), float(fields[2])
            if stop <= start or watts <= 0:
                raise ValueError(f"bad charge interval {part!r}: need "
                                 f"stop>start, watts>0")
            out.append((start, stop, watts))
        return cls(tuple(sorted(out)))

    def rate(self, tick: int) -> float:
        """Charger watts at ``tick`` (0.0 = unplugged)."""
        return sum(w for a, b, w in self.intervals if a <= tick < b)

    def active(self, tick: int) -> bool:
        return self.rate(tick) > 0.0

    def to_json(self) -> List[dict]:
        return [{"start": a, "stop": b, "watts": w}
                for a, b, w in self.intervals]


@dataclasses.dataclass(frozen=True)
class DeviceLossEvent:
    step: int
    device_ids: Tuple[int, ...]


class ScriptedFaults:
    """Deterministic device-loss schedule: {step: (device ids to fail)}."""

    def __init__(self, schedule: Dict[int, Sequence[int]]):
        self.schedule = {int(k): tuple(v) for k, v in schedule.items()}

    def __call__(self, step: int, healthy_ids: Sequence[int]
                 ) -> Tuple[int, ...]:
        ids = self.schedule.get(step, ())
        return tuple(i for i in ids if i in set(healthy_ids))


class FaultModelEvents:
    """Adapter from runtime.fault.FaultModel's per-step sampling to the
    session's event callback."""

    def __init__(self, fault_model: FaultModel):
        self.fault_model = fault_model

    def __call__(self, step: int, healthy_ids: Sequence[int]
                 ) -> Tuple[int, ...]:
        healthy_ids = list(healthy_ids)
        mask = self.fault_model.step_failures(len(healthy_ids))
        return tuple(i for i, dead in zip(healthy_ids, mask) if dead)
