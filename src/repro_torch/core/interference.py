"""Interference inference without privileged access (paper §4.1).

Android sandboxing denies /proc, so Swan infers interference purely from its
own observed step latency vs. the explored profile. Same mechanism here: an
EWMA of observed step time compared against the active choice's expected
latency. Severity > 0 means some co-tenant (foreground app there, co-tenant
job / straggling node here) wants the resources; the controller downgrades.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class InterferenceMonitor:
    expected_latency_s: float
    ewma_alpha: float = 0.3
    trigger_ratio: float = 1.25  # observed/expected above this => interference
    clear_ratio: float = 1.08  # below this => clear
    _ewma: Optional[float] = None

    def observe(self, latency_s: float) -> float:
        if self._ewma is None:
            self._ewma = latency_s
        else:
            self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * latency_s
        return self.severity

    @property
    def severity(self) -> float:
        """0 = clean; >0 = fractional slowdown beyond the trigger."""
        if self._ewma is None:
            return 0.0
        ratio = self._ewma / max(self.expected_latency_s, 1e-12)
        return max(0.0, ratio - 1.0)

    @property
    def interfering(self) -> bool:
        if self._ewma is None:
            return False
        return self._ewma / max(self.expected_latency_s, 1e-12) >= self.trigger_ratio

    @property
    def clear(self) -> bool:
        if self._ewma is None:
            return True
        return self._ewma / max(self.expected_latency_s, 1e-12) <= self.clear_ratio

    def rebase(self, expected_latency_s: float) -> None:
        """After migrating to a new choice, expectations change."""
        self.expected_latency_s = expected_latency_s
        self._ewma = None
