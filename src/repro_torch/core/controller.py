"""Swan's control loop (paper Fig. 4b): migrate between pruned choices.

Downgrade on inferred interference (relinquish compute to the interferer),
upgrade after a sustained clear window (hysteresis avoids flapping). The
ladder comes from core/cost.pareto_prune, so each downgrade step is guaranteed
to free resources the interferer wants — that is the invariant pruning buys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.cost import ChoiceProfile
from repro_torch.core.interference import InterferenceMonitor


@dataclasses.dataclass
class Migration:
    step: int
    from_idx: int
    to_idx: int
    reason: str


class SwanController:
    def __init__(self, ladder: List[ChoiceProfile], *, upgrade_patience: int = 5,
                 on_migrate: Optional[Callable] = None):
        if not ladder:
            raise ValueError("empty choice ladder")
        self.ladder = ladder  # index 0 = fastest/costliest
        self.idx = 0
        self.upgrade_patience = upgrade_patience
        self.on_migrate = on_migrate
        self.monitor = InterferenceMonitor(ladder[0].latency_s)
        self.migrations: List[Migration] = []
        self._clear_streak = 0
        self._step = 0
        self._skip_next = False

    @property
    def active(self) -> ChoiceProfile:
        return self.ladder[self.idx]

    def can_downgrade(self) -> bool:
        return self.idx + 1 < len(self.ladder)

    def can_upgrade(self) -> bool:
        return self.idx > 0

    def _migrate(self, new_idx: int, reason: str):
        if new_idx == self.idx:
            return
        self.migrations.append(Migration(self._step, self.idx, new_idx, reason))
        self.idx = new_idx
        self.monitor.rebase(self.active.latency_s)
        self._clear_streak = 0
        # the first sample on the new choice carries the migration's own tail
        # (compile, remesh transfer); observing it would re-anchor the monitor
        # on a one-off spike and immediately re-migrate
        self._skip_next = True
        if self.on_migrate:
            self.on_migrate(self.active, reason)

    def propose(self, observed_latency_s: float) -> Optional[str]:
        """Feed one observed local-step latency and return what this choice's
        monitor *wants* — ``"down"``, ``"up"`` or ``None`` — without
        migrating. An arbiter (engine/runtime.SwanRuntime) collects proposals
        across co-tenant jobs and commits at most one; a vetoed proposal
        keeps its monitor state, so persistent pressure re-proposes next
        step. The first sample after a migration is skipped (see _migrate)."""
        self._step += 1
        if self._skip_next:
            self._skip_next = False
            return None
        self.monitor.observe(observed_latency_s)
        if self.monitor.interfering:
            # a pressured step never counts toward the upgrade patience —
            # even when the proposal is vetoed or the ladder is bottomed out
            self._clear_streak = 0
            return "down" if self.can_downgrade() else None
        if self.monitor.clear:
            self._clear_streak += 1
            if self._clear_streak >= self.upgrade_patience and self.can_upgrade():
                return "up"
        else:
            self._clear_streak = 0
        return None

    def note_external_skip(self) -> None:
        """The caller discarded a post-migration sample itself (e.g. the
        session's wall-clock warmup-step skip); don't drop a second, clean
        sample on top of it."""
        self._skip_next = False

    def commit(self, direction: str, reason: str) -> ChoiceProfile:
        """Apply a proposal (the arbiter's accept path)."""
        if direction == "down" and self.can_downgrade():
            self._migrate(self.idx + 1, reason)
        elif direction == "up" and self.can_upgrade():
            self._migrate(self.idx - 1, reason)
        return self.active

    def observe_step(self, observed_latency_s: float) -> ChoiceProfile:
        """Feed one observed local-step latency; returns the (possibly new)
        active choice for the next step (propose + self-commit — the
        single-job path with no arbiter in the loop)."""
        proposal = self.propose(observed_latency_s)
        if proposal == "down":
            return self.commit("down", "interference")
        if proposal == "up":
            return self.commit("up", "clear")
        return self.active

    def force_downgrade(self, reason: str = "external") -> ChoiceProfile:
        """Hard interference (device loss / preemption notice)."""
        if self.can_downgrade():
            self._migrate(self.idx + 1, reason)
        return self.active

    def calibrate(self, latency_s: float) -> None:
        """Install a *measured* clean-step latency as the active choice's
        expectation. Live engines (engine/session.py) measure real step
        times; ladder profiles only seed the estimate, so the first clean
        steps on each rung re-anchor the monitor here."""
        self.monitor.rebase(latency_s)
