"""SocJob: the unit of work the SwanRuntime arbiter schedules.

A copy of the JAX package's ``engine/jobs.py`` up to its serving half:
:class:`StepReport`, :func:`trace_latency_fn` and the :class:`SocJob`
protocol, which hold no framework code. ``ServeRung``/``ServeJob`` (serving
under the arbiter) and ``ForegroundAppJob`` (foreground preemption) are not
ported yet.

A ``SocJob`` exposes a **rung ladder** (``rungs()``), fastest/costliest
first, each rung carrying an ``interference_sensitivity`` and a
``rel_latency``; it executes one scheduling quantum at a time (``step(tick)``
-> :class:`StepReport`), reports what its monitor sees (``observe``), and
can **migrate** between rungs without restarting (``migrate``). Every job is
``RUNNING``, ``PAUSED`` (preempted: skipped entirely; a paused
:class:`~repro_torch.engine.session.TrainSession` checkpoints and releases
its state and resumes at the exact pre-pause step) or ``DRAINING``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.controller import SwanController
from repro_torch.core.cost import ChoiceProfile, ladder_sensitivities
from repro_torch.engine.timeline import MigrationRecord, Timeline

RUNNING = "RUNNING"
PAUSED = "PAUSED"
DRAINING = "DRAINING"


@dataclasses.dataclass
class StepReport:
    """What one scheduling quantum of a job produced. (Job completion is the
    ``SocJob.done`` property, polled by the runtime — not part of the
    report.)"""
    latency_s: float  # wall time of the quantum
    work: float = 0.0  # goodput units (samples trained / tokens emitted)
    loss: Optional[float] = None  # training jobs report their loss
    warmup: bool = False  # first quantum on a rung (compile tail)
    observed_s: Optional[float] = None  # filled in by observe()
    # paged serving: fraction of the KV block pool in use at this quantum
    # (None for jobs without a pool) — the arbiter-visible memory-pressure
    # signal that complements latency
    pool_pressure: Optional[float] = None


def trace_latency_fn(trace):
    """Deterministic ``latency_fn`` for benchmarks/tests: each rung's planner
    estimate scaled by the trace's slowdown at that rung's sensitivity —
    what a real measurement would observe, minus machine noise. Every rung
    needs ``latency_estimate_s``."""
    def fn(step, rung, dt):
        eff = trace.effective_slowdown(step, rung.interference_sensitivity) \
            if trace is not None else 1.0
        return rung.latency_estimate_s * eff
    return fn


class SocJob:
    """Base/protocol for runtime-schedulable jobs.

    Subclasses must provide ``name``, ``priority``, ``controller`` (a
    SwanController over the ladder), ``timeline``, ``rungs()``, ``done``,
    ``step``, ``observe`` and ``migrate``; the arbitration helpers below are
    derived. Rung entries only need ``name``, ``interference_sensitivity``
    and ``rel_latency`` attributes (``power_draw`` optional — defaults to the
    sensitivity, the same power proxy ThermalTrace integrates).
    """

    name: str = "job"
    priority: float = 1.0
    controller: SwanController
    timeline: Timeline
    state: str = RUNNING
    # a foreground burst may pause this job outright (background work)
    preemptible: bool = False
    # this job IS the foreground app: while it demands the SoC, the runtime
    # pauses every preemptible co-tenant
    is_foreground: bool = False

    # -- ladder --------------------------------------------------------------
    def rungs(self) -> Sequence[Any]:
        raise NotImplementedError

    @property
    def rung_idx(self) -> int:
        return self.controller.idx

    @property
    def active_rung(self):
        return self.rungs()[self.rung_idx]

    def sensitivity(self) -> float:
        return float(self.active_rung.interference_sensitivity)

    def power_draw(self) -> float:
        """Power this job's active rung draws (normalized units); the runtime
        sums this across jobs to heat the shared ThermalTrace and to charge
        the EnergyLoan."""
        p = getattr(self.active_rung, "power_draw", None)
        return float(p) if p is not None else self.sensitivity()

    def can_downgrade(self) -> bool:
        return self.controller.can_downgrade()

    def can_upgrade(self) -> bool:
        return self.controller.can_upgrade()

    def relinquish_score(self) -> float:
        """Arbitration score for downgrading this job one rung: contended
        resource relinquished per fraction of goodput lost, discounted by
        priority. Under pressure the runtime downgrades the argmax — the job
        that gives the co-tenants the most relief at the least cost."""
        rungs = self.rungs()
        i = self.rung_idx
        if i + 1 >= len(rungs):
            return float("-inf")
        a, b = rungs[i], rungs[i + 1]
        dsens = max(0.0, float(a.interference_sensitivity)
                    - float(b.interference_sensitivity))
        # goodput fraction lost stepping down: rate ~ 1/rel_latency. Floored
        # at 1% so a ladder that declares identical rel_latency (a "free"
        # downgrade) still scores on a scale a co-tenant's sensitivity gap
        # and priority can compete with, instead of winning every auction
        lost = max(0.01, 1.0 - float(a.rel_latency) / float(b.rel_latency))
        return dsens / (lost * max(float(self.priority), 1e-9))

    # -- SLO -----------------------------------------------------------------
    def slo_headroom(self) -> Optional[float]:
        """Fraction of the latency SLO still unspent (negative = violating;
        ``None`` = this job carries no SLO). The runtime arbitrates on this:
        a violator's co-tenants are downgraded first, and upgrades are held
        while any job is in violation."""
        return None

    # -- lifecycle -----------------------------------------------------------
    @property
    def done(self) -> bool:
        raise NotImplementedError

    @property
    def paused(self) -> bool:
        return self.state == PAUSED

    def pause(self, tick: int) -> None:
        """Preempt this job (foreground burst / explicit request). Idempotent;
        subclasses override :meth:`on_pause` to checkpoint and release
        resources."""
        if self.state == PAUSED:
            return
        self.on_pause(tick)
        self.state = PAUSED

    def resume(self, tick: int) -> None:
        """Undo :meth:`pause`; subclasses override :meth:`on_resume` to
        restore released state (the pre-pause step, exactly)."""
        if self.state != PAUSED:
            return
        self.on_resume(tick)
        self.state = RUNNING

    def drain(self, tick: int = 0) -> None:
        """Stop taking on new work; finish what is in flight."""
        if self.state == RUNNING:
            self.state = DRAINING

    def publish_metrics(self, metrics) -> None:
        """Export this job's gauges/counters into a ``repro_torch.obs``
        MetricsRegistry (called once per tick by the runtime while
        telemetry is enabled). Default: nothing to export."""

    def on_pause(self, tick: int) -> None:
        """Checkpoint / release resources before the pause takes effect."""

    def on_resume(self, tick: int) -> None:
        """Reacquire resources released by :meth:`on_pause`."""

    def prepare(self) -> None:
        """Called once before the first tick (idempotent)."""

    def begin_tick(self, tick: int) -> None:
        """Called at the top of every runtime tick (before the power sum),
        for every unfinished, unpaused job."""

    def step(self, tick: int) -> StepReport:
        raise NotImplementedError

    def observe(self, tick: int, report: StepReport,
                slowdown: float) -> Optional[str]:
        """Digest one quantum: compute the observed latency (wall x the
        shared-trace slowdown for this job's sensitivity), record it, and
        return the monitor's proposal ("down" | "up" | None). The runtime
        arbitrates across jobs before anything is committed."""
        raise NotImplementedError

    def migrate(self, direction: str, reason: str,
                tick: int) -> Optional[MigrationRecord]:
        """Commit an arbitrated proposal: switch rungs and carry state."""
        raise NotImplementedError

    def on_device_loss(self, tick: int, failed: Sequence[int]) -> None:
        """Devices vanished from the shared pool. Mesh-backed jobs remesh;
        single-device jobs (serving) keep streaming."""

    def end_tick(self, tick: int) -> None:
        """Post-arbitration bookkeeping (logging, periodic checkpoints)."""

    def finalize(self) -> None:
        """Called once when the runtime loop ends."""

    # -- shared monitor policy ------------------------------------------------
    # (subclasses provide ``adaptive``, ``latency_fn`` and ``_expected``:
    # rung name -> calibrated clean latency)

    def _monitor_proposal(self, report: StepReport, rung,
                          dt: float, observed: float) -> Optional[str]:
        """Feed policy shared by every job: non-adaptive jobs never propose;
        in wall-clock mode the first step on a rung is discarded (it pays
        the compile/migration tail — and counts as the controller's
        post-migration skip, so a second, clean sample is not dropped too)
        and the rung's clean latency is calibrated from the first steady
        measurement."""
        if not self.adaptive:
            return None
        feed = True
        if self.latency_fn is None:
            if report.warmup:
                feed = False
                self.controller.note_external_skip()
            elif rung.name not in self._expected:
                # calibrate this rung's clean latency from the wall
                # measurement. Synthetic traces never slow the actual
                # machine, so dt is clean even mid-burst; under real
                # interference (no trace) a rung first visited while
                # pressured calibrates high, which only delays detection
                # until the post-clear upgrade re-visits it
                self._expected[rung.name] = dt
                self.controller.calibrate(dt)
        return self.controller.propose(observed) if feed else None

    def _recalibrate(self, from_rung, to_rung) -> Optional[float]:
        """Re-anchor the monitor after a migration: prefer the target rung's
        own calibration, else scale the departing rung's by the ladder's
        relative latencies. Returns the expectation installed (if any)."""
        expected = self._expected.get(to_rung.name)
        if expected is None:
            base = self._expected.get(from_rung.name)
            if base is not None and from_rung.rel_latency > 0:
                expected = base * (to_rung.rel_latency / from_rung.rel_latency)
        if expected is not None:
            self.controller.calibrate(expected)
        return expected

