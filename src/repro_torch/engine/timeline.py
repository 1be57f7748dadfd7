"""Machine-readable history of an adaptive training run.

Every migration is recorded as (step, from/to rung, reason, kind, cost), and
every step as (rung, wall latency, observed latency, loss). The benchmark
harness (benchmarks/table3_interference.py) consumes this to plot adaptive vs
static step-time curves, and tests assert on it instead of scraping stdout.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from repro_torch.obs.schema import encode_record, versioned


@dataclasses.dataclass
class MigrationRecord:
    step: int
    from_rung: str
    to_rung: str
    reason: str  # "interference" | "clear" | "device-loss" | "energy" | ...
    kind: str  # "in-place" (state carried over) | "remesh" (ckpt round-trip)
    cost_s: float = 0.0
    cost_steps: int = 0  # migration stall expressed in expected step times
    job: str = ""  # owning SocJob in a merged multi-job runtime timeline


@dataclasses.dataclass
class StepRecord:
    step: int
    rung: str
    latency_s: float  # wall time of the step
    observed_s: float  # latency fed to the interference monitor
    loss: float
    warmup: bool = False  # first step on a rung (includes compile)
    work: float = 0.0  # goodput units this step (samples trained / tokens out)
    job: str = ""  # owning SocJob in a merged multi-job runtime timeline


class Timeline:
    def __init__(self):
        self.migrations: List[MigrationRecord] = []
        self.steps: List[StepRecord] = []

    def record_migration(self, **kw) -> MigrationRecord:
        rec = MigrationRecord(**kw)
        self.migrations.append(rec)
        return rec

    def record_step(self, **kw) -> StepRecord:
        rec = StepRecord(**kw)
        self.steps.append(rec)
        return rec

    # -- merging (multi-job runtimes) ---------------------------------------
    @classmethod
    def merged(cls, tagged: dict) -> "Timeline":
        """Merge per-job timelines ({job_name: Timeline}) into one runtime
        timeline, tagging every record with its owning job and interleaving
        by step index."""
        out = cls()
        for name, tl in tagged.items():
            for s in tl.steps:
                out.steps.append(dataclasses.replace(s, job=name))
            for m in tl.migrations:
                out.migrations.append(dataclasses.replace(m, job=name))
        out.steps.sort(key=lambda s: (s.step, s.job))
        out.migrations.sort(key=lambda m: (m.step, m.job))
        return out

    def for_job(self, job: str) -> "Timeline":
        """Single-job view of a merged timeline."""
        out = Timeline()
        out.steps = [s for s in self.steps if s.job == job]
        out.migrations = [m for m in self.migrations if m.job == job]
        return out

    def jobs(self) -> List[str]:
        seen: List[str] = []
        for r in list(self.steps) + list(self.migrations):
            if r.job and r.job not in seen:
                seen.append(r.job)
        return seen

    # -- views -------------------------------------------------------------
    def step_times(self, *, observed: bool = False) -> List[float]:
        return [s.observed_s if observed else s.latency_s for s in self.steps]

    def rung_at(self, step: int) -> Optional[str]:
        for s in self.steps:
            if s.step == step:
                return s.rung
        return None

    def summary(self) -> dict:
        # a device-loss remesh at the ladder bottom records from == to;
        # that is a migration but not a rung downgrade
        downs = sum(1 for m in self.migrations
                    if m.reason != "clear" and m.from_rung != m.to_rung)
        ups = sum(1 for m in self.migrations if m.reason == "clear")
        steady = [s.latency_s for s in self.steps if not s.warmup]
        out = {
            "n_steps": len(self.steps),
            "n_migrations": len(self.migrations),
            "downgrades": downs,
            "upgrades": ups,
            "remesh_migrations": sum(1 for m in self.migrations
                                     if m.kind == "remesh"),
            "migration_cost_s": round(sum(m.cost_s for m in self.migrations), 6),
            "migration_cost_steps": sum(m.cost_steps for m in self.migrations),
            "mean_step_s": (sum(steady) / len(steady)) if steady else 0.0,
        }
        jobs = self.jobs()
        if jobs:  # merged multi-job timeline: per-job breakdown rides along
            out["jobs"] = {
                j: {"steps": sum(1 for s in self.steps if s.job == j),
                    "work": round(sum(s.work for s in self.steps if s.job == j), 4),
                    "migrations": sum(1 for m in self.migrations if m.job == j)}
                for j in jobs}
        return out

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        # step/migration records go through the shared repro_torch.obs encoder so
        # the whole telemetry plane evolves in one place (schema_version)
        return versioned({
            "migrations": [encode_record(m) for m in self.migrations],
            "steps": [encode_record(s) for s in self.steps],
            "summary": self.summary()})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    @classmethod
    def from_json(cls, payload: dict) -> "Timeline":
        tl = cls()
        for m in payload.get("migrations", ()):
            tl.record_migration(**m)
        for s in payload.get("steps", ()):
            tl.record_step(**s)
        return tl
