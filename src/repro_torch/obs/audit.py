"""Arbiter decision audit: why did the runtime migrate that job?

Every propose/commit/veto in ``SwanRuntime`` — plus the non-arbitrated
migration paths (energy walk-down, foreground pause/resume, device loss)
— records the full scoring context that decided it: relinquish scores per
candidate job, SLO headroom, pending proposals, the energy-loan state, the
thermal reading, and which arbitration rule fired. "Why did serve
downgrade at tick 41" becomes ``log.for_tick(41)`` instead of a debugging
session.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.obs.schema import encode_record, versioned


@dataclasses.dataclass
class AuditRecord:
    tick: int
    job: str
    # "commit": migration applied; "veto": arbiter chose the job but the
    # controller refused (ladder edge / cooldown); "pause"/"resume":
    # foreground preemption; "device-loss": fault-path remesh/degrade.
    event: str
    direction: str = ""          # "down" | "up" | ""
    rule: str = ""               # which rule fired (timeline reason string)
    from_rung: str = ""
    to_rung: str = ""
    # full scoring context at decision time
    scores: Dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    slo_headroom: Dict[str, Optional[float]] = dataclasses.field(
        default_factory=dict)
    proposals: Dict[str, str] = dataclasses.field(default_factory=dict)
    energy: Optional[Dict] = None    # {"loan_j", "available", "battery_level"}
    thermal: Optional[Dict] = None   # {"temp", "throttled"}
    detail: str = ""


class AuditLog:
    def __init__(self, max_records: int = 100_000):
        self.max_records = max_records
        self.dropped = 0
        self._records: List[AuditRecord] = []
        self._lock = threading.Lock()

    def record(self, **kw) -> Optional[AuditRecord]:
        rec = AuditRecord(**kw)
        with self._lock:
            if len(self._records) >= self.max_records:
                self.dropped += 1
                return None
            self._records.append(rec)
        return rec

    def records(self) -> List[AuditRecord]:
        with self._lock:
            return list(self._records)

    def recent(self, n: int = 20) -> List[AuditRecord]:
        with self._lock:
            return list(self._records[-n:])

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def for_tick(self, tick: int) -> List[AuditRecord]:
        return [r for r in self.records() if r.tick == tick]

    def for_job(self, job: str) -> List[AuditRecord]:
        return [r for r in self.records() if r.job == job]

    def commits(self) -> List[AuditRecord]:
        return [r for r in self.records() if r.event == "commit"]

    def to_json(self) -> Dict:
        return versioned({
            "dropped": self.dropped,
            "records": [encode_record(r) for r in self.records()],
        })

    @classmethod
    def from_json(cls, payload: Dict) -> "AuditLog":
        log = cls()
        log.dropped = int(payload.get("dropped", 0))
        for rec in payload.get("records", []):
            log.record(**{k: v for k, v in rec.items()})
        return log
