"""repro_torch.obs — one telemetry plane for the whole reproduction.

Bundles the three instruments from ISSUE 9 behind a single switch:

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — labeled counters /
  gauges / histograms with shared no-op handles when disabled;
* :class:`~repro_torch.obs.trace.SpanTracer` — thread-safe contextmanager
  spans on monotonic clocks, exported as Chrome-trace JSON;
* :class:`~repro_torch.obs.audit.AuditLog` — the arbiter decision audit.

The process-global instance starts **disabled** (every hot-path call is
an enabled-check + shared no-op object), so importing this module from
kernels/engines costs nothing. CLIs flip it on via :func:`enable` when
``--telemetry-out`` is passed; tests swap it with :func:`set_telemetry`.
Components always fetch it lazily (``obs.get_telemetry()``) so enabling
works regardless of construction order.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.obs.audit import AuditLog, AuditRecord
from repro_torch.obs.metrics import NOOP, MetricsRegistry
from repro_torch.obs.schema import SCHEMA_VERSION, encode_record, versioned
from repro_torch.obs.trace import SpanTracer

__all__ = [
    "SCHEMA_VERSION", "encode_record", "versioned", "NOOP",
    "MetricsRegistry", "SpanTracer", "AuditLog", "AuditRecord",
    "Telemetry", "get_telemetry", "set_telemetry", "enable", "disable",
]


class Telemetry:
    """Metrics + tracer + audit under one enabled flag."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.metrics = MetricsRegistry(enabled=enabled)
        self.tracer = SpanTracer(enabled=enabled)
        self.audit = AuditLog()
        self.snapshots: List[Dict] = []  # per-tick JSONL metric lines

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def snap(self, tick) -> None:
        """Append one flat metrics line for tick ``tick`` (JSONL stream)."""
        if self.enabled:
            self.snapshots.append(self.metrics.snapshot_line(tick))

    # ------------------------------------------------------------------
    def save(self, outdir: str) -> Dict[str, str]:
        """Write the full telemetry bundle under ``outdir``.

        ``metrics.jsonl`` — versioned header line then one line per tick;
        ``spans.jsonl`` — raw span records; ``trace.json`` — Chrome-trace
        (Perfetto-loadable); ``audit.json`` — arbiter decision audit.
        """
        os.makedirs(outdir, exist_ok=True)
        paths = {}

        p = os.path.join(outdir, "metrics.jsonl")
        with open(p, "w") as f:
            f.write(json.dumps(versioned({"stream": "metrics"})) + "\n")
            for line in self.snapshots:
                f.write(json.dumps(encode_record(line)) + "\n")
            # final snapshot so non-tick-driven runs (plain serve loop)
            # still land their terminal metric values in the stream
            f.write(json.dumps(encode_record(
                self.metrics.snapshot_line("final"))) + "\n")
        paths["metrics"] = p

        p = os.path.join(outdir, "spans.jsonl")
        with open(p, "w") as f:
            f.write(json.dumps(versioned({"stream": "spans"})) + "\n")
            for rec in self.tracer.to_records():
                f.write(json.dumps(rec) + "\n")
        paths["spans"] = p

        p = os.path.join(outdir, "trace.json")
        self.tracer.save_chrome_trace(p)
        paths["trace"] = p

        p = os.path.join(outdir, "audit.json")
        with open(p, "w") as f:
            json.dump(self.audit.to_json(), f, indent=1)
        paths["audit"] = p
        return paths

    def debug_dump(self, file=None, last: int = 20) -> None:
        """Dump live span stacks + recent spans/audit to stderr.

        Called from the SIGALRM timeout hook in ``tests/conftest.py`` so a
        hung test fails with context instead of a bare TimeoutError.
        """
        out = file if file is not None else sys.stderr
        if not self.enabled:
            print("[obs] telemetry disabled (enable with repro_torch.obs.enable() "
                  "or a --telemetry-out flag)", file=out)
            return
        self.tracer.debug_dump(file=out, last=last)
        recent = self.audit.recent(last)
        if recent:
            print(f"[obs] last {len(recent)} audit records:", file=out)
            for r in recent:
                print(f"[obs]   tick {r.tick}: {r.job} {r.event} "
                      f"{r.direction or '-'} rule={r.rule or '-'} "
                      f"{r.from_rung}->{r.to_rung}", file=out)
        if self.snapshots:
            print(f"[obs] latest metrics snapshot: "
                  f"{json.dumps(encode_record(self.snapshots[-1]))}",
                  file=out)


_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process-global instance; returns the old one."""
    global _GLOBAL
    old = _GLOBAL
    _GLOBAL = tel
    return old


def enable() -> Telemetry:
    """Install and return a fresh enabled global Telemetry."""
    tel = Telemetry(enabled=True)
    set_telemetry(tel)
    return tel


def disable() -> Telemetry:
    """Install and return a fresh disabled global Telemetry."""
    tel = Telemetry(enabled=False)
    set_telemetry(tel)
    return tel
