"""One versioned schema for every telemetry payload the repo emits.

Before this module each surface serialized its own ad-hoc dict shape
(``Timeline.to_json``, ``engine.stats()``, ``RuntimeResult.summary()``,
serve's ``--json-out``, fleet round logs) with no version marker — evolving
any of them silently broke downstream consumers. Every JSON payload now
passes through :func:`versioned` (stamping ``schema_version``) and dataclass
records serialize through :func:`encode_record`, so there is exactly one
place to bump when the schema changes and one place consumers check.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

# Bump when any telemetry/timeline/stats payload shape changes. Consumers
# (obs_report, benchmark differs, dashboards) key their parsing off this.
SCHEMA_VERSION = 1


def encode_record(obj: Any) -> Any:
    """Canonical JSON encoding for telemetry records.

    Dataclasses (Timeline steps/migrations, audit records, span records)
    become plain dicts; non-finite floats become ``None`` (strict JSON has
    no Infinity/NaN — a bottom-rung relinquish score is ``-inf``); numpy
    scalars become native Python numbers. Containers recurse.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: encode_record(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): encode_record(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_record(v) for v in obj]
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return encode_record(obj.item())  # numpy scalar
        except (AttributeError, TypeError, ValueError):
            return obj
    return obj


def versioned(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp a payload with the telemetry schema version (idempotent)."""
    out = {"schema_version": SCHEMA_VERSION}
    out.update(payload)
    return out
