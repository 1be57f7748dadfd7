"""Summarize a ``repro_torch.obs`` telemetry bundle from the command line.

A bundle directory (written by any launcher's ``--telemetry-out``) holds
``metrics.jsonl`` (per-tick snapshots), ``spans.jsonl`` (span records),
``trace.json`` (Chrome-trace/Perfetto) and ``audit.json`` (arbiter
decision log). This tool prints the three views that answer "what did the
runtime do and why":

- top spans by total time (count / total / mean / max per span name),
- the migration audit table — every propose/commit/veto with the
  relinquish scores, SLO headroom and rule that decided it,
- the per-rung step-latency quantile table (the measured ladder costs the
  planner's estimates should be checked against — including per-draft-depth
  speculative verify latency),
- final metric values from the last snapshot line.

The bundle schema (``obs.schema.SCHEMA_VERSION``) is the JAX package's,
so a bundle written by either package's launchers reads the same.

``--chrome-trace OUT`` re-derives a Chrome-trace JSON from ``spans.jsonl``
(useful when only the JSONL stream was shipped off-device) — the output
loads directly in Perfetto / chrome://tracing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.obs_report /tmp/tel
  PYTHONPATH=src python -m repro_torch.launch.obs_report /tmp/tel \
      --chrome-trace /tmp/trace.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.obs.schema import SCHEMA_VERSION, versioned


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a JSONL stream, skipping the versioned header line if present."""
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "stream" in row and "schema_version" in row:
                continue  # header line
            rows.append(row)
    return rows


def span_table(spans: List[Dict[str, Any]], top: int = 0) -> List[Dict[str, Any]]:
    """Aggregate span records by name, sorted by total time descending."""
    agg: Dict[str, Dict[str, float]] = {}
    for s in spans:
        a = agg.setdefault(s["name"], {"count": 0, "total_us": 0.0,
                                       "max_us": 0.0})
        a["count"] += 1
        a["total_us"] += s["dur_us"]
        a["max_us"] = max(a["max_us"], s["dur_us"])
    rows = [{"name": name, **a, "mean_us": a["total_us"] / a["count"]}
            for name, a in agg.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top] if top else rows


def _parse_labels(flat_key: str) -> Dict[str, str]:
    """``name{k=v,k2=v2}`` -> label dict (empty for unlabeled keys)."""
    if "{" not in flat_key:
        return {}
    inner = flat_key[flat_key.index("{") + 1:flat_key.rindex("}")]
    out: Dict[str, str] = {}
    for part in inner.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def rung_latency_table(final: Dict[str, Any],
                       metric: str = "job_step_latency_s"
                       ) -> List[Dict[str, Any]]:
    """Per-(job, rung) quantile rows from the final snapshot's histogram
    summaries — the measured per-rung step costs the planner's estimates
    should be checked against (and, for a speculating ServeJob, the
    per-draft-depth latency of the verify rounds)."""
    rows: List[Dict[str, Any]] = []
    for key, val in final.items():
        if not key.startswith(metric) or not isinstance(val, dict):
            continue
        labels = _parse_labels(key)
        rows.append({"job": labels.get("job", "-"),
                     "rung": labels.get("rung", "-"),
                     "count": val.get("count"), "mean": val.get("mean"),
                     "p50": val.get("p50"), "p90": val.get("p90"),
                     "p99": val.get("p99"), "max": val.get("max")})
    rows.sort(key=lambda r: (r["job"], r["rung"]))
    return rows


def print_rung_latency_table(rows: List[Dict[str, Any]], file=None) -> None:
    if not rows:
        print("  (no per-rung latency samples)", file=file)
        return
    print(f"  {'job':<10} {'rung':<18} {'n':>5} {'mean':>9} {'p50':>9} "
          f"{'p90':>9} {'p99':>9} {'max':>9}", file=file)

    def ms(v):
        return f"{v * 1e3:8.2f}m" if isinstance(v, (int, float)) else "       -"

    for r in rows:
        print(f"  {r['job']:<10} {r['rung']:<18} {r['count'] or 0:>5} "
              f"{ms(r['mean'])} {ms(r['p50'])} {ms(r['p90'])} {ms(r['p99'])} "
              f"{ms(r['max'])}", file=file)


def _fmt_scores(scores: Dict[str, Any]) -> str:
    if not scores:
        return "-"
    parts = []
    for k, v in sorted(scores.items()):
        parts.append(f"{k}={v:.3g}" if isinstance(v, (int, float)) else
                     f"{k}={v}")
    return " ".join(parts)


def print_audit_table(records: List[Dict[str, Any]], file=None) -> None:
    if not records:
        print("  (no audit records)", file=file)
        return
    hdr = (f"  {'tick':>5} {'job':<10} {'event':<11} {'rule':<12} "
           f"{'rung':<18} scores")
    print(hdr, file=file)
    for r in records:
        rung = r.get("from_rung", "")
        if r.get("to_rung") and r["to_rung"] != rung:
            rung = f"{rung}->{r['to_rung']}"
        print(f"  {str(r.get('tick', '')):>5} {r.get('job', ''):<10} "
              f"{r.get('event', ''):<11} {r.get('rule', '') or '-':<12} "
              f"{rung:<18} {_fmt_scores(r.get('scores') or {})}", file=file)


def spans_to_chrome_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Rebuild a Chrome-trace document from span records (spans.jsonl)."""
    tids = sorted({s["tid"] for s in spans})
    dense = {t: i + 1 for i, t in enumerate(tids)}
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "swan"}}]
    for t in tids:
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": dense[t], "args": {"name": f"thread-{t}"}})
    for s in spans:
        events.append({"name": s["name"], "ph": "X", "pid": 1,
                       "tid": dense[s["tid"]], "ts": s["ts_us"],
                       "dur": s["dur_us"], "args": s.get("args") or {}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": versioned({"source": "obs_report"})}


def report(outdir: str, *, top: int = 15, audit_limit: int = 40,
           chrome_trace: Optional[str] = None) -> Dict[str, Any]:
    """Print the report; returns the structured summary (for tests)."""
    out: Dict[str, Any] = versioned({})

    spans_path = os.path.join(outdir, "spans.jsonl")
    spans = load_jsonl(spans_path) if os.path.exists(spans_path) else []
    out["spans"] = span_table(spans, top=top)
    print(f"== top spans by total time ({len(spans)} spans) ==")
    for r in out["spans"]:
        print(f"  {r['name']:<24} n={r['count']:<6} "
              f"total={r['total_us'] / 1e3:9.2f} ms  "
              f"mean={r['mean_us'] / 1e3:8.3f} ms  "
              f"max={r['max_us'] / 1e3:8.3f} ms")

    audit_path = os.path.join(outdir, "audit.json")
    audit: List[Dict[str, Any]] = []
    if os.path.exists(audit_path):
        with open(audit_path) as f:
            doc = json.load(f)
        audit = doc.get("records", [])
    out["audit"] = audit
    decisions = [r for r in audit if r.get("event") in ("commit", "veto")]
    print(f"\n== migration audit ({len(audit)} records, "
          f"{len(decisions)} commits/vetoes) ==")
    shown = decisions[-audit_limit:] if audit_limit else decisions
    if len(shown) < len(decisions):
        print(f"  ... showing last {len(shown)}")
    print_audit_table(shown)

    metrics_path = os.path.join(outdir, "metrics.jsonl")
    final: Dict[str, Any] = {}
    if os.path.exists(metrics_path):
        lines = load_jsonl(metrics_path)
        if lines:
            final = lines[-1].get("metrics", {})
    out["final_metrics"] = final
    out["rung_latency"] = rung_latency_table(final)
    print("\n== per-rung step latency quantiles ==")
    print_rung_latency_table(out["rung_latency"])

    print(f"\n== final metric values ({len(final)}) ==")
    for key in sorted(final):
        v = final[key]
        if isinstance(v, dict):  # histogram summary
            print(f"  {key}: n={v.get('count')} mean={v.get('mean')} "
                  f"p99={v.get('p99')}")
        else:
            print(f"  {key}: {v}")

    if chrome_trace:
        doc = spans_to_chrome_trace(spans)
        with open(chrome_trace, "w") as f:
            json.dump(doc, f)
        print(f"\n[obs] chrome trace ({len(spans)} spans) -> {chrome_trace}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="summarize a repro_torch.obs telemetry bundle "
                    f"(schema v{SCHEMA_VERSION})")
    ap.add_argument("outdir", help="telemetry bundle directory "
                                   "(from --telemetry-out)")
    ap.add_argument("--top", type=int, default=15,
                    help="span-table rows (0 = all)")
    ap.add_argument("--audit-limit", type=int, default=40,
                    help="audit rows to print (0 = all)")
    ap.add_argument("--chrome-trace", default=None,
                    help="also convert spans.jsonl to a Chrome-trace JSON "
                         "at this path")
    args = ap.parse_args(argv)
    return report(args.outdir, top=args.top, audit_limit=args.audit_limit,
                  chrome_trace=args.chrome_trace)


if __name__ == "__main__":
    main()
