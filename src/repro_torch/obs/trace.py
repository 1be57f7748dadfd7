"""Span tracer: contextmanager API, monotonic clocks, thread-safe.

Instruments the phases that were previously invisible between steps —
runtime ticks, jitted steps (compile vs steady-state), remesh checkpoint
round-trips, prefill chunks vs decode batches, COW device copies, host
swap in/out, fleet invite→accept — and exports Chrome-trace JSON
(``{"traceEvents": [...]}``, "X" complete events, µs timestamps) that
loads directly in Perfetto / ``chrome://tracing``.

Nesting is tracked per thread (``threading.local`` stacks); completed
spans land in one lock-protected list with a bounded cap so multi-day
fleet runs cannot exhaust memory (drops are counted, never silent).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from typing import Dict, List, Optional

from repro_torch.obs.schema import encode_record, versioned


@dataclasses.dataclass
class SpanRecord:
    name: str
    ts_us: float          # start, µs since tracer epoch (monotonic)
    dur_us: float
    tid: int
    depth: int            # nesting depth at start (0 = top level)
    args: Dict = dataclasses.field(default_factory=dict)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_start", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        self._tracer._record(self, self._start, end)
        return False  # never swallow exceptions


class SpanTracer:
    def __init__(self, enabled: bool = True, max_spans: int = 200_000):
        self.enabled = enabled
        self.max_spans = max_spans
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._spans: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # live stacks by thread id, for timeout/hang diagnosis
        self._live: Dict[int, List[_Span]] = {}

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._live[threading.get_ident()] = stack
        return stack

    def span(self, name: str, **args):
        """``with tracer.span("serve.decode", batch=4): ...``"""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args)

    def _record(self, span: _Span, start: float, end: float) -> None:
        rec = SpanRecord(
            name=span.name,
            ts_us=(start - self._epoch) * 1e6,
            dur_us=(end - start) * 1e6,
            tid=threading.get_ident(),
            depth=span._depth,
            args=span.args,
        )
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(rec)

    # ------------------------------------------------------------------
    # introspection / export
    # ------------------------------------------------------------------
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def recent(self, n: int = 20) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans[-n:])

    def active_stack(self) -> Dict[int, List[str]]:
        """Currently-open span names per thread (hang diagnosis)."""
        with self._lock:
            return {tid: [f"{s.name}{s.args or ''}" for s in stack]
                    for tid, stack in self._live.items() if stack}

    def to_records(self) -> List[Dict]:
        return [encode_record(s) for s in self.spans()]

    def chrome_trace(self) -> Dict:
        """Chrome-trace JSON dict (loads in Perfetto / chrome://tracing)."""
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "repro"}},
        ]
        tids = {}
        for s in self.spans():
            # renumber thread ids densely so the trace UI rows read 0,1,2…
            tid = tids.setdefault(s.tid, len(tids))
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.ts_us,
                "dur": s.dur_us,
                "pid": 1,
                "tid": tid,
                "args": encode_record(s.args),
            })
        for raw, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": f"thread-{raw}"}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": versioned({"dropped_spans": self.dropped})}

    def save_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def by_name(self) -> Dict[str, Dict]:
        """Aggregate spans by name: count / total / mean / max (µs)."""
        agg: Dict[str, Dict] = {}
        for s in self.spans():
            a = agg.setdefault(s.name,
                               {"count": 0, "total_us": 0.0, "max_us": 0.0})
            a["count"] += 1
            a["total_us"] += s.dur_us
            if s.dur_us > a["max_us"]:
                a["max_us"] = s.dur_us
        for a in agg.values():
            a["mean_us"] = a["total_us"] / a["count"]
        return agg

    def debug_dump(self, file=None, last: int = 20) -> None:
        """Human-readable dump of live stacks + recent spans (timeouts)."""
        out = file if file is not None else sys.stderr
        active = self.active_stack()
        if active:
            print("[obs] active span stacks:", file=out)
            for tid, names in active.items():
                print(f"[obs]   thread {tid}: " + " > ".join(names), file=out)
        else:
            print("[obs] no active spans", file=out)
        recent = self.recent(last)
        if recent:
            print(f"[obs] last {len(recent)} completed spans:", file=out)
            for s in recent:
                print(f"[obs]   {s.ts_us / 1e6:10.3f}s "
                      f"{s.dur_us / 1e3:9.3f}ms  {s.name} {s.args or ''}",
                      file=out)
        if self.dropped:
            print(f"[obs] ({self.dropped} spans dropped at cap "
                  f"{self.max_spans})", file=out)
