"""Labeled metrics registry: counters, gauges, histograms.

Design constraints (ISSUE 9):

* **Near-zero cost when disabled.** A disabled registry hands out one
  shared no-op handle (``NOOP``) for every metric — hot paths keep a
  reference and pay one attribute lookup + ``pass`` per update. Tests
  assert the identity so the guarantee can't silently regress.
* **One schema.** ``snapshot()`` returns a versioned dict absorbing the
  previously scattered stats surfaces; ``snapshot_line(tick)`` returns a
  flat one-line dict for per-tick JSONL streams.
* **Histograms** keep exact count/sum/min/max plus a bounded ring of
  recent samples for quantiles — enough for p50/p90/p99 on step
  latencies without unbounded memory on long fleet runs.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.schema import versioned

LabelKey = Tuple[Tuple[str, str], ...]


class _Noop:
    """Shared do-nothing handle returned by a disabled registry."""

    __slots__ = ()

    def labels(self, **kv) -> "_Noop":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NOOP = _Noop()


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "_ring", "_cap", "_next")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._ring: List[float] = []
        self._cap = cap
        self._next = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._ring) < self._cap:
            self._ring.append(v)
        else:  # ring buffer: quantiles reflect the most recent cap samples
            self._ring[self._next] = v
            self._next = (self._next + 1) % self._cap

    def quantile(self, q: float) -> Optional[float]:
        if not self._ring:
            return None
        s = sorted(self._ring)
        # nearest-rank with linear interpolation
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def summary(self) -> Dict[str, Optional[float]]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "mean": None, "p50": None, "p90": None, "p99": None}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class _Handle:
    """A (metric, label-set) slot. Cheap to cache on the hot path."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Metric", key: LabelKey):
        self._metric = metric
        self._key = key

    def labels(self, **kv) -> "_Handle":
        return self._metric.labels(**kv)

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind != "counter":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        with self._metric._lock:
            self._metric._series[self._key] = (
                self._metric._series.get(self._key, 0.0) + float(amount))

    def set(self, value: float) -> None:
        if self._metric.kind != "gauge":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        with self._metric._lock:
            self._metric._series[self._key] = float(value)

    def observe(self, value: float) -> None:
        if self._metric.kind != "histogram":
            raise TypeError(f"{self._metric.name} is a {self._metric.kind}")
        with self._metric._lock:
            h = self._metric._series.get(self._key)
            if h is None:
                h = self._metric._series[self._key] = _Hist(
                    self._metric.hist_cap)
            h.observe(value)


class Metric:
    def __init__(self, name: str, kind: str, help: str = "",
                 hist_cap: int = 4096):
        self.name = name
        self.kind = kind
        self.help = help
        self.hist_cap = hist_cap
        self._series: Dict[LabelKey, object] = {}
        self._lock = threading.Lock()
        self._default = _Handle(self, ())

    def labels(self, **kv) -> _Handle:
        if not kv:
            return self._default
        key = tuple(sorted((str(k), str(v)) for k, v in kv.items()))
        return _Handle(self, key)

    # unlabeled convenience — metric doubles as its own default handle
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def set(self, value: float) -> None:
        self._default.set(value)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def quantile(self, q: float, **kv) -> Optional[float]:
        key = tuple(sorted((str(k), str(v)) for k, v in kv.items()))
        with self._lock:
            h = self._series.get(key)
        return h.quantile(q) if isinstance(h, _Hist) else None

    def value(self, **kv):
        key = tuple(sorted((str(k), str(v)) for k, v in kv.items()))
        with self._lock:
            v = self._series.get(key)
        return v.summary() if isinstance(v, _Hist) else v

    def series(self) -> List[Dict]:
        out = []
        with self._lock:
            items = list(self._series.items())
        for key, val in items:
            row: Dict = {"labels": dict(key)}
            if isinstance(val, _Hist):
                row.update(val.summary())
            else:
                row["value"] = val
            out.append(row)
        return out


def _flat_key(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Registry of named metrics; disabled ⇒ every lookup returns ``NOOP``."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str, **extra):
        if not self.enabled:
            return NOOP
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(name, kind, help, **extra)
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} registered as {m.kind}, requested {kind}")
            return m

    def counter(self, name: str, help: str = ""):
        return self._get(name, "counter", help)

    def gauge(self, name: str, help: str = ""):
        return self._get(name, "gauge", help)

    def histogram(self, name: str, help: str = "", max_samples: int = 4096):
        return self._get(name, "histogram", help, hist_cap=max_samples)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict:
        """Full structured dump — versioned, JSON-serializable."""
        with self._lock:
            metrics = list(self._metrics.values())
        return versioned({
            "metrics": {
                m.name: {"kind": m.kind, "help": m.help,
                         "series": m.series()}
                for m in metrics
            },
        })

    def snapshot_line(self, tick) -> Dict:
        """Flat one-line dict for a JSONL stream: name{k=v} -> value."""
        with self._lock:
            metrics = list(self._metrics.values())
        flat: Dict[str, object] = {}
        for m in metrics:
            with m._lock:
                items = list(m._series.items())
            for key, val in items:
                fk = _flat_key(m.name, key)
                flat[fk] = val.summary() if isinstance(val, _Hist) else val
        return {"tick": tick, "metrics": flat}
