"""GreenHub-like battery traces (paper §A.1/§A.2): a copy of the JAX
package's ``fl/traces.py``, which is numpy only.

The raw GreenHub dataset is not redistributable; we generate statistically
matched synthetic traces (diurnal charge cycles, irregular sampling) and then
apply the paper's exact §A.2 pipeline: quality filters, PCHIP resampling to a
10-minute grid (own Fritsch–Carlson implementation — scipy is unavailable),
battery_state from consecutive level differences, and the 23x1h timezone
augmentation that turns 100 traces into 2400 clients.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

MINUTES_PER_DAY = 1440
RESAMPLE_MIN = 10


# ---------------------------------------------------------------------------
# PCHIP (Fritsch–Carlson monotone cubic Hermite), numpy-only
# ---------------------------------------------------------------------------


def _pchip_slopes(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h = np.diff(x)
    delta = np.diff(y) / h
    n = len(x)
    d = np.zeros(n)
    if n == 2:
        d[:] = delta[0]
        return d
    w1 = 2 * h[1:] + h[:-1]
    w2 = h[1:] + 2 * h[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        interior = (w1 + w2) / (w1 / delta[:-1] + w2 / delta[1:])
    same_sign = np.sign(delta[:-1]) * np.sign(delta[1:]) > 0
    d[1:-1] = np.where(same_sign, interior, 0.0)
    d[0] = _edge_slope(h[0], h[1], delta[0], delta[1])
    d[-1] = _edge_slope(h[-1], h[-2], delta[-1], delta[-2])
    return d


def _edge_slope(h0, h1, d0, d1):
    d = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
    if np.sign(d) != np.sign(d0):
        return 0.0
    if np.sign(d0) != np.sign(d1) and abs(d) > 3 * abs(d0):
        return 3 * d0
    return d


def pchip_interpolate(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Monotone piecewise-cubic Hermite interpolation (shape-preserving)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    d = _pchip_slopes(x, y)
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
    h = x[idx + 1] - x[idx]
    t = (xq - x[idx]) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    return h00 * y[idx] + h10 * h * d[idx] + h01 * y[idx + 1] + h11 * h * d[idx + 1]


# ---------------------------------------------------------------------------
# synthetic raw traces + the paper's §A.2 pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatteryTrace:
    """10-min-grid battery level in [0,1] + state (1 charge, 0 flat, -1 drain)."""
    level: np.ndarray
    state: np.ndarray
    start_offset_min: int = 0

    def at(self, minute: float) -> Tuple[float, int]:
        i = int((minute + self.start_offset_min) // RESAMPLE_MIN) % len(self.level)
        return float(self.level[i]), int(self.state[i])

    @property
    def days(self) -> float:
        return len(self.level) * RESAMPLE_MIN / MINUTES_PER_DAY


def generate_raw_trace(rng: np.random.Generator, days: int = 28):
    """Irregularly-sampled (timestamp_min, level) like a GreenHub logger."""
    ts, level = [], []
    t = 0.0
    lv = rng.uniform(0.5, 0.95)
    charge_start = rng.uniform(21, 26)  # plug-in hour (mod 24)
    while t < days * MINUTES_PER_DAY:
        hour = (t / 60.0) % 24
        charging = (hour >= charge_start % 24 and hour < (charge_start + 7) % 24) \
            if charge_start % 24 < (charge_start + 7) % 24 else \
            (hour >= charge_start % 24 or hour < (charge_start + 7) % 24)
        dt = rng.exponential(9.0) + 1.0  # ~100+ samples/day
        if charging:
            lv = min(1.0, lv + 0.006 * dt * rng.uniform(0.8, 1.2))
        else:
            drain = 0.0006 * dt * (1.0 + 2.0 * np.exp(-((hour - 14) ** 2) / 18.0))
            lv = max(0.02, lv - drain * rng.uniform(0.6, 1.6))
        ts.append(t)
        level.append(lv)
        t += dt
    return np.asarray(ts), np.asarray(level)


def passes_quality_filters(ts: np.ndarray, days_min: float = 28.0,
                           freq_min_hz: float = 100.0 / 86400.0,
                           max_gap_h: float = 24.0, max_big_gaps: int = 15) -> bool:
    """Paper §A.2 criteria 1-4. NOTE: the paper states 5/432 Hz "equivalent
    to 100 samples a day", but 5/432 Hz is 1000/day; we use the 100/day
    reading (the stated intent)."""
    if len(ts) < 2:
        return False
    span_days = (ts[-1] - ts[0]) / MINUTES_PER_DAY
    if span_days < days_min - 1e-9:
        return False
    freq_hz = len(ts) / ((ts[-1] - ts[0]) * 60.0)
    if freq_hz < freq_min_hz:
        return False
    gaps_h = np.diff(ts) / 60.0
    if gaps_h.max() > max_gap_h:
        return False
    if int((gaps_h > 6.0).sum()) > max_big_gaps:
        return False
    return True


def resample_trace(ts: np.ndarray, level: np.ndarray) -> BatteryTrace:
    grid = np.arange(ts[0], ts[-1], RESAMPLE_MIN, dtype=float)
    lv = np.clip(pchip_interpolate(ts, level, grid), 0.0, 1.0)
    dlv = np.diff(lv, prepend=lv[0])
    state = np.where(dlv > 1e-6, 1, np.where(dlv < -1e-6, -1, 0)).astype(np.int8)
    return BatteryTrace(level=lv, state=state)


def make_client_traces(n_base: int = 100, *, seed: int = 0, days: int = 29,
                       tz_shifts: int = 24,
                       max_attempts_per_trace: int = 50) -> List[BatteryTrace]:
    """100 quality-filtered traces x 24 timezone shifts = 2400 clients (§A.2).

    The span filter is binding: ``days_min`` is passed explicitly (a previous
    version passed ``lv.size and 28.0`` positionally, which evaluates to ``0``
    for an empty trace and silently disabled the filter). A configuration
    whose raw traces cannot satisfy the filters (e.g. ``days < 28``) raises
    after a bounded number of attempts instead of looping forever."""
    rng = np.random.default_rng(seed)
    base: List[BatteryTrace] = []
    attempts = 0
    while len(base) < n_base:
        if attempts >= max_attempts_per_trace * n_base:
            raise ValueError(
                f"quality filters rejected every candidate trace "
                f"({attempts} attempts for {n_base} traces; days={days} "
                f"cannot satisfy days_min=28)")
        attempts += 1
        ts, lv = generate_raw_trace(rng, days=days)
        if passes_quality_filters(ts, days_min=28.0):
            base.append(resample_trace(ts, lv))
    out: List[BatteryTrace] = []
    for shift in range(tz_shifts):
        for tr in base:
            out.append(BatteryTrace(level=tr.level, state=tr.state,
                                    start_offset_min=shift * 60))
    return out
