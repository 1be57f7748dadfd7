"""Chaos fault injection for SwanRuntime (a copy of the JAX package's
``engine/chaos.py``, which is numpy only; its checkpoint serializer is the
port's ``checkpoint.store``).

The robustness claims this repo makes — pause/resume is exact, a torn
checkpoint costs bounded progress, pool pressure degrades service instead of
crashing it — are only claims until something actually goes wrong. The
:class:`ChaosInjector` makes things go wrong *deterministically*: a seeded
schedule of faults drawn from every failure class the runtime handles,
applied through the same public surfaces a real fault would arrive through.
The runtime consults it at the top of each tick (``SwanRuntime(chaos=...)``)
and multiplies its ``latency_multiplier`` into every job's observed slowdown;
it never special-cases an injected fault, so each one exercises exactly the
recovery path the organic version would.

Fault classes (``ChaosEvent.kind``):

- ``device_loss``     — fail one healthy device in the shared elastic pool;
                        jobs remesh via their normal ``on_device_loss`` path.
                        On one card there is no elastic pool: the event is
                        logged as skipped ("no elastic pool").
- ``pool_pressure``   — a co-tenant grabs KV blocks out of a paged serve
                        engine's pool (``engine.hold_blocks``) for
                        ``duration`` ticks; admission degrades per policy
                        (shed / serialize), residents are never starved.
- ``ckpt_torn``       — simulate a crash mid-checkpoint-write: a torn file
                        (valid header, wrong payload) appears as the *newest*
                        step, plus the orphan ``.tmp`` such a crash leaves.
                        The next restore must skip it and fall back.
- ``thermal_spike``   — dump ``magnitude`` onto the shared die temperature;
                        the closed-loop throttle engages until migrations
                        shed enough heat.
- ``latency_spike``   — multiply every job's observed latency by
                        ``magnitude`` for ``duration`` ticks (a co-tenant
                        burst the trace didn't script).
- ``fg_burst``        — the user picks up the phone: inject a foreground
                        burst of ``duration`` ticks into the
                        ForegroundAppJob, which makes the runtime pause and
                        later resume every preemptible job.

Every applied fault is appended to ``injector.log`` (and its class to
``injector.applied``) so a harness can assert coverage; faults whose target
is absent (no elastic pool, no paged engine, no foreground job) are logged
as skipped rather than silently dropped.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

KINDS = ("device_loss", "pool_pressure", "ckpt_torn", "thermal_spike",
         "latency_spike", "fg_burst")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    tick: int
    kind: str
    duration: int = 1      # ticks (pool_pressure / latency_spike / fg_burst)
    magnitude: float = 2.0  # blocks | temp | latency multiplier (by kind)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")


class ChaosInjector:
    """Applies a deterministic fault schedule to a running SwanRuntime."""

    def __init__(self, events: Sequence[ChaosEvent] = ()):
        self.events = sorted(events, key=lambda e: (e.tick, e.kind))
        self.log: List[Dict[str, Any]] = []
        self.applied: Set[str] = set()
        # latency spikes are pure intervals — precomputed so
        # latency_multiplier is a cheap read on every job every tick
        self._lat: List[Tuple[int, int, float]] = [
            (e.tick, e.tick + e.duration, float(e.magnitude))
            for e in self.events if e.kind == "latency_spike"]
        self._holds: List[Tuple[int, Any]] = []  # (release_tick, engine)
        self._by_tick: Dict[int, List[ChaosEvent]] = {}
        for e in self.events:
            self._by_tick.setdefault(e.tick, []).append(e)

    # -- deterministic random schedules --------------------------------------
    @classmethod
    def random(cls, seed: int, horizon: int, *,
               kinds: Sequence[str] = KINDS,
               events_per_kind: int = 2) -> "ChaosInjector":
        """A seeded schedule with ``events_per_kind`` of every fault class
        spread over ``[horizon//8, horizon)`` — late enough that each job has
        warmed up, deterministic for a given (seed, horizon, kinds)."""
        rng = np.random.default_rng(seed)
        lo = max(1, horizon // 8)
        events = []
        for kind in kinds:
            for _ in range(events_per_kind):
                tick = int(rng.integers(lo, max(lo + 1, horizon * 3 // 4)))
                dur = int(rng.integers(2, max(3, horizon // 8)))
                if kind == "thermal_spike":
                    mag = float(rng.uniform(0.8, 1.5))
                elif kind == "latency_spike":
                    mag = float(rng.uniform(1.5, 4.0))
                elif kind == "pool_pressure":
                    mag = float(rng.integers(3, 10))  # blocks
                else:
                    mag = float(rng.integers(0, 1 << 30))  # selector entropy
                events.append(ChaosEvent(tick=tick, kind=kind,
                                         duration=dur, magnitude=mag))
        return cls(events)

    # -- runtime hooks --------------------------------------------------------
    def latency_multiplier(self, tick: int) -> float:
        m = 1.0
        for a, b, mult in self._lat:
            if a <= tick < b:
                m *= mult
        return m

    def begin_tick(self, tick: int, runtime) -> None:
        # release pool holds whose interval ended
        due = [(t, e) for t, e in self._holds if t <= tick]
        if due:
            self._holds = [(t, e) for t, e in self._holds if t > tick]
            for _, engine in due:
                engine.release_held()
                self._log(tick, "pool_pressure", released=True)
        for event in self._by_tick.get(tick, ()):
            self._apply(tick, event, runtime)

    # -- application ----------------------------------------------------------
    def _log(self, tick: int, kind: str, **detail) -> None:
        self.log.append({"tick": tick, "kind": kind, **detail})

    def _apply(self, tick: int, e: ChaosEvent, runtime) -> None:
        handler = getattr(self, f"_apply_{e.kind}")
        handler(tick, e, runtime)

    def _apply_device_loss(self, tick: int, e: ChaosEvent, runtime) -> None:
        if runtime.elastic is None:
            self._log(tick, e.kind, skipped="no elastic pool")
            return
        healthy = list(runtime.elastic.healthy_ids())
        if len(healthy) <= 1:
            self._log(tick, e.kind, skipped="would kill the last device")
            return
        victim = healthy[int(e.magnitude) % len(healthy)]
        runtime.elastic.mark_failed((victim,))
        for job in runtime.jobs:
            if not job.done and not job.paused:
                job.on_device_loss(tick, (victim,))
        self.applied.add(e.kind)
        self._log(tick, e.kind, device=victim)

    def _apply_pool_pressure(self, tick: int, e: ChaosEvent, runtime) -> None:
        hit = False
        for job in runtime.jobs:
            engine = getattr(job, "engine", None)
            if engine is None or not hasattr(engine, "hold_blocks"):
                continue
            held = engine.hold_blocks(int(e.magnitude))
            if held or engine.kv is not None:
                hit = True
                self._holds.append((tick + e.duration, engine))
                self._log(tick, e.kind, job=job.name, blocks=held,
                          until=tick + e.duration)
        if hit:
            self.applied.add(e.kind)
        else:
            self._log(tick, e.kind, skipped="no paged serve engine")

    def _apply_ckpt_torn(self, tick: int, e: ChaosEvent, runtime) -> None:
        hit = False
        for job in runtime.jobs:
            mgr_fn = getattr(job, "_ckpt", None)
            if mgr_fn is None or job.done:
                continue
            mgr = mgr_fn()
            # the torn file must be the NEWEST step so restore_latest tries
            # it first — exactly where a crash mid-save would leave it
            steps = mgr.steps()
            step = (steps[-1] if steps else int(
                getattr(job, "_step_idx", 0))) + 1
            path = mgr._path(step)
            from repro_torch.checkpoint.store import serialize_pytree
            blob = serialize_pytree({"step": step, "state": {"torn": True}})
            with open(path, "wb") as f:
                f.write(blob[:max(8, len(blob) // 2)])  # torn mid-write
            with open(path + ".tmp", "wb") as f:  # the orphan temp file
                f.write(b"\x00" * 16)
            hit = True
            self.applied.add(e.kind)
            self._log(tick, e.kind, job=job.name, step=step,
                      path=os.path.basename(path))
        if not hit:
            self._log(tick, e.kind, skipped="no checkpointing job")

    def _apply_thermal_spike(self, tick: int, e: ChaosEvent,
                             runtime) -> None:
        trace = runtime.trace
        if trace is None or not hasattr(trace, "temp"):
            self._log(tick, e.kind, skipped="no thermal trace")
            return
        trace.temp += float(e.magnitude)
        self.applied.add(e.kind)
        self._log(tick, e.kind, temp=round(trace.temp, 3))

    def _apply_latency_spike(self, tick: int, e: ChaosEvent,
                             runtime) -> None:
        # interval already active via latency_multiplier; log the onset
        self.applied.add(e.kind)
        self._log(tick, e.kind, mult=e.magnitude,
                  until=tick + e.duration)

    def _apply_fg_burst(self, tick: int, e: ChaosEvent, runtime) -> None:
        for job in runtime.jobs:
            if getattr(job, "is_foreground", False) and \
                    hasattr(job, "add_burst"):
                job.add_burst(tick, tick + e.duration)
                self.applied.add(e.kind)
                self._log(tick, e.kind, until=tick + e.duration)
                return
        self._log(tick, e.kind, skipped="no foreground job")

    # -- reporting ------------------------------------------------------------
    def skipped_kinds(self) -> Set[str]:
        return {entry["kind"] for entry in self.log if "skipped" in entry}

    def to_json(self) -> Dict[str, Any]:
        return {"events": [dataclasses.asdict(e) for e in self.events],
                "applied": sorted(self.applied),
                "log": self.log}


# ---------------------------------------------------------------------------
# Fleet-scale fault classes (injected through the FleetCoordinator)
# ---------------------------------------------------------------------------

FLEET_KINDS = ("client_churn", "update_dropped", "update_duplicated",
               "update_corrupt", "coordinator_crash")


class FleetChaos:
    """Coordinator-level fault injection for federated rounds.

    Where :class:`ChaosInjector` breaks a single SoC's runtime, this breaks
    the *fleet* around it — the network and the coordinator process:

    - ``client_churn``       — an invited client vanishes mid-round (user
                               closed the app / lost connectivity); it never
                               reports, the coordinator must degrade to a
                               smaller accepted set.
    - ``update_dropped``     — a finished client's update is lost in
                               delivery; same coordinator-side symptom as
                               churn but after the work (and energy) was
                               spent.
    - ``update_duplicated``  — at-least-once delivery re-sends an update;
                               the coordinator must dedup by client id or it
                               double-counts.
    - ``update_corrupt``     — bit-flip in transit; the payload no longer
                               matches its checksum and must be rejected.
    - ``coordinator_crash``  — the coordinator process dies mid-aggregation,
                               after ``crash_at[1]`` updates of round
                               ``crash_at[0]`` were accepted; resume must
                               neither lose nor double-count them.

    All decisions are stateless functions of ``(seed, round, client)`` so a
    crash-resumed coordinator sees the identical fault schedule.
    """

    def __init__(self, seed: int = 0, *, churn_prob: float = 0.0,
                 churn_rounds: Optional[Dict[int, float]] = None,
                 drop_prob: float = 0.0, dup_prob: float = 0.0,
                 corrupt_prob: float = 0.0,
                 crash_at: Optional[Tuple[int, int]] = None):
        self.seed = int(seed)
        self.churn_prob = float(churn_prob)
        self.churn_rounds = dict(churn_rounds or {})
        self.drop_prob = float(drop_prob)
        self.dup_prob = float(dup_prob)
        self.corrupt_prob = float(corrupt_prob)
        self.crash_at = tuple(crash_at) if crash_at is not None else None
        self._crash_fired = False
        self.log: List[Dict[str, Any]] = []
        self.applied: Set[str] = set()

    # -- schedule -------------------------------------------------------------
    def churn_fraction(self, rnd: int) -> float:
        return float(self.churn_rounds.get(int(rnd), self.churn_prob))

    def churn(self, rnd: int, cids: Sequence[int]) -> Set[int]:
        """Subset of the invited cohort that silently vanishes this round."""
        p = self.churn_fraction(rnd)
        if p <= 0.0 or not len(cids):
            return set()
        rng = np.random.default_rng((self.seed, int(rnd), 101))
        mask = rng.random(len(cids)) < p
        gone = {int(c) for c, m in zip(cids, mask) if m}
        if gone:
            self.applied.add("client_churn")
            self.log.append({"round": int(rnd), "kind": "client_churn",
                             "clients": sorted(gone)})
        return gone

    def delivery(self, rnd: int, cid: int) -> str:
        """Fate of one client's finished update: ok|dropped|duplicated|corrupt."""
        total = self.drop_prob + self.dup_prob + self.corrupt_prob
        if total <= 0.0:
            return "ok"
        rng = np.random.default_rng((self.seed, int(rnd), int(cid), 103))
        u = float(rng.random())
        if u < self.drop_prob:
            fate = "dropped"
        elif u < self.drop_prob + self.dup_prob:
            fate = "duplicated"
        elif u < total:
            fate = "corrupt"
        else:
            return "ok"
        self.applied.add(f"update_{fate}")
        self.log.append({"round": int(rnd), "kind": f"update_{fate}",
                         "client": int(cid)})
        return fate

    def corrupt_bytes(self, rnd: int, cid: int,
                      delta: np.ndarray) -> np.ndarray:
        """Flip one element so the payload no longer matches its checksum."""
        rng = np.random.default_rng((self.seed, int(rnd), int(cid), 107))
        out = np.array(delta, copy=True)
        out.flat[int(rng.integers(out.size))] += 1.0
        return out

    def crash_now(self, rnd: int, n_accepted: int) -> bool:
        """True exactly once: when round ``crash_at[0]`` has accepted
        ``crash_at[1]`` updates. The coordinator raises after its durable
        save, like a real process death."""
        if self.crash_at is None or self._crash_fired:
            return False
        r, n = self.crash_at
        if int(rnd) == int(r) and int(n_accepted) >= int(n):
            self._crash_fired = True
            self.applied.add("coordinator_crash")
            self.log.append({"round": int(rnd), "kind": "coordinator_crash",
                             "after_accepts": int(n_accepted)})
            return True
        return False

    # -- reporting ------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "probs": {"churn": self.churn_prob, "drop": self.drop_prob,
                          "dup": self.dup_prob, "corrupt": self.corrupt_prob},
                "churn_rounds": {str(k): v
                                 for k, v in self.churn_rounds.items()},
                "crash_at": list(self.crash_at) if self.crash_at else None,
                "applied": sorted(self.applied),
                "log": self.log}
