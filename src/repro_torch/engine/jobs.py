"""SocJob: the unit of work the SwanRuntime arbiter schedules.

A copy of the JAX package's ``engine/jobs.py``, which holds no framework
code: :class:`StepReport`, :func:`trace_latency_fn`, the :class:`SocJob`
protocol, the serving rungs (:class:`ServeRung`,
:func:`default_serve_ladder`), :class:`ServeJob` — a
``launch.serve.ContinuousBatchingEngine`` under the arbiter, migrating its
slot cap, attention impl, KV dtype and draft depth live — and
:class:`ForegroundAppJob`, the preemptor whose bursts pause every
preemptible co-tenant. One change the card needs: a ServeJob quantum whose
compiled decode or verify step did not replay (its eager first call or its
CUDA graph capture) is a warmup quantum, as the first quantum on a rung is,
so a capture never calibrates the controller.

SLO: a ServeJob can carry a p99 token-latency target (``slo_p99_s``); the
runtime then arbitrates on SLO headroom instead of relative goodput.

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


# ---------------------------------------------------------------------------
# serving rungs + ServeJob
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeRung:
    """One serving execution choice. ``None`` fields mean "the engine's
    as-built setting" (so upgrading back to the top rung restores it):

    - ``slot_cap``: max concurrently-resident requests (decode microbatch
      cap) — fewer resident sequences stream less KV per step, the decode
      analogue of shrinking the training microbatch;
    - ``attn_impl``: decode attention kernel override;
    - ``kv_dtype``: KV-cache dtype override ("bfloat16" halves cache
      traffic; token streams may differ from the f32 rungs);
    - ``draft_depth``: speculative-decoding depth override (0 turns
      speculation off). Emitted streams are invariant to depth, so this is
      the *cheapest* knob on the ladder — it trades only the speculative
      speedup, never a request's tokens — and sits above slot caps in the
      default downgrade order.
    """
    name: str
    slot_cap: Optional[int] = None
    attn_impl: Optional[str] = None
    kv_dtype: Optional[str] = None
    draft_depth: Optional[int] = None
    interference_sensitivity: float = 1.0
    rel_latency: float = 1.0  # aggregate tokens/s cost of this rung
    latency_estimate_s: Optional[float] = None
    power_draw: Optional[float] = None  # defaults to sensitivity

    def profile(self, *, position: int = 0, n: int = 1) -> ChoiceProfile:
        lat = self.latency_estimate_s if self.latency_estimate_s is not None \
            else self.rel_latency
        return ChoiceProfile(choice=self, latency_s=lat, energy_j=lat,
                             power_w=1.0, cost_key=(n - position,))


def default_serve_ladder(max_batch: int, *, include_bf16_kv: bool = True,
                         draft_depth: Optional[int] = None
                         ) -> List[ServeRung]:
    """Serving downgrade ladder: each rung halves decode concurrency (the
    contended-bandwidth knob) and the bottom rung additionally halves KV
    traffic with a bf16 cache. Rungs whose knobs collapse to an earlier
    rung's (tiny ``max_batch``) are dropped.

    When the engine speculates (``draft_depth`` > 0), draft-depth rungs are
    inserted *above* the slot caps: halve the depth, then switch speculation
    off, and only then start capping slots. Walking depth down costs only
    the speculative speedup — emitted streams are depth-invariant — while a
    slot cap costs admitted requests their latency, so speculation is
    always the first thing thermals take."""
    bf16 = "bfloat16" if include_bf16_kv else None
    if draft_depth:
        specs = [("serve-full", None, None, None, 1.0)]
        if draft_depth // 2 >= 1:
            specs.append(("serve-spec-half", None, None,
                          draft_depth // 2, 1.15))
        specs += [("serve-spec-off", None, None, 0, 1.3),
                  ("serve-capped", max(1, max_batch // 2), None, 0, 1.7),
                  ("serve-lean", max(1, max_batch // 4), bf16, 0, 2.2)]
    else:
        specs = [("serve-full", None, None, None, 1.0),
                 ("serve-capped", max(1, max_batch // 2), None, None, 1.4),
                 ("serve-lean", max(1, max_batch // 4), bf16, None, 1.9)]
    out: List[ServeRung] = []
    seen = set()
    for name, cap, kvd, depth, rel in specs:
        key = (cap if cap is None or cap < max_batch else None, kvd, depth)
        if key in seen:
            continue
        seen.add(key)
        out.append(ServeRung(name=name, slot_cap=cap, kv_dtype=kvd,
                             draft_depth=depth, rel_latency=rel))
    sens = ladder_sensitivities(len(out))
    for r, s in zip(out, sens):
        r.interference_sensitivity = s
    return out


class ServeJob(SocJob):
    """A ContinuousBatchingEngine under runtime arbitration.

    One tick = one engine step (admissions + one batched decode +
    retirements). Migrations apply the target rung's knobs to the live
    engine — resident sequences keep streaming across the switch.
    """

    def __init__(self, engine, requests: Sequence[Any] = (), *,
                 rungs: Optional[Sequence[ServeRung]] = None,
                 name: str = "serve", priority: float = 1.0,
                 adaptive: bool = True, upgrade_patience: int = 5,
                 latency_fn=None, verbose: bool = False,
                 slo_p99_s: Optional[float] = None, slo_window: int = 64,
                 slo_min_samples: int = 8):
        self.engine = engine
        self._requests = list(requests)
        self._rungs = list(rungs) if rungs is not None \
            else default_serve_ladder(
                engine.max_batch,
                draft_depth=getattr(engine, "draft_depth", 0))
        if not self._rungs:
            raise ValueError("need at least one serve rung")
        if latency_fn is not None and any(
                r.latency_estimate_s is None for r in self._rungs):
            raise ValueError("latency_fn mode needs latency_estimate_s on "
                             "every serve rung")
        self.name = name
        self.priority = float(priority)
        self.adaptive = adaptive and len(self._rungs) > 1
        self.latency_fn = latency_fn
        self.verbose = verbose
        n = len(self._rungs)
        profiles = [r.profile(position=i, n=n)
                    for i, r in enumerate(self._rungs)]
        self.controller = SwanController(profiles,
                                         upgrade_patience=upgrade_patience)
        self.timeline = Timeline()
        self._expected: Dict[str, float] = {}
        if latency_fn is not None:
            for r in self._rungs:
                self._expected[r.name] = r.latency_estimate_s
        self._steps_on_rung = 0
        self._step_idx = 0
        self._prepared = False
        # p99 token-latency SLO: every resident request receives one token
        # per engine step, so the step's observed latency IS each of those
        # tokens' latency; a sliding window of them estimates the p99
        self.slo_p99_s = slo_p99_s
        self.slo_min_samples = slo_min_samples
        self._slo_window: Deque[float] = collections.deque(maxlen=slo_window)
        self._slo_tokens = 0
        self._slo_attained = 0

    # -- SocJob surface ------------------------------------------------------
    def rungs(self) -> Sequence[ServeRung]:
        return self._rungs

    @property
    def done(self) -> bool:
        if not self._prepared:
            return False
        resident = any(u is not None for u in self.engine.slot_uid)
        # a sequence swapped to host memory is mid-stream, not finished —
        # draining included: it owns its admission and must resume
        swapped = bool(getattr(self.engine, "swapped", None))
        if self.state == DRAINING:
            return not resident and not swapped
        return not self.engine.queue and not resident and not swapped

    def drain(self, tick: int = 0) -> None:
        super().drain(tick)
        if self.state == DRAINING:
            self.engine.drain()

    # -- SLO -----------------------------------------------------------------
    def slo_headroom(self) -> Optional[float]:
        if self.slo_p99_s is None or \
                len(self._slo_window) < self.slo_min_samples:
            return None
        p99 = float(np.percentile(np.asarray(self._slo_window), 99.0))
        return (self.slo_p99_s - p99) / self.slo_p99_s

    def slo_stats(self) -> Dict[str, Any]:
        """Attainment = fraction of emitted tokens whose step latency met the
        SLO (the per-token view the paper's interactivity constraint cares
        about)."""
        head = self.slo_headroom()
        return {
            "slo_p99_s": self.slo_p99_s,
            "headroom": None if head is None else round(head, 4),
            "tokens": self._slo_tokens,
            "attained_tokens": self._slo_attained,
            "attainment": round(self._slo_attained / self._slo_tokens, 4)
            if self._slo_tokens else None,
        }

    def prepare(self) -> None:
        if self._prepared:
            return
        for req in self._requests:
            self.engine.submit(req)
        self._apply_rung(self.active_rung)
        self._prepared = True

    def step(self, tick: int) -> StepReport:
        t0 = time.perf_counter()
        emitted = self.engine.step()
        dt = time.perf_counter() - t0
        # the first quantum on a rung pays the migration's tail, as in the
        # reference; so does every quantum whose compiled decode or verify
        # step did not replay (its eager first call, or its capture, after a
        # dtype or impl migration or a new verify window): neither may
        # calibrate the controller, which would read a capture as a 10-100x
        # slowdown and walk further down
        warmup = self._steps_on_rung == 0 or bool(
            getattr(self.engine, "last_step_compiled", False))
        self._steps_on_rung += 1
        kv = getattr(self.engine, "kv", None)
        pressure = kv.pool.utilization() if kv is not None else None
        return StepReport(latency_s=dt, work=float(len(emitted)),
                          warmup=warmup, pool_pressure=pressure)

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """Block-pool accounting for paged engines (None under contig):
        the engine's pool/prefix/swap counters, for runtime dashboards."""
        kv = getattr(self.engine, "kv", None)
        if kv is None:
            return None
        st = self.engine.stats()
        keys = ("prefill_chunks", "prefill_chunks_skipped", "cow_copies",
                "table_rows_shipped", "table_uploads", "swapped",
                "swap_outs", "swap_ins")
        out = {k: st[k] for k in keys if k in st}
        out["pool"] = st["pool"]
        return out

    def publish_metrics(self, metrics) -> None:
        """Serving occupancy/SLO/prefix/swap gauges + block-pool accounting
        under one registry (``engine.stats()`` and ``pool.stats()`` in the
        shared schema)."""
        st = self.engine.stats()
        lab = {"job": self.name}

        def g(name: str, help: str = ""):
            return metrics.gauge(name, help).labels(**lab)

        g("serve_tokens_out", "total generated tokens").set(
            float(st["tokens_out"]))
        g("serve_decode_steps").set(float(st["decode_steps"]))
        g("serve_occupancy", "live slots / slot cap").set(
            float(st["occupancy"]))
        g("serve_queue_depth").set(float(len(self.engine.queue)))
        g("serve_shed_total").set(float(st["shed"]))
        g("serve_timeouts_total").set(float(st["timeouts"]))
        g("serve_rejected_total").set(float(st["rejected"]))
        g("serve_draft_depth", "active speculative draft depth").set(
            float(st.get("draft_depth", 0)))
        if "spec_acceptance" in st:
            g("serve_spec_acceptance",
              "accepted/drafted ratio").set(float(st["spec_acceptance"]))
        head = self.slo_headroom()
        if head is not None:
            g("serve_slo_headroom").set(float(head))
        if self._slo_tokens:
            g("serve_slo_attainment").set(self._slo_attained /
                                          self._slo_tokens)
        kv = getattr(self.engine, "kv", None)
        if kv is not None:
            for k in ("prefill_chunks", "prefill_chunks_skipped",
                      "cow_copies", "table_rows_shipped", "swapped",
                      "swap_outs", "swap_ins"):
                if k in st:
                    g(f"serve_{k}").set(float(st[k]))
            kv.publish_metrics(metrics, stats=st["pool"], **lab)

    def observe(self, tick: int, report: StepReport,
                slowdown: float) -> Optional[str]:
        rung = self.active_rung
        dt = report.latency_s
        if self.latency_fn is not None:
            observed = float(self.latency_fn(self._step_idx, rung, dt))
        else:
            observed = dt * slowdown
        report.observed_s = observed
        if self.slo_p99_s is not None and report.work > 0:
            self._slo_window.append(observed)
            self._slo_tokens += int(report.work)
            if observed <= self.slo_p99_s:
                self._slo_attained += int(report.work)
        self.timeline.record_step(step=self._step_idx, rung=rung.name,
                                  latency_s=round(dt, 6),
                                  observed_s=round(observed, 6), loss=0.0,
                                  work=report.work, warmup=report.warmup)
        return self._monitor_proposal(report, rung, dt, observed)

    def end_tick(self, tick: int) -> None:
        # incremented here, not in observe(): a migration committed by the
        # arbiter between the two must be recorded at the step that caused
        # it (keeps serve and train migrations tick-aligned when merged)
        self._step_idx += 1

    def migrate(self, direction: str, reason: str,
                tick: int) -> Optional[MigrationRecord]:
        prev = self.controller.idx
        self.controller.commit(direction, reason)
        if self.controller.idx == prev:
            return None
        from_rung, to_rung = self._rungs[prev], self.active_rung
        t0 = time.perf_counter()
        self._apply_rung(to_rung)
        cost_s = time.perf_counter() - t0
        self._recalibrate(from_rung, to_rung)
        self._steps_on_rung = 0
        if self.verbose:
            print(f"[swan] {self.name}: migrate {from_rung.name} -> "
                  f"{to_rung.name} ({reason})")
        return self.timeline.record_migration(
            step=self._step_idx, from_rung=from_rung.name,
            to_rung=to_rung.name, reason=reason, kind="in-place",
            cost_s=round(cost_s, 6))

    def _apply_rung(self, rung: ServeRung) -> None:
        self.engine.set_slot_cap(rung.slot_cap)
        self.engine.set_kv_dtype(rung.kv_dtype)
        self.engine.set_attn_impl(rung.attn_impl)
        if hasattr(self.engine, "set_draft_depth"):
            self.engine.set_draft_depth(rung.draft_depth)

    def result(self) -> Dict[int, Any]:
        return self.engine.finished


# ---------------------------------------------------------------------------
# ForegroundAppJob: the preemptor
# ---------------------------------------------------------------------------


class ForegroundAppJob(SocJob):
    """An interactive foreground app (paper §3: on-device training must never
    hurt user experience). It produces no arbiter-accounted goodput — it
    *occupies* the SoC: while one of its bursts is active the runtime pauses
    every preemptible co-tenant outright (background training checkpoints and
    releases its state) instead of merely downgrading it, and the app's power
    draw keeps heating the shared ThermalTrace so co-tenants that stay up
    still feel it thermally.

    Bursts are ``(start, stop)`` tick intervals — scripted up front, or
    injected live (:meth:`add_burst`) by the chaos harness.
    """

    is_foreground = True
    preemptible = False

    def __init__(self, bursts: Sequence[Sequence[int]] = (), *,
                 name: str = "foreground", latency_s: float = 0.016,
                 power: float = 2.0, sensitivity: float = 1.0):
        self.name = name
        self.priority = 1e9  # absolute: expressed via preemption, not scores
        self.adaptive = False
        self.latency_fn = None
        self._bursts: List[List[int]] = [[int(a), int(b)] for a, b in bursts]
        self._latency_s = float(latency_s)
        rung = ServeRung(name="fg-active", interference_sensitivity=sensitivity,
                         rel_latency=1.0, latency_estimate_s=latency_s,
                         power_draw=power)
        self._rungs = [rung]
        self.controller = SwanController([rung.profile()])
        self.timeline = Timeline()
        self._expected: Dict[str, float] = {rung.name: latency_s}
        self._tick = -1

    # -- schedule ------------------------------------------------------------
    def add_burst(self, start: int, stop: int) -> None:
        if stop <= start:
            raise ValueError(f"bad burst [{start}, {stop})")
        self._bursts.append([int(start), int(stop)])

    def demands_soc(self, tick: int) -> bool:
        """True while the user is interacting — the runtime preempts
        preemptible co-tenants for exactly these ticks."""
        return any(a <= tick < b for a, b in self._bursts)

    # -- SocJob surface ------------------------------------------------------
    def rungs(self) -> Sequence[ServeRung]:
        return self._rungs

    def power_draw(self) -> float:
        # an idle foreground app draws nothing; only its bursts heat the die
        return super().power_draw() if self.demands_soc(self._tick) else 0.0

    def sensitivity(self) -> float:
        return super().sensitivity() if self.demands_soc(self._tick) else 0.0

    @property
    def done(self) -> bool:
        # done once past the last scripted burst; chaos may add more later,
        # which flips this back (the property is recomputed every tick)
        return not any(self._tick < b for _, b in self._bursts)

    def begin_tick(self, tick: int) -> None:
        self._tick = tick

    def step(self, tick: int) -> StepReport:
        self._tick = tick
        if not self.demands_soc(tick):
            return StepReport(latency_s=0.0, work=0.0)
        return StepReport(latency_s=self._latency_s, work=0.0)

    def observe(self, tick: int, report: StepReport,
                slowdown: float) -> Optional[str]:
        if report.latency_s > 0.0:
            observed = report.latency_s * slowdown
            report.observed_s = observed
            self.timeline.record_step(step=tick, rung="fg-active",
                                      latency_s=round(report.latency_s, 6),
                                      observed_s=round(observed, 6), loss=0.0,
                                      work=0.0)
        return None  # never proposes; never migrates

    def migrate(self, direction: str, reason: str,
                tick: int) -> Optional[MigrationRecord]:
        return None
