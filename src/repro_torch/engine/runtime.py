"""SwanRuntime: one event loop and one arbiter over every job on the SoC.

The paper's engine exists because many workloads contend for one SoC's
resources. Before this module the repo had two disjoint runtimes — the
training session's event loop and the serving engine's — each reacting to
its own view of the device. ``SwanRuntime`` owns the single loop:

- **shared event sources**: the InterferenceTrace / ThermalTrace / fault
  source advance once per tick. The thermal model integrates the **summed**
  power draw of every active job — the die does not care which job heated
  it — so one job's downgrade genuinely cools the machine for the others.
- **arbitrated migration**: each job's SwanController *proposes* ("down" /
  "up") from its own monitor, but the runtime commits at most one downgrade
  per tick — to the job that relinquishes the most contended resource per
  unit of goodput lost (priority-weighted, :meth:`SocJob.relinquish_score`)
  — instead of every pressured controller thrashing down independently.
  Upgrades are also serialized (one per tick) so re-adding power cannot
  re-trip the throttle in a single jump.
- **SLO-headroom arbitration**: a job carrying a latency SLO
  (``SocJob.slo_headroom``) changes the auction from relative goodput to
  absolute deadlines. A violator generates downgrade pressure even when its
  own monitor is quiet, is the *last* candidate to be downgraded further
  (its co-tenants shed first), and upgrades are held device-wide until
  every SLO is back inside its target.
- **foreground preemption**: while a :class:`ForegroundAppJob` burst is
  active, every preemptible job is *paused* — not downgraded. Background
  training checkpoints and releases its state on pause and resumes at the
  exact pre-pause step when the burst ends.
- **shared energy budget**: an optional ``core.energy.EnergyLoan`` is
  charged with the summed draw every tick; once the borrowed energy would
  push the battery below critical, the runtime walks the hungriest job
  down-ladder ("energy" migrations) and blocks upgrades until the budget
  recovers. A ``ChargingTrace`` repays the loan while the charger is
  plugged (and ``day_ticks`` applies the paper's daily surplus), so a
  recharging battery re-enables upgrades.
- **merged timeline**: per-job Timelines are merged into one job-tagged
  runtime timeline (``Timeline.merged``) for benchmarks and tests.

A single-job runtime reduces exactly to the old TrainSession loop —
``TrainSession.run`` is now a thin wrapper that builds one.

Chaos: a fault injector (``engine/chaos.py``) can be attached via
``chaos=``; it is consulted at the top of every tick (to inject device loss,
thermal spikes, pool pressure, foreground bursts, torn checkpoints) and its
``latency_multiplier`` rides on top of the shared trace's slowdown (latency
spikes). The runtime itself never special-cases a fault kind — every
injected fault exercises exactly the recovery path a real one would.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs as _obs
from repro_torch.engine.jobs import SocJob
from repro_torch.engine.timeline import Timeline
from repro_torch.obs.schema import versioned


@dataclasses.dataclass
class RuntimeResult:
    timeline: Timeline  # merged, job-tagged
    ticks: int
    work: Dict[str, float]  # goodput units per job
    virtual_time_s: float  # sum over ticks of the slowest job's observed time
    jobs: Dict[str, SocJob] = dataclasses.field(default_factory=dict)
    preemptions: int = 0  # foreground pauses committed by the runtime

    def summary(self) -> dict:
        return versioned({
            "ticks": self.ticks,
            "virtual_time_s": round(self.virtual_time_s, 6),
            "work": {k: round(v, 4) for k, v in self.work.items()},
            "preemptions": self.preemptions,
            "timeline": self.timeline.summary()})

    def to_json(self) -> dict:
        """Full machine-readable result: the summary plus the merged
        timeline's step/migration records, all through the shared
        ``repro_torch.obs`` encoder (one ``schema_version`` to evolve)."""
        out = self.summary()
        out["timeline"] = self.timeline.to_json()
        return out


class SwanRuntime:
    def __init__(self, jobs: Sequence[SocJob], *, trace=None,
                 elastic=None, fault_events=None,
                 energy=None, battery_level: float = 1.0,
                 energy_unit_j: float = 1.0,
                 charging=None, day_ticks: Optional[int] = None,
                 chaos=None, verbose: bool = False, telemetry=None):
        if not jobs:
            raise ValueError("need at least one job")
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"job names must be unique, got {names}")
        self.jobs = list(jobs)
        self.trace = trace
        self.elastic = elastic
        self.fault_events = fault_events
        self.energy = energy  # core.energy.EnergyLoan (shared battery)
        self.battery_level = float(battery_level)
        self.energy_unit_j = float(energy_unit_j)  # joules per power unit/tick
        self.charging = charging  # engine.events.ChargingTrace
        self.day_ticks = day_ticks  # ticks per "day" for EnergyLoan.repay_daily
        self.chaos = chaos  # engine.chaos.ChaosInjector
        self.verbose = verbose
        self.work: Dict[str, float] = {j.name: 0.0 for j in self.jobs}
        self.virtual_time_s = 0.0
        self.ticks = 0
        self.preemptions = 0
        self._preempted: Set[str] = set()  # jobs paused BY the runtime
        # None -> follow the process-global telemetry (repro_torch.obs), so a CLI
        # enabling it before run() is picked up without plumbing
        self._telemetry = telemetry

    @property
    def obs(self):
        # getattr: arbitration unit tests build bare instances via __new__
        tel = getattr(self, "_telemetry", None)
        return tel if tel is not None else _obs.get_telemetry()

    # -- telemetry -----------------------------------------------------------
    @staticmethod
    def _rung_name(job: SocJob) -> str:
        """Audit-only rung label; tolerant of minimal SocJob test doubles
        that skip the ladder surface."""
        rung = getattr(job, "active_rung", None)
        return getattr(rung, "name", "")

    def _soc_state(self) -> Dict:
        """Energy-loan + thermal context snapshot for audit records."""
        out: Dict = {}
        if self.energy is not None:
            out["energy"] = {
                "loan_j": round(float(self.energy.loan_j), 6),
                "available": bool(self.energy.available(self.battery_level)),
                "battery_level": self.battery_level,
            }
        tr = self.trace
        if tr is not None and hasattr(tr, "temp"):
            out["thermal"] = {"temp": round(float(tr.temp), 6),
                              "throttled": bool(getattr(tr, "throttled",
                                                        False))}
        return out

    def _decision_ctx(self, active: List[SocJob],
                      proposals: List[Tuple[SocJob, str]]) -> Dict:
        """Full scoring context at decision time — what the audit stores so
        "why did the arbiter pick that job" is answerable after the fact."""
        ctx = {
            "scores": {j.name: j.relinquish_score() for j in active},
            "slo_headroom": {j.name: j.slo_headroom() for j in active},
            "proposals": {j.name: p for j, p in proposals},
        }
        ctx.update(self._soc_state())
        return ctx

    def _publish_metrics(self, tick: int, active: List[SocJob]) -> None:
        tel = self.obs
        if not tel.enabled:
            return
        m = tel.metrics
        tr = self.trace
        if tr is not None and hasattr(tr, "temp"):
            m.gauge("thermal_temp_c", "shared die temperature").set(
                float(tr.temp))
            m.gauge("thermal_throttled", "1 while the die throttles").set(
                1.0 if getattr(tr, "throttled", False) else 0.0)
        if self.energy is not None:
            m.gauge("energy_loan_j", "outstanding borrowed energy").set(
                float(self.energy.loan_j))
            m.gauge("energy_available",
                    "1 while the loan budget allows full draw").set(
                1.0 if self.energy.available(self.battery_level) else 0.0)
            m.gauge("battery_level").set(float(self.battery_level))
        m.gauge("runtime_active_jobs").set(float(len(active)))
        m.gauge("runtime_preemptions_total").set(float(self.preemptions))
        for job in active:
            m.gauge("job_rung_idx", "active ladder position (0 = top)"
                    ).labels(job=job.name).set(float(job.rung_idx))
            m.gauge("job_work_total", "cumulative goodput units").labels(
                job=job.name).set(float(self.work[job.name]))
            job.publish_metrics(m)

    # -- shared event sources ------------------------------------------------
    def _advance_trace(self, tick: int, total_power: float) -> None:
        """Advance the shared trace one tick under the summed active-job
        power draw. ThermalTrace advances at most once per distinct step and
        heats with the *first* call's sensitivity — this call — so the die
        temperature integrates everything running, not any one job's view;
        per-job reads afterwards (:meth:`_slowdown_for`, same tick) only
        scale the throttle by each job's own sensitivity. InterferenceTrace
        is stateless so this is a no-op read."""
        if self.trace is not None:
            self.trace.effective_slowdown(tick, total_power)

    def _slowdown_for(self, tick: int, sensitivity: float) -> float:
        s = 1.0
        if self.trace is not None:
            s = self.trace.effective_slowdown(tick, sensitivity)
        if self.chaos is not None:
            s *= self.chaos.latency_multiplier(tick)
        return s

    # -- foreground preemption ----------------------------------------------
    def _preempt(self, tick: int) -> None:
        """Pause every preemptible job while a foreground burst is active;
        resume the ones *this runtime* paused once it clears (a job paused by
        the caller stays paused)."""
        unfinished = [j for j in self.jobs if not j.done]
        fg_active = any(j.is_foreground and j.demands_soc(tick)
                        for j in unfinished)
        for job in unfinished:
            if not job.preemptible:
                continue
            if fg_active and not job.paused:
                job.pause(tick)
                self._preempted.add(job.name)
                self.preemptions += 1
                self._audit_event(tick, job, "pause", rule="foreground")
                if self.verbose:
                    print(f"[swan] tick {tick}: {job.name} paused "
                          f"(foreground)")
            elif not fg_active and job.paused and \
                    job.name in self._preempted:
                job.resume(tick)
                self._preempted.discard(job.name)
                self._audit_event(tick, job, "resume", rule="foreground")
                if self.verbose:
                    print(f"[swan] tick {tick}: {job.name} resumed")

    def _audit_event(self, tick: int, job: SocJob, event: str, *,
                     rule: str = "", detail: str = "") -> None:
        tel = self.obs
        if not tel.enabled:
            return
        rung = self._rung_name(job)
        tel.audit.record(tick=tick, job=job.name, event=event, rule=rule,
                         from_rung=rung, to_rung=rung, detail=detail,
                         **self._soc_state())

    # -- energy --------------------------------------------------------------
    def _account_energy(self, tick: int, total_power: float,
                        active: List[SocJob]) -> Tuple[bool, bool]:
        """Charge this tick's draw to the shared EnergyLoan (and repay it
        while the charger is plugged / at day boundaries). Returns
        (pressed, downgraded): while the borrowed energy would push the
        battery below critical, upgrades are blocked and the hungriest job
        walks one rung toward the low-power end per tick until the ladders
        bottom out — that walk-down also consumes the tick's one-downgrade
        allowance."""
        if self.energy is None:
            return False, False
        self.energy.borrow(total_power * self.energy_unit_j)
        if self.charging is not None:
            rate = self.charging.rate(tick)
            if rate > 0.0:
                self.energy.repay(rate * self.energy_unit_j)
        if self.day_ticks and tick > 0 and tick % self.day_ticks == 0:
            self.energy.repay_daily()
        if self.energy.available(self.battery_level):
            return False, False
        cands = [j for j in active if j.can_downgrade()]
        if cands:
            hungriest = max(cands, key=lambda j: j.power_draw())
            self._commit(hungriest, "down", "energy", tick,
                         ctx=self._decision_ctx(active, [])
                         if self.obs.enabled else None)
        return True, bool(cands)

    # -- arbitration ---------------------------------------------------------
    def _arbitrate(self, tick: int, active: List[SocJob],
                   proposals: List[Tuple[SocJob, str]],
                   allow_upgrades: bool = True,
                   allow_downgrades: bool = True,
                   ctx: Optional[Dict] = None) -> None:
        violators = [j for j in active
                     if (h := j.slo_headroom()) is not None and h < 0.0]
        downs = [j for j, p in proposals if p == "down"]
        if downs or violators:
            if not allow_downgrades:
                return  # this tick's downgrade allowance is already spent
            # contention somewhere on the die (a pressured monitor, or an SLO
            # in violation): downgrade the ONE job whose next rung
            # relinquishes the most contended resource per unit of goodput
            # lost — but never a job already violating its SLO while a
            # co-tenant with headroom can shed instead (taking more from the
            # violator deepens the violation it was meant to fix)
            cands = [j for j in active if j.can_downgrade()]
            safe = [j for j in cands if j not in violators]
            pool = safe or cands
            if pool:
                best = max(pool, key=lambda j: j.relinquish_score())
                if best in downs:
                    reason = "interference"
                elif violators:
                    reason = "slo"
                else:
                    reason = "arbitration"
                self._commit(best, "down", reason, tick, ctx=ctx)
            return
        if not allow_upgrades:
            return
        ups = [j for j, p in proposals if p == "up"]
        # an upgrade re-adds power: hold it while any SLO is still violated
        # (checked above: reaching here means no violators) and never lift a
        # job into violating its own freshly-met SLO
        ups = [j for j in ups
               if (h := j.slo_headroom()) is None or h > 0.0]
        if ups:
            best = max(ups, key=lambda j: j.priority)
            self._commit(best, "up", "clear", tick, ctx=ctx)

    def _commit(self, job: SocJob, direction: str, reason: str,
                tick: int, ctx: Optional[Dict] = None) -> None:
        tel = self.obs
        from_rung = self._rung_name(job) if tel.enabled else ""
        rec = job.migrate(direction, reason, tick)
        if tel.enabled:
            # "commit": the migration applied; "veto": the arbiter chose this
            # job but its controller refused (ladder edge / cooldown). Either
            # way the full scoring context that decided it is preserved.
            tel.audit.record(
                tick=tick, job=job.name,
                event="commit" if rec is not None else "veto",
                direction=direction, rule=reason, from_rung=from_rung,
                to_rung=self._rung_name(job),
                **(ctx if ctx is not None else self._soc_state()))
            if rec is not None:
                tel.metrics.counter("runtime_migrations_total").labels(
                    job=job.name, direction=direction, reason=reason).inc()
        if rec is not None and self.verbose:
            print(f"[swan] tick {tick}: {job.name} {rec.from_rung} -> "
                  f"{rec.to_rung} ({reason})")

    # -- the loop ------------------------------------------------------------
    def run(self, until: int, *, start: int = 0) -> RuntimeResult:
        """Run ticks ``start .. until-1`` (stopping early once every job is
        done). One tick = one scheduling quantum for every active job."""
        for job in self.jobs:
            job.prepare()
        tel = self.obs
        for tick in range(start, until):
            with tel.span("runtime.tick", tick=tick):
                # 0. chaos injection + foreground preemption decide who runs
                if self.chaos is not None:
                    self.chaos.begin_tick(tick, self)
                self._preempt(tick)
                unfinished = [j for j in self.jobs if not j.done]
                if not unfinished:
                    break
                active = [j for j in unfinished if not j.paused]
                for job in active:
                    job.begin_tick(tick)
                # 1. hard events: device loss on the shared pool
                if self.fault_events is not None and self.elastic is not None:
                    failed = tuple(self.fault_events(
                        tick, self.elastic.healthy_ids()))
                    if failed:
                        self.elastic.mark_failed(failed)
                        for job in active:
                            job.on_device_loss(tick, failed)
                            self._audit_event(
                                tick, job, "device-loss", rule="device-loss",
                                detail=f"failed={sorted(failed)}")
                # 2. shared event sources tick once, under the summed draw
                total_power = sum(j.power_draw() for j in active)
                self._advance_trace(tick, total_power)
                # 3. energy budget
                energy_pressed, energy_walked = self._account_energy(
                    tick, total_power, active)
                # 4. one quantum per job; collect monitor proposals
                proposals: List[Tuple[SocJob, str]] = []
                tick_times: List[float] = []
                for job in active:
                    report = job.step(tick)
                    prop = job.observe(
                        tick, report,
                        self._slowdown_for(tick, job.sensitivity()))
                    self.work[job.name] += report.work
                    tick_times.append(report.observed_s if report.observed_s
                                      is not None else report.latency_s)
                    if prop is not None:
                        proposals.append((job, prop))
                    if tel.enabled:
                        # labeled by rung so the per-rung quantile table in
                        # launch.obs_report can separate the ladder's measured
                        # costs (e.g. per-draft-depth speculative latency)
                        tel.metrics.histogram(
                            "job_step_latency_s",
                            "wall latency of one scheduling quantum").labels(
                            job=job.name,
                            rung=job.active_rung.name).observe(
                            report.latency_s)
                if tick_times:
                    # jobs share the tick; its virtual duration is the slowest
                    self.virtual_time_s += max(tick_times)
                # 5. arbitrated migration (at most one down, one up per tick —
                # an energy walk-down counts as the tick's downgrade)
                ctx = self._decision_ctx(active, proposals) \
                    if tel.enabled else None
                if tel.enabled:
                    for j, p in proposals:
                        rung = self._rung_name(j)
                        tel.audit.record(tick=tick, job=j.name,
                                         event="propose", direction=p,
                                         rule="monitor", from_rung=rung,
                                         to_rung=rung, **ctx)
                self._arbitrate(tick, active, proposals,
                                allow_upgrades=not energy_pressed,
                                allow_downgrades=not energy_walked,
                                ctx=ctx)
                for job in active:
                    job.end_tick(tick)
                self._publish_metrics(tick, active)
                tel.snap(tick)
                self.ticks += 1
        # a burst running past the horizon must not strand paused jobs:
        # whoever the runtime paused is resumed before the loop closes
        for job in self.jobs:
            if job.paused and job.name in self._preempted:
                job.resume(until)
                self._preempted.discard(job.name)
        for job in self.jobs:
            job.finalize()
        return self.result()

    def result(self) -> RuntimeResult:
        merged = Timeline.merged({j.name: j.timeline for j in self.jobs})
        return RuntimeResult(timeline=merged, ticks=self.ticks,
                             work=dict(self.work),
                             virtual_time_s=self.virtual_time_s,
                             jobs={j.name: j for j in self.jobs},
                             preemptions=self.preemptions)
