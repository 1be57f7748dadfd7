"""The device half of the fleet: one FL client round as a SocJob.

``fl/`` modeled a client round as a closed-form latency formula; here the
round actually *runs* through the arbiter. :class:`FLTrainJob` wraps a
client's local training as a preemptible, checkpointable
:class:`~repro_torch.engine.jobs.SocJob`: its ladder is the client's Swan plan
(pruned ``ChoiceProfile`` ladder, or the single greedy profile under the
baseline policy), a foreground-app burst pauses it outright through the
checkpoint-and-release path, and the closed-loop ``ThermalTrace`` /
``EnergyLoan`` machinery sees the summed power of everything on the die.

Determinism is load-bearing: every source of randomness (model-update
contributions, foreground bursts) is a stateless function of
``(seed, cid, round, step)``, so a crash-resumed coordinator replays the
identical fleet, and a paused-and-resumed job produces a bitwise-identical
update to an uninterrupted one.

A copy of the JAX package's ``fleet/job.py``: a client's update stays a
numpy ``dim``-vector, as there. One change at the checkpoint boundary: the
port's ``checkpoint.store`` restores CPU tensors where the reference's
restores numpy arrays, so a restored state goes through :func:`host_arrays`
before the fleet's numpy arithmetic and crc32 acceptance read it (and its
dicts come back in the reference's key order).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import energy as E
from repro_torch.core.controller import SwanController
from repro_torch.core.cost import ChoiceProfile, ladder_sensitivities
from repro_torch.core.planner import explore_soc
from repro_torch.core.profiler import greedy_baseline_profile
from repro_torch.engine.events import ChargingTrace, ThermalTrace
from repro_torch.engine.jobs import ForegroundAppJob, SocJob, StepReport
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.engine.timeline import MigrationRecord, Timeline
from repro_torch.fl.traces import BatteryTrace

# power_w -> the runtime's normalized power units (ThermalTrace heat /
# EnergyLoan charge are calibrated against sensitivities around 1.0)
POWER_NORM = 4.0


def host_arrays(tree):
    """A restored state as the reference's store returns it: every tensor
    leaf a numpy array of its dtype, every dict with its keys sorted (the
    reference's checkpoint manager saves through ``jax.tree_util``, which
    orders dict keys, so a resumed coordinator's per-class dicts, and the
    JSON made from them, come out in that order). Lists, tuples and other
    leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_arrays(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_arrays(v) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class FLRung:
    """One execution choice of a client's ladder, as an arbiter-visible rung."""
    name: str
    interference_sensitivity: float
    rel_latency: float  # vs the top rung (goodput cost of running here)
    latency_estimate_s: float  # clean per-local-step wall time
    power_draw: float  # normalized units (power_w / POWER_NORM)
    energy_j: float  # per local step


def fl_rungs(profiles: Sequence[ChoiceProfile]) -> List[FLRung]:
    sens = ladder_sensitivities(len(profiles))
    base = profiles[0].latency_s
    return [FLRung(name=p.name, interference_sensitivity=s,
                   rel_latency=p.latency_s / base,
                   latency_estimate_s=p.latency_s,
                   power_draw=p.power_w / POWER_NORM,
                   energy_j=p.energy_j)
            for p, s in zip(profiles, sens)]


@functools.lru_cache(maxsize=None)
def _swan_ladder(device: str, workload: str):
    return tuple(explore_soc(device, workload).ladder)


@functools.lru_cache(maxsize=None)
def _baseline_profile(device: str, workload: str) -> ChoiceProfile:
    return greedy_baseline_profile(E.SOC_MODELS[device], workload)


class FleetClient:
    """Persistent per-device state across rounds: battery trace, energy loan,
    execution-choice ladder and the rung the controller last settled on."""

    def __init__(self, cid: int, device: str, trace: BatteryTrace,
                 workload: str, *, policy: str = "swan",
                 n_samples: int = 200):
        self.cid = int(cid)
        self.device = device
        self.trace = trace
        self.workload = workload
        self.policy = policy
        self.n_samples = int(n_samples)
        self.model = E.SOC_MODELS[device]
        self.loan = E.EnergyLoan(
            battery_j=self.model.battery_j,
            daily_charge_j=0.55 * self.model.battery_j,
            daily_usage_j=0.5 * self.model.battery_j)
        if policy == "swan":
            self.profiles: List[ChoiceProfile] = list(
                _swan_ladder(device, workload))
        else:  # PyTorch-greedy baseline (§5.1): one non-adaptive choice
            self.profiles = [_baseline_profile(device, workload)]
        self.rungs = fl_rungs(self.profiles)
        self.rung_idx = 0  # carried across rounds (controller warm start)

    def available(self, minute: float) -> bool:
        """The paper's isActive: loan headroom + (charging or level > 0.35)."""
        level, state = self.trace.at(minute)
        if not self.loan.available(level):
            return False
        return state >= 0 or level > 0.35

    def charging(self, minute: float) -> bool:
        return self.trace.at(minute)[1] > 0

    def end_of_day(self) -> None:
        self.loan.repay_daily()


class FLTrainJob(SocJob):
    """One client's local round under SwanRuntime arbitration.

    One tick = one local step. The model-update contribution of step ``i`` is
    a stateless function of ``(seed, cid, round, i)`` — no RNG object to
    checkpoint — so pause/exact-resume only needs the accumulated delta and
    the step counter. ``on_pause`` checkpoints and releases the delta
    (checksummed, torn-write-safe via ``repro_torch.checkpoint``); ``on_resume``
    restores it at the exact pre-pause step.
    """

    preemptible = True

    def __init__(self, client: FleetClient, *, rnd: int, local_steps: int,
                 dim: int, seed: int, ckpt_dir: str,
                 name: str = "fl-train", upgrade_patience: int = 3):
        self.client = client
        self.rnd = int(rnd)
        self.local_steps = int(local_steps)
        self.dim = int(dim)
        self.seed = int(seed)
        self.name = name
        self.priority = 1.0
        self._rungs = client.rungs
        profiles = client.profiles
        self.adaptive = client.policy == "swan" and len(profiles) > 1
        self.latency_fn = None
        self.controller = SwanController(profiles,
                                         upgrade_patience=upgrade_patience)
        start = min(max(int(client.rung_idx), 0), len(profiles) - 1)
        if start:
            self.controller.idx = start
            self.controller.monitor.rebase(profiles[start].latency_s)
        self.timeline = Timeline()
        self._expected: Dict[str, float] = {
            r.name: r.latency_estimate_s for r in self._rungs}
        self._delta: Optional[np.ndarray] = np.zeros(dim, np.float32)
        self._local_step = 0
        self._energy_j = 0.0
        self._steps_on_rung = 0
        self._done_tick: Optional[int] = None
        self._ckpt_dir = ckpt_dir
        self._mgr = None
        self.pauses = 0

    # -- SocJob surface ------------------------------------------------------
    def rungs(self) -> Sequence[FLRung]:
        return self._rungs

    @property
    def done(self) -> bool:
        return self._local_step >= self.local_steps

    @property
    def energy_j(self) -> float:
        return self._energy_j

    @property
    def done_tick(self) -> Optional[int]:
        return self._done_tick

    def _contribution(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed, self.client.cid, self.rnd, step, 11))
        return (0.01 * rng.standard_normal(self.dim)).astype(np.float32)

    def step(self, tick: int) -> StepReport:
        assert self._delta is not None, "stepped while paused/released"
        rung = self.active_rung
        self._delta = self._delta + self._contribution(self._local_step)
        self._local_step += 1
        self._energy_j += rung.energy_j
        warmup = self._steps_on_rung == 0
        self._steps_on_rung += 1
        return StepReport(latency_s=rung.latency_estimate_s, work=1.0,
                          warmup=warmup)

    def observe(self, tick: int, report: StepReport,
                slowdown: float) -> Optional[str]:
        rung = self.active_rung
        dt = report.latency_s
        observed = dt * slowdown
        report.observed_s = observed
        self.timeline.record_step(step=tick, rung=rung.name,
                                  latency_s=round(dt, 6),
                                  observed_s=round(observed, 6), loss=0.0,
                                  work=report.work, warmup=report.warmup)
        return self._monitor_proposal(report, rung, dt, observed)

    def migrate(self, direction: str, reason: str,
                tick: int) -> Optional[MigrationRecord]:
        prev = self.controller.idx
        self.controller.commit(direction, reason)
        if self.controller.idx == prev:
            return None
        from_rung, to_rung = self._rungs[prev], self.active_rung
        self._recalibrate(from_rung, to_rung)
        self._steps_on_rung = 0
        return self.timeline.record_migration(
            step=tick, from_rung=from_rung.name, to_rung=to_rung.name,
            reason=reason, kind="in-place", cost_s=0.0)

    def end_tick(self, tick: int) -> None:
        if self.done and self._done_tick is None:
            self._done_tick = tick

    # -- pause / exact resume ------------------------------------------------
    def _ckpt(self):
        if self._mgr is None:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._mgr = CheckpointManager(self._ckpt_dir, keep=2)
        return self._mgr

    def on_pause(self, tick: int) -> None:
        mgr = self._ckpt()
        mgr.save(self._local_step, {"delta": self._delta,
                                    "energy_j": self._energy_j})
        self._delta = None  # the foreground app wants the memory
        self.pauses += 1
        rung = self.active_rung.name
        self.timeline.record_migration(step=tick, from_rung=rung,
                                       to_rung=rung, reason="pause",
                                       kind="pause", cost_s=0.0)

    def on_resume(self, tick: int) -> None:
        restored = self._ckpt().restore_latest()
        if restored is None:
            raise RuntimeError(
                f"{self.name}: no readable checkpoint to resume from")
        step, state = restored
        state = host_arrays(state)
        self._local_step = int(step)
        self._delta = np.asarray(state["delta"], dtype=np.float32)
        self._energy_j = float(state["energy_j"])
        rung = self.active_rung.name
        self.timeline.record_migration(step=tick, from_rung=rung,
                                       to_rung=rung, reason="resume",
                                       kind="pause", cost_s=0.0)

    # -- the finished update --------------------------------------------------
    def update_payload(self):
        """(delta, crc32) of the finished round — the checksum travels with
        the update so the coordinator can reject in-flight corruption."""
        if not self.done or self._delta is None:
            raise RuntimeError("round not finished")
        delta = np.array(self._delta, copy=True)
        return delta, zlib.crc32(delta.tobytes())


# ---------------------------------------------------------------------------
# one client round, end to end
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClientOutcome:
    """What the coordinator hears back from one invited device (or doesn't:
    ``status`` offline/preempted/straggler means no update arrived)."""
    cid: int
    status: str  # ok | offline | preempted | straggler | churn
    latency_s: float  # device wall time spent (arrival offset added by caller)
    energy_j: float
    n_samples: int
    device: str
    charging: bool
    delta: Optional[np.ndarray] = None
    checksum: Optional[int] = None
    preemptions: int = 0
    migrations: int = 0
    rung: str = ""


def _round_wall_s(timeline: Timeline, done_tick: Optional[int]) -> float:
    """Wall time of the round from the merged timeline: jobs share each tick,
    so a tick lasts as long as its slowest job's observed quantum; sum over
    the ticks up to the training job's completion."""
    per: Dict[int, float] = {}
    for s in timeline.steps:
        if done_tick is not None and s.step > done_tick:
            continue
        v = s.observed_s if s.observed_s is not None else s.latency_s
        per[s.step] = max(per.get(s.step, 0.0), v)
    return float(sum(per.values()))


def run_client_round(client: FleetClient, rnd: int, t_min: float, cfg, *,
                     ckpt_root: str) -> ClientOutcome:
    """Drive one client's local round through its own SwanRuntime.

    ``cfg`` carries the device-sim knobs (``local_steps``, ``dim``, ``seed``,
    ``fg_prob``, ``fg_power``, ``fg_latency_factor``, ``heat_rate``,
    ``cool_rate``, ``thermal_slowdown``, ``charge_rate``, ``tick_slack``) —
    any object with those attributes works (``FleetConfig`` does).

    The runtime sees the trace-derived device condition at invite time:
    battery level + charging state feed the EnergyLoan, a per-round
    closed-loop ThermalTrace integrates the summed draw, and a
    (seed, cid, round)-deterministic foreground burst may pause the job
    outright mid-round. Mid-round dropout is detected afterwards by probing
    the trace across the round's wall time.
    """
    level, bstate = client.trace.at(t_min)
    rungs = client.rungs
    top_lat = rungs[0].latency_estimate_s
    job = FLTrainJob(client, rnd=rnd, local_steps=cfg.local_steps,
                     dim=cfg.dim, seed=cfg.seed,
                     ckpt_dir=os.path.join(ckpt_root,
                                           f"c{client.cid}_r{rnd}"))
    jobs: List[SocJob] = [job]
    cap = cfg.local_steps + cfg.tick_slack
    rng = np.random.default_rng((cfg.seed, client.cid, int(rnd), 5))
    if float(rng.random()) < cfg.fg_prob:
        start = int(rng.integers(2, max(3, cfg.local_steps)))
        dur = int(rng.integers(2, 7))
        jobs.append(ForegroundAppJob(
            [(start, start + dur)],
            latency_s=cfg.fg_latency_factor * top_lat, power=cfg.fg_power))
    thermal = ThermalTrace(heat_rate=cfg.heat_rate, cool_rate=cfg.cool_rate,
                           slowdown=cfg.thermal_slowdown)
    charging = ChargingTrace(((0, cap, cfg.charge_rate),)) \
        if bstate > 0 else None
    runtime = SwanRuntime(jobs, trace=thermal, energy=client.loan,
                          battery_level=level,
                          energy_unit_j=POWER_NORM * top_lat,
                          charging=charging)
    res = runtime.run(cap)
    if client.policy == "swan":
        client.rung_idx = min(job.controller.idx, len(rungs) - 1)
    migrations = len(job.timeline.migrations) - 2 * job.pauses
    wall = _round_wall_s(res.timeline, job.done_tick)
    base = dict(cid=client.cid, energy_j=job.energy_j,
                n_samples=client.n_samples, device=client.device,
                charging=bool(bstate > 0), preemptions=res.preemptions,
                migrations=max(0, migrations), rung=job.active_rung.name)
    if not job.done:
        status = "preempted" if res.preemptions else "straggler"
        return ClientOutcome(status=status, latency_s=wall, **base)
    # mid-round dropout: the trace may take the device offline while it runs
    for frac in (0.5, 1.0):
        probe = t_min + (wall / 60.0) * frac
        lvl, st = client.trace.at(probe)
        if not (client.loan.available(lvl) and (st >= 0 or lvl > 0.35)):
            return ClientOutcome(status="offline", latency_s=wall * frac,
                                 **base)
    delta, crc = job.update_payload()
    return ClientOutcome(status="ok", latency_s=wall, delta=delta,
                         checksum=crc, **base)
