"""FleetCoordinator: the round lifecycle over thousands of device sims.

A round is: select online clients → over-provisioned invite (StragglerPolicy)
→ run each invitee's :func:`~repro_torch.fleet.job.run_client_round` → one bounded
retry/backoff wave for fast-detectable failures (churn, offline) → deliver
updates through the fleet fault model (dropped / duplicated / corrupted) →
accept in arrival order against a **binding** deadline plus a stale-update
window → aggregate → advance fleet time.

Crash consistency: before acceptance begins, the full arrival list is
persisted as a write-ahead log inside the coordinator's durable state
(``repro_torch.checkpoint`` — checksummed, atomic, torn-write-safe), and the
partial aggregate + accepted set are re-persisted after *every* accepted
update. A coordinator crash mid-aggregation (:class:`CoordinatorCrash`,
injected by ``engine.chaos.FleetChaos``) therefore resumes from the WAL
without losing or double-counting a single accepted update — the final
aggregate is bitwise identical to a crash-free run's. Everything stochastic
(selection, device sims, fault schedule) is a stateless function of
``(seed, round, client)``, which is what makes that replay exact. (The Oort
selector keeps in-process utility state and is supported for ordinary runs,
but bitwise crash-parity is only guaranteed with ``selector="random"``.)

A copy of the JAX package's ``fleet/coordinator.py``, numpy as there: the
global model and every update are numpy vectors. :meth:`FleetCoordinator.resume`
turns the restored state's tensors back into numpy arrays and orders its
dicts' keys as the reference's restore does (``fleet.job.host_arrays``),
since the port's checkpoint store restores CPU tensors in insertion order.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.fl.selection import OortSelector, random_selection
from repro_torch.fl.simulator import DEVICE_MIX, TASK_CEILING, TASK_TAU
from repro_torch.fl.traces import BatteryTrace, make_client_traces
from repro_torch.fleet.job import (ClientOutcome, FleetClient, host_arrays,
                                   run_client_round)
from repro_torch.runtime.fault import StragglerPolicy


class CoordinatorCrash(RuntimeError):
    """The coordinator process died mid-aggregation (chaos-injected). The
    durable state on disk is consistent; ``FleetCoordinator.resume`` picks
    the round back up."""


@dataclasses.dataclass
class FleetConfig:
    workload: str = "shufflenet-v2"
    n_clients: int = 2400
    clients_per_round: int = 25
    rounds: int = 6
    policy: str = "swan"  # swan | baseline
    selector: str = "random"  # random | oort
    local_steps: int = 16
    dim: int = 32
    seed: int = 0
    # round lifecycle
    deadline_factor: float = 3.0  # x fleet-median clean round wall
    round_deadline_s: float = 0.0  # explicit absolute deadline (0 = derive)
    stale_frac: float = 0.25  # stale window = frac x deadline
    over_provision: float = 1.3
    max_retries: int = 1  # retry waves for fast-detectable failures
    retry_backoff_s: float = 10.0
    agg_s: float = 30.0  # aggregation/communication time per round
    # device-sim knobs (consumed by fleet.job.run_client_round)
    fg_prob: float = 0.2
    fg_power: float = 1.2
    fg_latency_factor: float = 2.0
    heat_rate: float = 0.06
    cool_rate: float = 0.05
    thermal_slowdown: float = 2.2
    charge_rate: float = 2.0
    tick_slack: int = 16


@dataclasses.dataclass
class FleetRound:
    rnd: int
    t_min: float  # fleet clock at round END (minutes)
    accuracy: float
    online: int
    invited: int
    accepted: int
    accepted_on_time: int
    stale_accepted: int
    shortfall: int
    churned: int
    offline: int
    preempted: int
    straggled: int
    dropped: int
    duplicated: int
    dup_rejected: int
    corrupt_rejected: int
    late_rejected: int
    retries: int
    round_s: float
    deadline_s: float
    energy_j: float
    useful_samples: float
    agg_crc: int
    accepted_cids: List[int]
    by_class: Dict[str, int]
    by_class_energy: Dict[str, float]
    charging_accepted: int
    preemptions: int


@dataclasses.dataclass
class FleetResult:
    rounds: List[FleetRound]
    policy: str
    workload: str

    @property
    def final_accuracy(self) -> float:
        return self.rounds[-1].accuracy if self.rounds else 0.0

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for r in self.rounds:
            if r.accuracy >= target:
                return r.t_min
        return None

    @property
    def wall_min(self) -> float:
        return self.rounds[-1].t_min if self.rounds else 0.0

    @property
    def goodput_samples_per_h(self) -> float:
        useful = sum(r.useful_samples for r in self.rounds)
        hours = self.wall_min / 60.0
        return useful / hours if hours > 0 else 0.0

    @property
    def slo_attainment(self) -> float:
        """Fraction of target aggregation slots filled by an on-time update —
        the round-level deadline SLO (accepted + shortfall = the round's
        target k)."""
        target = sum(r.accepted + r.shortfall for r in self.rounds)
        on_time = sum(r.accepted_on_time for r in self.rounds)
        return on_time / target if target else 0.0

    @property
    def total_energy_j(self) -> float:
        return sum(r.energy_j for r in self.rounds)

    def energy_by_class(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.rounds:
            for dev, j in r.by_class_energy.items():
                out[dev] = out.get(dev, 0.0) + j
        return out

    def accepted_by_class(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.rounds:
            for dev, n in r.by_class.items():
                out[dev] = out.get(dev, 0) + n
        return out

    def to_json(self) -> dict:
        return {
            "policy": self.policy,
            "workload": self.workload,
            "final_accuracy": round(self.final_accuracy, 6),
            "wall_min": round(self.wall_min, 3),
            "goodput_samples_per_h": round(self.goodput_samples_per_h, 3),
            "slo_attainment": round(self.slo_attainment, 4),
            "total_energy_j": round(self.total_energy_j, 1),
            "energy_by_class": {k: round(v, 1)
                                for k, v in self.energy_by_class().items()},
            "accepted_by_class": self.accepted_by_class(),
            "rounds": [dataclasses.asdict(r) for r in self.rounds],
        }


def build_fleet_clients(cfg: FleetConfig, *,
                        traces: Optional[Sequence[BatteryTrace]] = None
                        ) -> List[FleetClient]:
    """The 2400-client cohort: quality-filtered traces x 24 timezone shifts,
    the five-device mix, per-client sample counts from a stateless stream.
    Pass ``traces`` to reuse one generated trace set across policies (traces
    are never mutated)."""
    if traces is None:
        traces = make_client_traces(max(1, math.ceil(cfg.n_clients / 24)),
                                    seed=cfg.seed, tz_shifts=24)
    traces = list(traces)[:cfg.n_clients]
    if len(traces) < cfg.n_clients:
        raise ValueError(f"need {cfg.n_clients} traces, got {len(traces)}")
    clients = []
    for i in range(cfg.n_clients):
        rng = np.random.default_rng((cfg.seed, i, 7))
        clients.append(FleetClient(
            i, DEVICE_MIX[i % len(DEVICE_MIX)], traces[i], cfg.workload,
            policy=cfg.policy,
            n_samples=int(rng.lognormal(4.5, 1.0)) + 16))
    return clients


class FleetCoordinator:
    """Owns the round lifecycle and the durable round state."""

    def __init__(self, clients: Sequence[FleetClient], cfg: FleetConfig, *,
                 state_dir: str, chaos=None):
        from repro_torch.checkpoint.manager import CheckpointManager
        self.clients: Dict[int, FleetClient] = {c.cid: c for c in clients}
        self.cfg = cfg
        self.chaos = chaos  # engine.chaos.FleetChaos
        self.straggler = StragglerPolicy(over_provision=cfg.over_provision,
                                         deadline_factor=cfg.deadline_factor)
        self.oort = OortSelector() if cfg.selector == "oort" else None
        self.mgr = CheckpointManager(os.path.join(state_dir, "coord"), keep=4)
        self._ckpt_root = os.path.join(state_dir, "pause")
        self._seq = 0
        self.state: Dict = {
            "round": 0, "t_min": 0.0, "samples_seen": 0.0, "last_day": 0,
            "global": np.zeros(cfg.dim, np.float32), "rounds": [],
            "inflight": None,
        }
        # one fleet-wide deadline, fixed up front: deadline_factor x the
        # fleet-median clean round wall under this policy's selected choice.
        # Deterministic across crash-resume (never depends on round state).
        if cfg.round_deadline_s > 0:
            self._deadline_s = float(cfg.round_deadline_s)
        else:
            walls = sorted(c.profiles[0].latency_s * cfg.local_steps
                           for c in self.clients.values())
            med = walls[len(walls) // 2] if walls else 1.0
            self._deadline_s = cfg.deadline_factor * med

    @classmethod
    def resume(cls, clients: Sequence[FleetClient], cfg: FleetConfig, *,
               state_dir: str, chaos=None) -> "FleetCoordinator":
        """Reload durable state after a coordinator crash. Pass the *same*
        client objects (their device sims for the in-flight round already
        ran — only aggregation is replayed) and the same chaos instance (a
        fresh one with the same ``crash_at`` would just crash again)."""
        co = cls(clients, cfg, state_dir=state_dir, chaos=chaos)
        restored = co.mgr.restore_latest()
        if restored is not None:
            seq, state = restored
            co._seq = int(seq)
            co.state = host_arrays(state)
        return co

    # -- durable state --------------------------------------------------------
    def _save(self) -> None:
        self._seq += 1
        self.mgr.save(self._seq, self.state)

    # -- the lifecycle --------------------------------------------------------
    def run(self, rounds: Optional[int] = None) -> FleetResult:
        rounds = self.cfg.rounds if rounds is None else int(rounds)
        if self.state["inflight"] is not None:
            self._finish_round()  # crash recovery: complete the WAL'd round
        while int(self.state["round"]) < rounds:
            self._run_round(int(self.state["round"]))
        return self.result()

    def deadline_s(self) -> float:
        return self._deadline_s

    def _run_round(self, rnd: int) -> None:
        with obs.get_telemetry().span("fleet.round", rnd=rnd):
            self._run_round_inner(rnd)

    def _run_round_inner(self, rnd: int) -> None:
        cfg, st = self.cfg, self.state
        t = float(st["t_min"])
        day = int(t // 1440)
        if day != int(st["last_day"]):
            for c in self.clients.values():
                c.end_of_day()
            st["last_day"] = day
        online = [c.cid for c in self.clients.values() if c.available(t)]
        deadline = self._deadline_s
        stale_s = cfg.stale_frac * deadline
        if not online:
            self._record_empty_round(rnd, t, deadline)
            return
        k = min(cfg.clients_per_round, len(online))
        invite_n = min(self.straggler.n_to_invite(k), len(online))
        rng = np.random.default_rng((cfg.seed, rnd, 211))
        if self.oort is not None:
            chosen = self.oort.select(rng, online, invite_n, deadline)
        else:
            chosen = random_selection(rng, online, invite_n)
        chosen = [int(c) for c in chosen]
        gone = self.chaos.churn(rnd, chosen) if self.chaos is not None \
            else set()
        outcomes: List[ClientOutcome] = []
        arrival_off: List[float] = []
        for cid in chosen:
            if cid in gone:
                c = self.clients[cid]
                outcomes.append(ClientOutcome(
                    cid=cid, status="churn", latency_s=0.0, energy_j=0.0,
                    n_samples=c.n_samples, device=c.device,
                    charging=c.charging(t)))
                arrival_off.append(0.0)
                continue
            with obs.get_telemetry().span("fleet.invite", rnd=rnd, cid=cid):
                outcomes.append(run_client_round(self.clients[cid], rnd, t,
                                                 cfg,
                                                 ckpt_root=self._ckpt_root))
            arrival_off.append(0.0)
        # bounded retry waves: churn/offline are detectable before the
        # deadline (missing heartbeat); stragglers and foreground preemptions
        # are only discovered at the deadline, too late to replace
        retries = 0
        tried = set(chosen)
        wave_members = list(range(len(outcomes)))
        for wave in range(1, cfg.max_retries + 1):
            failed_fast = [i for i in wave_members
                           if outcomes[i].status in ("churn", "offline")]
            pool = [c for c in online if c not in tried]
            if not failed_fast or not pool:
                break
            rrng = np.random.default_rng((cfg.seed, rnd, 223, wave))
            repl = random_selection(rrng, pool,
                                    min(len(failed_fast), len(pool)))
            backoff = wave * cfg.retry_backoff_s
            wave_members = []
            for cid in (int(c) for c in repl):
                tried.add(cid)
                retries += 1
                wave_members.append(len(outcomes))
                with obs.get_telemetry().span("fleet.invite", rnd=rnd,
                                              cid=cid, wave=wave):
                    outcomes.append(run_client_round(
                        self.clients[cid], rnd, t + backoff / 60.0, cfg,
                        ckpt_root=self._ckpt_root))
                arrival_off.append(backoff)
        # delivery: the network loses, re-sends, and corrupts updates
        counters = {"churned": 0, "offline": 0, "preempted": 0,
                    "straggled": 0, "dropped": 0, "duplicated": 0,
                    "dup_rejected": 0, "corrupt_rejected": 0,
                    "late_rejected": 0, "preemptions": 0}
        by_class_energy: Dict[str, float] = {}
        energy = 0.0
        arrivals: List[Dict] = []
        for o, off in zip(outcomes, arrival_off):
            energy += o.energy_j
            by_class_energy[o.device] = \
                by_class_energy.get(o.device, 0.0) + o.energy_j
            counters["preemptions"] += o.preemptions
            if o.status == "churn":
                counters["churned"] += 1
            elif o.status in ("offline", "preempted", "straggler"):
                counters[o.status if o.status != "straggler"
                         else "straggled"] += 1
            if o.delta is None:
                continue
            fate = self.chaos.delivery(rnd, o.cid) \
                if self.chaos is not None else "ok"
            if fate == "dropped":
                counters["dropped"] += 1
                continue
            delta = o.delta
            if fate == "corrupt":
                delta = self.chaos.corrupt_bytes(rnd, o.cid, delta)
            entry = {"cid": o.cid, "arrival_s": float(off + o.latency_s),
                     "delta": np.asarray(delta, np.float32),
                     "n_samples": int(o.n_samples),
                     "checksum": int(o.checksum), "device": o.device,
                     "charging": int(o.charging)}
            arrivals.append(entry)
            if fate == "duplicated":
                counters["duplicated"] += 1
                arrivals.append({**entry,
                                 "arrival_s": entry["arrival_s"] + 1.0})
        arrivals.sort(key=lambda a: (a["arrival_s"], a["cid"]))
        # WAL: everything acceptance needs is durable BEFORE it begins
        st["inflight"] = {
            "rnd": rnd, "t_start": t, "online": len(online),
            "invited": len(chosen) + retries, "k": k,
            "deadline_s": deadline, "stale_s": stale_s,
            "arrivals": arrivals, "next_idx": 0,
            "accepted_cids": [], "accepted_on_time": 0, "stale_accepted": 0,
            "last_accept_s": 0.0,
            "agg": np.zeros(cfg.dim, np.float64), "weight": 0.0,
            "useful_samples": 0.0, "counters": counters,
            "by_class": {}, "by_class_energy": by_class_energy,
            "charging_accepted": 0, "retries": retries, "energy_j": energy,
        }
        self._save()
        self._finish_round()

    def _finish_round(self) -> None:
        """Acceptance + aggregation from the durable in-flight state. Safe to
        re-enter after a crash at any accepted-update boundary: the cursor,
        partial aggregate and accepted set were persisted together."""
        cfg, st = self.cfg, self.state
        infl = st["inflight"]
        rnd = int(infl["rnd"])
        k = int(infl["k"])
        deadline = float(infl["deadline_s"])
        stale_s = float(infl["stale_s"])
        arrivals = infl["arrivals"]
        counters = infl["counters"]
        accepted = set(int(c) for c in infl["accepted_cids"])
        i = int(infl["next_idx"])
        while i < len(arrivals):
            a = arrivals[i]
            i += 1
            infl["next_idx"] = i
            if len(accepted) >= k:
                continue  # capacity reached; drain the cursor
            arrival = float(a["arrival_s"])
            if arrival > deadline + stale_s:
                counters["late_rejected"] += 1
                continue
            cid = int(a["cid"])
            if cid in accepted:
                counters["dup_rejected"] += 1
                continue
            delta = np.asarray(a["delta"], np.float32)
            if zlib.crc32(np.ascontiguousarray(delta).tobytes()) != \
                    int(a["checksum"]):
                counters["corrupt_rejected"] += 1
                continue
            with obs.get_telemetry().span("fleet.accept", rnd=rnd, cid=cid):
                n = int(a["n_samples"])
                infl["agg"] = np.asarray(infl["agg"], np.float64) \
                    + delta.astype(np.float64) * n
                infl["weight"] = float(infl["weight"]) + n
                infl["useful_samples"] = \
                    float(infl["useful_samples"]) + n * 0.2
                accepted.add(cid)
                infl["accepted_cids"] = sorted(accepted)
                if arrival <= deadline:
                    infl["accepted_on_time"] = \
                        int(infl["accepted_on_time"]) + 1
                else:
                    infl["stale_accepted"] = int(infl["stale_accepted"]) + 1
                infl["last_accept_s"] = max(float(infl["last_accept_s"]),
                                            arrival)
                dev = a["device"]
                infl["by_class"][dev] = int(infl["by_class"].get(dev, 0)) + 1
                infl["charging_accepted"] = \
                    int(infl["charging_accepted"]) + int(a["charging"])
                self._save()  # accepted set + partial aggregate are one atom
            if self.chaos is not None and \
                    self.chaos.crash_now(rnd, len(accepted)):
                raise CoordinatorCrash(
                    f"injected crash: round {rnd} after "
                    f"{len(accepted)} accepted updates")
        self._finalize_round()

    def _finalize_round(self) -> None:
        cfg, st = self.cfg, self.state
        infl = st["inflight"]
        rnd = int(infl["rnd"])
        k = int(infl["k"])
        deadline = float(infl["deadline_s"])
        stale_s = float(infl["stale_s"])
        weight = float(infl["weight"])
        n_accepted = len(infl["accepted_cids"])
        if weight > 0:
            upd = np.asarray(infl["agg"], np.float64) / weight
            st["global"] = (np.asarray(st["global"], np.float64)
                            + upd).astype(np.float32)
        st["samples_seen"] = float(st["samples_seen"]) \
            + float(infl["useful_samples"])
        ceiling = TASK_CEILING[cfg.workload]
        tau = TASK_TAU[cfg.workload]
        acc = ceiling * (1.0 - math.exp(-float(st["samples_seen"]) / tau))
        if n_accepted >= k and k > 0:
            round_s = float(infl["last_accept_s"])
        else:
            round_s = deadline + stale_s  # waited out the whole window
        t_end = float(infl["t_start"]) + round_s / 60.0 + cfg.agg_s / 60.0
        if self.oort is not None:
            loss = max(0.1, 2.3 * (1 - float(st["samples_seen"])
                                   / (float(st["samples_seen"]) + tau)))
            for cid in infl["accepted_cids"]:
                self.oort.report(int(cid), loss,
                                 self.clients[int(cid)].n_samples, round_s)
        rec = FleetRound(
            rnd=rnd, t_min=t_end, accuracy=acc,
            online=int(infl["online"]), invited=int(infl["invited"]),
            accepted=n_accepted,
            accepted_on_time=int(infl["accepted_on_time"]),
            stale_accepted=int(infl["stale_accepted"]),
            shortfall=max(0, k - n_accepted),
            churned=int(infl["counters"]["churned"]),
            offline=int(infl["counters"]["offline"]),
            preempted=int(infl["counters"]["preempted"]),
            straggled=int(infl["counters"]["straggled"]),
            dropped=int(infl["counters"]["dropped"]),
            duplicated=int(infl["counters"]["duplicated"]),
            dup_rejected=int(infl["counters"]["dup_rejected"]),
            corrupt_rejected=int(infl["counters"]["corrupt_rejected"]),
            late_rejected=int(infl["counters"]["late_rejected"]),
            retries=int(infl["retries"]), round_s=round_s,
            deadline_s=deadline, energy_j=float(infl["energy_j"]),
            useful_samples=float(infl["useful_samples"]),
            agg_crc=zlib.crc32(
                np.ascontiguousarray(st["global"]).tobytes()),
            accepted_cids=[int(c) for c in infl["accepted_cids"]],
            by_class={str(d): int(n)
                      for d, n in infl["by_class"].items()},
            by_class_energy={str(d): float(j)
                             for d, j in infl["by_class_energy"].items()},
            charging_accepted=int(infl["charging_accepted"]),
            preemptions=int(infl["counters"]["preemptions"]))
        st["rounds"].append(dataclasses.asdict(rec))
        st["t_min"] = t_end
        st["round"] = rnd + 1
        st["inflight"] = None
        self._save()
        tel = obs.get_telemetry()
        if tel.enabled:
            m = tel.metrics
            lab = {"policy": cfg.policy}
            m.gauge("fleet_round", "last finalized round").labels(
                **lab).set(float(rnd))
            m.gauge("fleet_round_goodput_samples",
                    "useful samples this round").labels(**lab).set(
                rec.useful_samples)
            m.gauge("fleet_accuracy").labels(**lab).set(rec.accuracy)
            m.counter("fleet_accepted_total").labels(**lab).inc(n_accepted)
            m.counter("fleet_invited_total").labels(**lab).inc(rec.invited)
            m.histogram("fleet_round_s", "wall-clock round length").labels(
                **lab).observe(rec.round_s)
            tel.snap(f"fleet-round-{rnd}")

    def _record_empty_round(self, rnd: int, t: float,
                            deadline: float) -> None:
        st = self.state
        t_end = t + 10.0
        rec = FleetRound(
            rnd=rnd, t_min=t_end,
            accuracy=TASK_CEILING[self.cfg.workload]
            * (1.0 - math.exp(-float(st["samples_seen"])
                              / TASK_TAU[self.cfg.workload])),
            online=0, invited=0, accepted=0, accepted_on_time=0,
            stale_accepted=0, shortfall=0, churned=0, offline=0,
            preempted=0, straggled=0, dropped=0, duplicated=0,
            dup_rejected=0, corrupt_rejected=0, late_rejected=0,
            retries=0, round_s=0.0, deadline_s=deadline, energy_j=0.0,
            useful_samples=0.0,
            agg_crc=zlib.crc32(
                np.ascontiguousarray(st["global"]).tobytes()),
            accepted_cids=[], by_class={}, by_class_energy={},
            charging_accepted=0, preemptions=0)
        st["rounds"].append(dataclasses.asdict(rec))
        st["t_min"] = t_end
        st["round"] = rnd + 1
        self._save()

    def result(self) -> FleetResult:
        rounds = [FleetRound(**d) for d in self.state["rounds"]]
        return FleetResult(rounds=rounds, policy=self.cfg.policy,
                           workload=self.cfg.workload)


def run_fleet(cfg: FleetConfig, *, state_dir: str, chaos=None,
              clients: Optional[Sequence[FleetClient]] = None,
              traces: Optional[Sequence[BatteryTrace]] = None
              ) -> FleetResult:
    """Build the cohort (unless given) and run the configured rounds."""
    if clients is None:
        clients = build_fleet_clients(cfg, traces=traces)
    coord = FleetCoordinator(clients, cfg, state_dir=state_dir, chaos=chaos)
    return coord.run()
