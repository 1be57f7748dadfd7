"""Fleet CLI: thousands of trace-driven FL client SoCs, one coordinator.

Runs the fleet coordinator over a quality-filtered battery-trace population:
each selected client executes its local round as a preemptible
:class:`~repro_torch.fleet.job.FLTrainJob` inside its own per-device
``SwanRuntime`` (thermal throttling, energy loan, foreground bursts), while
the coordinator owns invites, deadlines, retry waves, dedup/checksum
acceptance, and crash-consistent aggregation.

Fleet fault injection (client churn, dropped/duplicated/corrupted update
delivery, a coordinator crash) is seeded and optional. With ``--crash-round``
the run demonstrates crash recovery end to end: the coordinator dies
mid-aggregation and is resumed from its durable state in-process —
the final aggregate is bitwise identical to a crash-free run.

The JAX package's ``launch/fleet.py`` with the same flags. It computes on
the host only (the fleet is a numpy simulation), so it takes no
``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fleet --clients 480 --rounds 6 \
      --per-round 20 --policy swan --churn 0.1 --heavy-churn 4:0.35 \
      --drop 0.05 --dup 0.05 --corrupt 0.05 --crash-round 2 \
      --json-out fleet.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile

from repro_torch import obs
from repro_torch.engine.chaos import FleetChaos
from repro_torch.fleet import (CoordinatorCrash, FleetConfig,
                               FleetCoordinator, build_fleet_clients)


def build_chaos(args):
    """FleetChaos from the CLI namespace, or None when nothing is injected."""
    churn_rounds = {}
    if args.heavy_churn:
        for part in args.heavy_churn.split(","):
            rnd, frac = part.split(":")
            churn_rounds[int(rnd)] = float(frac)
    crash_at = (args.crash_round, args.crash_after) \
        if args.crash_round >= 0 else None
    if not (args.churn or churn_rounds or args.drop or args.dup
            or args.corrupt or crash_at):
        return None
    return FleetChaos(seed=args.chaos_seed, churn_prob=args.churn,
                      churn_rounds=churn_rounds or None, drop_prob=args.drop,
                      dup_prob=args.dup, corrupt_prob=args.corrupt,
                      crash_at=crash_at)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=480,
                    help="fleet size (trace set = ceil(n/24) base traces "
                         "x 24 timezone shifts)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--per-round", type=int, default=20,
                    help="aggregation target k per round (invites are "
                         "over-provisioned above this)")
    ap.add_argument("--policy", default="swan", choices=["swan", "baseline"])
    ap.add_argument("--selector", default="random",
                    choices=["random", "oort"],
                    help="client selection; note oort keeps in-process "
                         "utility state, so crash-resume bitwise parity is "
                         "only guaranteed with random")
    ap.add_argument("--workload", default="shufflenet-v2")
    ap.add_argument("--local-steps", type=int, default=16)
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="round deadline in seconds (0 = derive from the "
                         "fleet-median clean round wall time)")
    ap.add_argument("--over-provision", type=float, default=1.3)
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--stale-frac", type=float, default=0.25,
                    help="stale-update acceptance window as a fraction of "
                         "the deadline")
    # fleet fault injection
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--churn", type=float, default=0.0,
                    help="per-round client churn probability")
    ap.add_argument("--heavy-churn", default=None,
                    help="per-round churn overrides 'round:frac,...' "
                         "(e.g. '4:0.35' for a 35%%-churn round 4)")
    ap.add_argument("--drop", type=float, default=0.0,
                    help="update delivery drop probability")
    ap.add_argument("--dup", type=float, default=0.0,
                    help="update duplicate-delivery probability (rejected "
                         "by coordinator dedup)")
    ap.add_argument("--corrupt", type=float, default=0.0,
                    help="update corruption probability (rejected by "
                         "checksum)")
    ap.add_argument("--crash-round", type=int, default=-1,
                    help="crash the coordinator mid-aggregation in this "
                         "round, then resume from durable state (-1 = off)")
    ap.add_argument("--crash-after", type=int, default=3,
                    help="accepted updates before the injected crash fires")
    ap.add_argument("--state-dir", default=None,
                    help="coordinator durable-state directory (default: "
                         "a temporary directory)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--telemetry-out", default=None,
                    help="directory for the repro_torch.obs telemetry bundle "
                         "(metrics.jsonl, spans.jsonl, trace.json, "
                         "audit.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", dest="verbose", action="store_false")
    args = ap.parse_args(argv)

    tel = obs.enable() if args.telemetry_out else None
    cfg = FleetConfig(n_clients=args.clients,
                      clients_per_round=args.per_round, rounds=args.rounds,
                      policy=args.policy, selector=args.selector,
                      workload=args.workload, local_steps=args.local_steps,
                      seed=args.seed, round_deadline_s=args.deadline,
                      stale_frac=args.stale_frac,
                      over_provision=args.over_provision,
                      max_retries=args.max_retries)
    chaos = build_chaos(args)
    clients = build_fleet_clients(cfg)

    tmp = None
    state_dir = args.state_dir
    if state_dir is None:
        tmp = tempfile.TemporaryDirectory()
        state_dir = tmp.name
    try:
        coord = FleetCoordinator(clients, cfg, state_dir=state_dir,
                                 chaos=chaos)
        try:
            res = coord.run()
        except CoordinatorCrash:
            if args.verbose:
                print("[fleet] coordinator crashed mid-aggregation; "
                      "resuming from durable state")
            coord = FleetCoordinator.resume(clients, cfg,
                                            state_dir=state_dir, chaos=chaos)
            res = coord.run()
    finally:
        if tmp is not None:
            tmp.cleanup()

    if args.verbose:
        for r in res.rounds:
            print(f"[fleet] round {r.rnd}: online={r.online} "
                  f"invited={r.invited} accepted={r.accepted} "
                  f"(stale {r.stale_accepted}, shortfall {r.shortfall}) "
                  f"churn={r.churned} offline={r.offline} "
                  f"preempt={r.preempted} straggle={r.straggled} "
                  f"rejects(dup/crc/late)={r.dup_rejected}/"
                  f"{r.corrupt_rejected}/{r.late_rejected} "
                  f"round={r.round_s:.1f}s/{r.deadline_s:.1f}s "
                  f"acc={r.accuracy:.5f}")
    print(f"[fleet] {args.policy}: {len(res.rounds)} rounds, "
          f"goodput {res.goodput_samples_per_h:.0f} samples/h, "
          f"SLO attainment {res.slo_attainment:.3f}, "
          f"energy {res.total_energy_j:.0f} J, "
          f"final accuracy {res.final_accuracy:.5f}")
    by_cls = res.accepted_by_class()
    if by_cls:
        print("[fleet] accepted by device class: "
              + ", ".join(f"{k}={v}" for k, v in sorted(by_cls.items())))
    if chaos is not None:
        print(f"[fleet] chaos: applied {sorted(chaos.applied)}")

    if args.json_out:
        payload = obs.versioned({"config": dataclasses.asdict(cfg),
                                 "result": res.to_json()})
        if chaos is not None:
            payload["chaos"] = chaos.to_json()
        with open(args.json_out, "w") as f:
            json.dump(obs.encode_record(payload), f, indent=1)
        if args.verbose:
            print(f"[fleet] wrote {args.json_out}")
    if tel is not None:
        tel.save(args.telemetry_out)
        print(f"[obs] telemetry bundle -> {args.telemetry_out} "
              f"({len(tel.tracer.spans())} spans)")
    return res


if __name__ == "__main__":
    main()
