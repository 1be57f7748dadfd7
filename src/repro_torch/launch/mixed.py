"""Mixed-workload CLI: training and serving co-tenant on one device (the
JAX package's ``launch/mixed.py``, with ``--device``).

Swan's premise is that workloads share the device; this CLI is the smallest
end-to-end demonstration: one ``TrainSession`` (personalization training in
the background) and one ``ServeJob`` (interactive decode) under a single
``SwanRuntime`` arbiter. The shared ThermalTrace integrates the **summed**
power draw of both jobs — training alone may never trip the throttle, but
training *plus* serving does, and the arbiter decides who relinquishes:
the job whose next rung frees the most contended resource per unit of
goodput lost (priority-weighted). An optional energy budget
(``core.energy.EnergyLoan``) additionally walks jobs toward low-power rungs
once the borrowed battery would cross the critical level. ``--fg-burst``
adds a foreground app whose bursts pause the training job (it checkpoints
and releases its state, and resumes at the exact step); ``--chaos-seed``
injects a seeded fault schedule (``engine.chaos``).

The serving job walks ``default_serve_ladder``: serve-full, serve-capped
(half the slots) and serve-lean (a quarter of the slots and a bf16 KV cache
under the model's f32 weights, which the decode kernels read as such).
``--device cuda`` (the default) runs the hand-written kernels and the
compiled steps, and raises without a card; ``--device cpu`` runs the
kernels' plain versions. ``--admission-policy swap`` (paged layout only)
parks cold residents on the host under pool pressure, which the reference
engine offers and its mixed CLI does not expose.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mixed --device cpu --reduced \\
      --ticks 40 --batch 8 --seq 64 --slots 4 --requests 16 \\
      --thermal-trace 0.2:0.25:3.0 --timeline-out mixed.json
  PYTHONPATH=src python -m repro_torch.launch.mixed --arch llama3.2-1b \\
      --ticks 60 --batch 4 --seq 512 --optimizer adam --lr 3e-4 \\
      --attn-impl pallas --slots 8 --max-seq 1024
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.energy import EnergyLoan
from repro_torch.engine.chaos import ChaosInjector
from repro_torch.engine.events import (ChargingTrace, InterferenceTrace,
                                       ThermalTrace)
from repro_torch.engine.jobs import (ForegroundAppJob, ServeJob,
                                     default_serve_ladder)
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.engine.rungs import default_rung_ladder
from repro_torch.engine.session import TrainSession
from repro_torch.kernels.backend import (auto_attn_impl, auto_decode_impl,
                                         resolve_device)
from repro_torch.launch.serve import (ContinuousBatchingEngine,
                                      _synthetic_requests)
from repro_torch.launch.train import make_batch_fn
from repro_torch.models.registry import build_model
from repro_torch.optim.compression import Compressor
from repro_torch.optim.optimizers import adam, sgd


def build_jobs(args):
    """Job list from the CLI namespace: [train, serve] plus a foreground
    app when ``--fg-burst`` is given. (The arbitration tests build their
    own latency-simulated jobs; this is the real-compute construction
    path.)"""
    device = resolve_device(args.device)
    cfg_t = get_config(args.arch)
    cfg_s = get_config(args.serve_arch or args.arch)
    if args.reduced:
        cfg_t, cfg_s = cfg_t.reduced(), cfg_s.reduced()

    impl_t = args.attn_impl
    if impl_t == "auto":
        impl_t = auto_attn_impl(args.seq, device=device)
    rungs = default_rung_ladder(batch=args.batch, microbatch=args.microbatch,
                                attn_impl=impl_t)
    opt = sgd() if args.optimizer == "sgd" else adam()
    train = TrainSession(
        cfg_t, rungs, optimizer=opt, lr=args.lr,
        compressor=Compressor("none"),
        batch_fn=make_batch_fn(cfg_t, args.batch, args.seq),
        adaptive=True, upgrade_patience=args.upgrade_patience,
        log_every=args.log_every, verbose=False,  # the runtime narrates
        name="train", priority=args.train_priority, device=device)
    train.bind(args.ticks)

    max_seq = args.max_seq or 2 * (args.prompt_len + args.gen)
    impl_s = auto_decode_impl(max_seq, device=device)
    model = build_model(cfg_s, impl=impl_s, device=device)
    params = model.init(model.generator(0))
    engine = ContinuousBatchingEngine(model, params, max_batch=args.slots,
                                      max_seq=max_seq,
                                      kv_layout=args.kv_layout,
                                      admission_policy=args.admission_policy)
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or 3 * args.slots
    reqs = _synthetic_requests(rng, n_req, args.prompt_len, args.gen,
                               cfg_s.vocab_size)
    serve = ServeJob(engine, reqs, rungs=default_serve_ladder(args.slots),
                     name="serve", priority=args.serve_priority,
                     upgrade_patience=args.upgrade_patience,
                     slo_p99_s=args.slo_p99 or None)
    jobs = [train, serve]
    if args.fg_burst:
        bursts = []
        for part in args.fg_burst.split(","):
            a, b = part.split(":")
            bursts.append((int(a), int(b)))
        jobs.append(ForegroundAppJob(bursts=bursts))
    return jobs


def rung_summary(timeline) -> dict:
    """Per rung of one job's timeline: its steps, the median wall ms of its
    steady (non-warmup) steps, and its work per second over them (samples
    or tokens)."""
    out = {}
    for rung in dict.fromkeys(s.rung for s in timeline.steps):
        steps = [s for s in timeline.steps if s.rung == rung]
        steady = [s for s in steps if not s.warmup] or steps
        wall = sum(s.latency_s for s in steady)
        out[rung] = {"steps": len(steps), "steady": len(steady),
                     "median_ms": 1e3 * statistics.median(
                         s.latency_s for s in steady),
                     "work_per_s": sum(s.work for s in steady) / wall
                     if wall > 0 else 0.0}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--serve-arch", default=None,
                    help="serving model (default: same as --arch)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ticks", type=int, default=40,
                    help="runtime quanta (one train step + one decode step "
                         "each); the loop also ends when every job is done")
    # training job
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "naive", "chunked", "pallas"],
                    help="the training job's attention; auto consults "
                         "kernels/backend.auto_attn_impl (the serving job "
                         "takes auto_decode_impl at its cache length)")
    # serving job
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="requests in the stream (default: 3x slots)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--kv-layout", default="contig",
                    choices=("contig", "paged"),
                    help="serving KV layout; 'paged' exercises the block "
                         "pool (prefix sharing, COW) and publishes pool_* "
                         "telemetry metrics")
    ap.add_argument("--slo-p99", type=float, default=0.0,
                    help="p99 per-token latency SLO in seconds (0 = none); "
                         "the arbiter sheds co-tenants while it is violated "
                         "and holds upgrades until it recovers")
    ap.add_argument("--admission-policy", default="serialize",
                    choices=["serialize", "shed", "swap"],
                    help="under KV-pool pressure: 'serialize' stalls the "
                         "queue behind the head, 'shed' rejects with a "
                         "retry-after hint (bounded queue), 'swap' parks "
                         "cold residents on the host (paged layout only)")
    # shared device
    ap.add_argument("--thermal-trace", default="0.2:0.25:3.0",
                    help="shared closed-loop thermal model "
                         "('heat:cool:slowdown[:trigger:release]'; die "
                         "temperature integrates the SUMMED job power draw); "
                         "'' disables")
    ap.add_argument("--interference-trace", default=None,
                    help="scripted co-tenant bursts instead of the thermal "
                         "model ('start:stop:slowdown,...')")
    ap.add_argument("--train-priority", type=float, default=1.0)
    ap.add_argument("--serve-priority", type=float, default=1.0,
                    help="higher priority = arbiter prefers downgrading the "
                         "other job first")
    ap.add_argument("--upgrade-patience", type=int, default=5)
    ap.add_argument("--battery-level", type=float, default=1.0,
                    help="battery fraction; with --battery-j this gates the "
                         "EnergyLoan (depleted budget forces low-power rungs)")
    ap.add_argument("--battery-j", type=float, default=0.0,
                    help="battery capacity in joules (0 disables the energy "
                         "budget); each tick borrows summed-power joules")
    ap.add_argument("--charging-trace", default=None,
                    help="charger plug schedule 'start:stop:watts,...'; "
                         "repays the energy loan while plugged so upgrades "
                         "come back")
    ap.add_argument("--day-ticks", type=int, default=0,
                    help="ticks per 'day'; at each boundary the energy loan "
                         "repays the daily charge surplus (0 disables)")
    ap.add_argument("--fg-burst", default=None,
                    help="foreground-app bursts 'start:stop,...'; while one "
                         "is active every preemptible job is paused "
                         "(training checkpoints + releases its state)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded chaos fault schedule (device "
                         "loss, pool pressure, torn checkpoints, spikes, "
                         "fg bursts) over the run")
    ap.add_argument("--timeline-out", default=None,
                    help="write the merged job-tagged timeline JSON here")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--telemetry-out", default=None,
                    help="directory for the repro_torch.obs telemetry bundle "
                         "(metrics.jsonl, spans.jsonl, trace.json, "
                         "audit.json)")
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels (and raises "
                         "without a card); cpu runs their plain versions")
    ap.add_argument("--quiet", dest="verbose", action="store_false")
    args = ap.parse_args(argv)

    # enable telemetry before any job/engine is constructed so every span
    # source (checkpoint manager, session, runtime) sees the live instance
    tel = obs.enable() if args.telemetry_out else None

    if args.interference_trace and args.thermal_trace:
        args.thermal_trace = ""  # explicit bursts replace the thermal model
    trace = None
    if args.interference_trace:
        trace = InterferenceTrace.parse(args.interference_trace)
    elif args.thermal_trace:
        trace = ThermalTrace.parse(args.thermal_trace)

    energy = None
    if args.battery_j > 0:
        energy = EnergyLoan(battery_j=args.battery_j, daily_charge_j=0.0,
                            daily_usage_j=0.0)
    charging = ChargingTrace.parse(args.charging_trace) \
        if args.charging_trace else None
    chaos = ChaosInjector.random(args.chaos_seed, args.ticks) \
        if args.chaos_seed is not None else None

    jobs = build_jobs(args)
    train, serve = jobs[0], jobs[1]
    rt = SwanRuntime(jobs, trace=trace, energy=energy,
                     battery_level=args.battery_level, charging=charging,
                     day_ticks=args.day_ticks or None, chaos=chaos,
                     verbose=args.verbose)
    res = rt.run(args.ticks)

    s = res.timeline.summary()
    print(f"[swan] {res.ticks} ticks, migrations: {s['n_migrations']} "
          f"(down {s['downgrades']}, up {s['upgrades']})")
    for name, job in res.jobs.items():
        migs = [m for m in res.timeline.migrations if m.job == name]
        print(f"[swan]   {name}: rung={job.active_rung.name} "
              f"work={res.work[name]:.0f} migrations={len(migs)}")
    for name in (train.name, serve.name):
        for rung, r in rung_summary(res.jobs[name].timeline).items():
            print(f"[swan]   {name} on {rung}: {r['steps']} steps, median "
                  f"{r['median_ms']:.2f} ms over {r['steady']} steady, "
                  f"{r['work_per_s']:.1f} "
                  f"{'samples' if name == train.name else 'tokens'}/s")
    tl = train.result()
    print(f"[swan] train: final loss {tl.losses[-1]:.4f} "
          f"(first {tl.losses[0]:.4f})" if tl.losses else "[swan] train: idle")
    done = serve.result()
    print(f"[swan] serve: {len(done)} finished, "
          f"{serve.engine.tokens_out} tokens, "
          f"occupancy {serve.engine.occupancy:.2f}")
    steps = serve.engine.compiled_steps()
    if steps:
        print(f"[swan] serve compiled steps: "
              f"{sum(f.captures for f in steps)} captures, "
              f"{sum(f.replays for f in steps)} replays")
    if serve.slo_p99_s is not None:
        print(f"[swan] serve SLO: {serve.slo_stats()}")
    if serve.engine.rejected:
        print(f"[swan] serve rejected: {len(serve.engine.rejected)} "
              f"(shed {serve.engine.shed_count}, "
              f"timeout {serve.engine.timeout_count})")
    if res.preemptions:
        print(f"[swan] foreground preemptions: {res.preemptions}")
    if chaos is not None:
        print(f"[swan] chaos: applied {sorted(chaos.applied)}; "
              f"{len(chaos.log)} log entries")
    if args.timeline_out:
        res.timeline.save(args.timeline_out)
        print(f"[swan] merged timeline -> {args.timeline_out}")
    if args.json_out:
        payload = obs.versioned({
            "summary": s, "work": res.work,
            "virtual_time_s": round(res.virtual_time_s, 6),
            "preemptions": res.preemptions,
            "per_job": {n: res.timeline.for_job(n).summary()
                        for n in res.timeline.jobs()},
            "per_rung": {n: rung_summary(res.jobs[n].timeline)
                         for n in (train.name, serve.name)}})
        if serve.slo_p99_s is not None:
            payload["slo"] = serve.slo_stats()
        payload["serve_stats"] = serve.engine.stats()
        if chaos is not None:
            payload["chaos"] = chaos.to_json()
        with open(args.json_out, "w") as f:
            json.dump(obs.encode_record(payload), f, indent=1)
    if tel is not None:
        tel.save(args.telemetry_out)
        print(f"[obs] telemetry bundle -> {args.telemetry_out} "
              f"({len(tel.tracer.spans())} spans, "
              f"{len(tel.audit)} audit records)")
    return res


if __name__ == "__main__":
    main()
