"""Training CLI — a thin front-end over engine.session.TrainSession (the
JAX package's ``launch/train.py``, with ``--device``).

Composes config -> model -> data pipeline -> optimizer -> (optional)
compression -> checkpoint manager, then hands the loop to the engine. With
``--adaptive`` the session runs a Rung downgrade ladder under Swan's
controller and migrates in place when interference appears;
``--interference-trace`` injects synthetic co-tenant bursts
(``start:stop:slowdown[,...]``) and ``--thermal-trace`` closed-loop thermal
throttling (``heat:cool:slowdown[:trigger:release]``, paper §3.3) so the
adaptive path can be exercised on a quiet machine. ``--arch`` accepts any
registry config the port trains: the dense family (``llama3.2-1b``,
``granite-3-2b``, ``nemotron-4-15b``, ``command-r-35b``), the moe family
(``deepseek-moe-16b``, ``deepseek-v3-671b``: the loss adds the router aux
and MTP terms) and the paper's CNNs ``resnet34``, ``mobilenet-v2`` and
``shufflenet-v2`` (trained on synthetic images; ``--seq`` is unused). A CNN
trains on the plain path
(``--attn-impl naive``, which ``auto`` picks at the default ``--seq``): the
depthwise kernel that ``pallas`` selects has no gradient, as in the
reference, and its first backward raises. With ``--adaptive`` a CNN stops
once the ladder reaches its bf16 rung, as the reference does (the conv
refuses f32 images with bf16 weights); ``TrainSession`` over
``default_rung_ladder(include_bf16=False)`` runs the adaptive CNN path.
``--device cuda`` (the default) runs the hand-written kernels and raises
without a card, ``--device cpu`` runs their plain versions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 50 --batch 4 --seq 512 --attn-impl pallas --optimizer adam
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
      --steps 12 --batch 2 --seq 64 --attn-impl pallas --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch deepseek-moe-16b --reduced --steps 6 --batch 2 --seq 32 \
      --attn-impl pallas --optimizer adam --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-v2 \
      --steps 20 --batch 128 --attn-impl naive --optimizer adam --lr 1e-3
  ... --adaptive --interference-trace 40:80:3.0
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_cnn_batch, synthetic_lm_batch
from repro_torch.engine.events import InterferenceTrace, ThermalTrace
from repro_torch.engine.rungs import Rung, default_rung_ladder
from repro_torch.engine.session import TrainSession
from repro_torch.kernels.backend import auto_attn_impl, resolve_device
from repro_torch.optim.compression import Compressor
from repro_torch.optim.optimizers import adam, sgd


def make_batch_fn(cfg, batch, seq, seed=0):
    def fn(step):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        if cfg.family == "cnn":
            return synthetic_cnn_batch(rng, batch, cfg.image_size, cfg.in_channels,
                                       cfg.n_classes)
        b = synthetic_lm_batch(rng, batch, seq, cfg.vocab_size)
        if cfg.family == "vlm":
            b["image_embed"] = rng.standard_normal(
                (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "encdec":
            b["audio_embed"] = rng.standard_normal(
                (batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32) * 0.02
        return b

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "naive", "chunked", "pallas"],
                    help="attention kernel; auto consults backend capability "
                         "and sequence length (kernels/backend.auto_attn_impl)")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--adaptive", action="store_true",
                    help="run the Rung downgrade ladder under Swan's "
                         "controller instead of one static step")
    ap.add_argument("--interference-trace", default=None,
                    help="synthetic co-tenant bursts, e.g. '40:80:2.5,120:140:3'")
    ap.add_argument("--thermal-trace", default=None,
                    help="closed-loop thermal throttling (paper §3.3): "
                         "'heat:cool:slowdown[:trigger:release]', e.g. "
                         "'0.05:0.02:2.5'; mutually exclusive with "
                         "--interference-trace")
    ap.add_argument("--upgrade-patience", type=int, default=5)
    ap.add_argument("--timeline-out", default=None,
                    help="write the migration timeline JSON here")
    ap.add_argument("--telemetry-out", default=None,
                    help="directory for the repro_torch.obs telemetry bundle "
                         "(metrics.jsonl, spans.jsonl, trace.json, "
                         "audit.json)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels (and raises "
                         "without a card); cpu runs their plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tel = obs.enable() if args.telemetry_out else None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    impl = args.attn_impl
    if impl == "auto":
        impl = auto_attn_impl(args.seq, device=device)
    opt = sgd() if args.optimizer == "sgd" else adam()
    comp = Compressor(args.compression)

    if args.adaptive:
        rungs = default_rung_ladder(batch=args.batch,
                                    microbatch=args.microbatch,
                                    attn_impl=impl)
        if len(rungs) == 1:
            print(f"[swan] warning: --batch {args.batch} leaves no deeper "
                  f"accumulation rungs; --adaptive has nothing to migrate to")
    else:
        rungs = [Rung(name="static", microbatch=args.microbatch,
                      attn_impl=impl)]
    if args.interference_trace and args.thermal_trace:
        raise SystemExit("--interference-trace and --thermal-trace are "
                         "mutually exclusive (one trace drives the monitor)")
    trace = InterferenceTrace.parse(args.interference_trace) \
        if args.interference_trace else None
    if args.thermal_trace:
        trace = ThermalTrace.parse(args.thermal_trace)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = None
    start = 0
    if mgr and args.resume:
        restored = mgr.restore_latest()
        if restored:
            start, state = restored  # CPU tensors: the session moves them
            print(f"resumed from step {start}")
    if start >= args.steps:
        print(f"nothing to do: resumed step {start} >= --steps {args.steps}")
        return []

    session = TrainSession(
        cfg, rungs, optimizer=opt, lr=args.lr, compressor=comp,
        batch_fn=make_batch_fn(cfg, args.batch, args.seq),
        ckpt=mgr, ckpt_every=args.ckpt_every, trace=trace,
        adaptive=args.adaptive, upgrade_patience=args.upgrade_patience,
        log_every=args.log_every, device=device)
    result = session.run(args.steps, start=start, state=state)

    losses = result.losses
    summary = result.timeline.summary()
    if args.adaptive or trace:
        print(f"[swan] migrations: {summary['n_migrations']} "
              f"(down {summary['downgrades']}, up {summary['upgrades']}), "
              f"final rung {result.final_rung}")
    if args.timeline_out:
        result.timeline.save(args.timeline_out)
        print(f"[swan] timeline -> {args.timeline_out}")
    if tel is not None:
        tel.save(args.telemetry_out)
        print(f"[obs] telemetry bundle -> {args.telemetry_out} "
              f"({len(tel.tracer.spans())} spans)")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
