#!/usr/bin/env python3
"""Time the contiguous decode kernel of one source tree on one GPU.

    python3 bench_decode.py [--src DIR] [--no-serve]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's check of ``flash_decode``: B8 K8 G4 hd64, Smax 1024 at ragged
  lengths 0-1025 and Smax 8192 at those lengths x 8, in f32 and in bf16
  with lowp; each against its plain version, with the kernel's, the plain
  version's and SDPA's times, the bound and the splits of the tree's plan;
- the device time of each kernel one wrapper call launches, at both caches
  in f32 (``torch.profiler``, L2 flushed before each of 20 calls);
- where the tree splits the contiguous cache (``decode_plan``): the serve
  shape in f32 with 4, 8 and 16 splits, whatever the plan would choose;
- phases 4 and 5 (unless ``--no-serve``): llama3.2-1b at full width served
  through the kernels and the plain path, with tokens/s and a profile of a
  decode step (its flash_decode device ms among it).

Prints the card's name and power limit, then one JSON line. Exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent
SERVE_LENGTHS = [0, 1, 193, 300, 511, 700, 1024, 1025]  # phase 3's, Smax 1024


def inputs(fa, Smax, lens):
    g = torch.Generator(device="cuda").manual_seed(Smax)
    B, K, G, hd = 8, 8, 4, 64
    q = torch.randn(B, K, G, hd, generator=g, device="cuda")
    k, v = (torch.randn(B, Smax, K, hd, generator=g, device="cuda") for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return lambda: fa.flash_decode(q, k, v, lengths)


def kernel_device_us(fa) -> dict:
    """Device us of each kernel a wrapper call launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for Smax, lens in [(1024, SERVE_LENGTHS), (8192, chip_smoke.DECODE_LONG)]:
        fn = inputs(fa, Smax, lens)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out[f"Smax{Smax}"] = {e.key[:80]: e.self_device_time_total / e.count
                              for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA
                              and "FillFunctor" not in e.key}
        print(f"[bench] Smax={Smax} device us a call: {out[f'Smax{Smax}']}", flush=True)
        del fn
    return out


def ms_by_splits(fa) -> dict:
    """The serve shape's f32 ms under 4, 8 and 16 splits."""
    fn, plan, out = inputs(fa, 1024, SERVE_LENGTHS), fa.decode_plan, {}
    chunks = -(-1024 // fa.DECODE_CHUNK)
    try:
        for splits in (4, 8, 16):
            fa.decode_plan = lambda *a, n=splits: (n, chunks // n)
            out[splits] = chip_smoke.time_ms(fn)
            print(f"[bench] Smax=1024 f32 {splits} splits: {out[splits]:.4f} ms", flush=True)
    finally:
        fa.decode_plan = plan
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--no-serve", action="store_true",
                    help="time the kernel only, without phases 4 and 5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"[bench] {smi}; repro_torch from {fa.__file__}", flush=True)
    dec = chip_smoke.check_flash_decode(fa, ref)
    for c in dec:
        chip_smoke.check(c["ok"], f"kernel disagrees with its plain version: {c}")
    out = {"src": args.src, "device": smi, "flash_decode": dec,
           "device_us": kernel_device_us(fa)}
    if hasattr(fa, "decode_plan"):
        out["ms_by_splits"] = ms_by_splits(fa)
    if not args.no_serve:
        cfg = get_config("llama3.2-1b")
        reqs = chip_smoke.make_requests(serve, cfg.vocab_size)
        out["serve"], _, _ = chip_smoke.serve_phases(fa, serve, build_model, cfg, reqs)
    print(json.dumps({"bench_decode": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
