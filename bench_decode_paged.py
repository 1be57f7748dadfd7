#!/usr/bin/env python3
"""Time the paged decode kernel of one source tree on one GPU.

    python3 bench_decode_paged.py [--src DIR] [--no-serve]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs two pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's check of ``flash_decode_paged``: B8 K8 G4 hd64, 64 blocks of 16
  a row, ragged lengths 0-1030, in f32 and in bf16 with lowp, then in f32
  at a 512-entry table; each against its plain version, with the kernel's,
  the plain version's and the gather + SDPA times, the bound and the
  number of splits the tree's plan chose;
- the device time of each kernel one wrapper call launches, at both
  tables in f32 (``torch.profiler``, L2 flushed before each of 20 calls),
  beside the time of one and of two tiny kernels timed as the kernel is
  (the floor of a call);
- where the tree has the split plan (``decode_paged_plan``): the serve
  shape in f32 with 4, 8 and 16 splits, whatever the plan would choose;
- phases 9 and 10 (unless ``--no-serve``): llama3.2-1b at full width served
  paged with shared prefixes, then with the swap policy over a pool cut to
  half the worst case, pallas against the plain path, with tokens/s and a
  profile of a paged decode step.

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
SERVE_LENGTHS = [0, 1, 193, 300, 511, 700, 1024, 1030]  # phase 3's, T = 64


def inputs(fa, T, lens):
    g = torch.Generator(device="cuda").manual_seed(T)
    B, K, G, hd, bs = (chip_smoke.DEC[k] for k in ("B", "K", "G", "hd", "bs"))
    q = torch.randn(B, K, G, hd, generator=g, device="cuda")
    kp, vp, table = chip_smoke.paged_inputs(g, torch.float32, B, K, hd, bs, T)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return lambda: fa.flash_decode_paged(q, kp, vp, table, lengths)


def kernel_device_us(fa) -> dict:
    """Device us of each kernel a wrapper call launches, and a call's floor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    out = {"one_tiny_kernel_ms": chip_smoke.time_ms(lambda: x.zero_()),
           "two_tiny_kernels_ms": chip_smoke.time_ms(lambda: (x.zero_(), x.add_(1)))}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for T, lens in [(64, SERVE_LENGTHS), (512, [0, 1, 193, 1030, 2900, 5000, 8192, 8200])]:
        fn = inputs(fa, T, lens)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out[f"T{T}"] = {e.key[:80]: e.self_device_time_total / e.count
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key}
        print(f"[bench] T={T} device us a call: {out[f'T{T}']}", flush=True)
    return out


def ms_by_splits(fa) -> dict:
    """The serve shape's f32 ms under 4, 8 and 16 splits."""
    fn, plan, out = inputs(fa, 64, SERVE_LENGTHS), fa.decode_paged_plan, {}
    try:
        for splits in (4, 8, 16):
            fa.decode_paged_plan = lambda *a, n=splits: (n, 64 // n)
            out[splits] = chip_smoke.time_ms(fn)
            print(f"[bench] T=64 f32 {splits} splits: {out[splits]:.4f} ms", flush=True)
    finally:
        fa.decode_paged_plan = plan
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--no-serve", action="store_true",
                    help="time the kernel only, without phases 9 and 10")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode_paged: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.paging import gather_paged_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"[bench] {smi}; repro_torch from {fa.__file__}", flush=True)
    paged = chip_smoke.check_flash_decode_paged(fa, ref, gather_paged_kv)
    for c in paged:
        chip_smoke.check(c["ok"], f"kernel disagrees with its plain version: {c}")
    out = {"src": args.src, "device": smi, "flash_decode_paged": paged,
           "device_us": kernel_device_us(fa)}
    if hasattr(fa, "decode_paged_plan"):
        out["ms_by_splits"] = ms_by_splits(fa)
    if not args.no_serve:
        cfg = get_config("llama3.2-1b")
        reqs = chip_smoke.make_requests(serve, cfg.vocab_size)
        out["serve_paged"], _, _ = chip_smoke.paged_and_spec_phases(
            fa, serve, build_model, cfg, reqs, None, spec_phase=False)
    print(json.dumps({"bench_decode_paged": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
