#!/usr/bin/env python3
"""Time the speculative verify kernels of one source tree on one GPU.

    python3 bench_decode_spec.py [--src DIR] [--serve]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's checks of ``flash_decode_spec`` and ``flash_decode_spec_paged``:
  B8 K8 G4 hd64, Smax 1024 or 64 blocks of 16 a row, bases 0-1024, S = 5
  and 2 in f32 and in bf16 with lowp, then in f32 at a long cache (T 512,
  Smax 8192) and at S = 17 (68 rows; where the tree takes it); each against
  its plain version, with the kernel's, the plain version's and the
  library's times, the bound and the row blocks and splits of the tree's
  plan;
- the device time of each kernel one wrapper call launches, for both
  kernels in f32 at S = 5 and both caches (``torch.profiler``, L2 flushed
  before each of 20 calls), beside the time of one and of two tiny kernels
  timed as the kernel is (the floor of a call);
- where the tree has the split plan (``spec_plan``): the serve shape in f32
  at S = 5 with 4, 8 and 16 splits, whatever the plan would choose; and
  both kernels in f32 at S = 1, 2, 5 and 17 (T 64), at S = 5 over T 512,
  and at S = 5 (T 64) in one split;
- phases 9-11 with ``--serve``: llama3.2-1b at full width served paged,
  with swap, then speculatively at draft depth 4, contiguous and paged
  (phase 11, its streams held to a contiguous pallas run of the same
  requests), with tokens/s and a profile of a speculative paged step.

Prints the card's name and power limit, then one JSON line. Exits non-zero
without a CUDA device, or after the JSON line when a check failed (so that
a deliberately altered tree, say one without its copies, is still timed).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent
SERVE_BASES = [0, 1, 193, 300, 511, 700, 1021, 1024]  # phase 3's, T = 64


def inputs(fa, paged: bool, T: int, bases, S: int = 5):
    """A call of one verify kernel in f32 at phase 3's shape, T blocks of 16
    (Smax = 16 T for the contiguous cache)."""
    g = torch.Generator(device="cuda").manual_seed(T + paged)
    B, K, G, hd, bs = (chip_smoke.DEC[k] for k in ("B", "K", "G", "hd", "bs"))
    q = torch.randn(B, K, S, G, hd, generator=g, device="cuda")
    base = torch.tensor(bases, dtype=torch.int32, device="cuda")
    if paged:
        kp, vp, table = chip_smoke.paged_inputs(g, torch.float32, B, K, hd, bs, T)
        return lambda: fa.flash_decode_spec_paged(q, kp, vp, table, base)
    k, v = (torch.randn(B, bs * T, K, hd, generator=g, device="cuda") for _ in range(2))
    return lambda: fa.flash_decode_spec(q, k, v, base)


def kernel_device_us(fa) -> dict:
    """Device us of each kernel a wrapper call launches, and a call's floor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    out = {"one_tiny_kernel_ms": chip_smoke.time_ms(lambda: x.zero_()),
           "two_tiny_kernels_ms": chip_smoke.time_ms(lambda: (x.zero_(), x.add_(1)))}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for paged in (False, True):
        for T, bases in [(64, SERVE_BASES), (512, chip_smoke.SPEC_LONG_BASES)]:
            fn = inputs(fa, paged, T, bases)
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            label = f"{'paged' if paged else 'contig'} T{T}"
            out[label] = {e.key[:80]: e.self_device_time_total / e.count
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key}
            print(f"[bench] {label} device us a call: {out[label]}", flush=True)
    return out


def ms_by_splits(fa) -> dict:
    """The serve shape's f32 ms at S = 5 under 4, 8 and 16 splits."""
    plan, out = fa.decode_paged_plan, {}
    try:
        for paged in (False, True):
            fn = inputs(fa, paged, 64, SERVE_BASES)
            for splits in (4, 8, 16):
                fa.decode_paged_plan = lambda T, *a, n=splits: (n, -(-T // n))
                key = f"{'paged' if paged else 'contig'} {splits}"
                out[key] = chip_smoke.time_ms(fn)
                print(f"[bench] T=64 f32 S=5 {key} splits: {out[key]:.4f} ms", flush=True)
    finally:
        fa.decode_paged_plan = plan
    return out


def ms_by_shape(fa) -> dict:
    """Both kernels' f32 ms at S = 1, 2, 5 and 17 (T 64), at S = 5 over
    T 512, and at S = 5 (T 64) with its keys in one split a row block."""
    plan, out = fa.decode_paged_plan, {}
    for paged in (False, True):
        kind = "paged" if paged else "contig"
        for S, T, one in [(1, 64, False), (2, 64, False), (5, 64, False), (17, 64, False),
                          (5, 512, False), (5, 64, True)]:
            fn = inputs(fa, paged, T, SERVE_BASES if T == 64 else chip_smoke.SPEC_LONG_BASES, S)
            key = f"{kind} S{S} T{T}" + (" 1 split" if one else "")
            try:
                if one:
                    fa.decode_paged_plan = lambda T_, *a: (1, T_)
                out[key] = chip_smoke.time_ms(fn)
            finally:
                fa.decode_paged_plan = plan
            print(f"[bench] {key}: {out[key]:.4f} ms", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--serve", action="store_true",
                    help="also run phases 9-11 (paged, swap and speculative serving)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode_spec: no CUDA device", file=sys.stderr)
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
    out = {"src": args.src, "device": smi}
    for paged in (False, True):
        checks = chip_smoke.check_flash_decode_spec(fa, ref, gather_paged_kv, paged)
        out["flash_decode_spec_paged" if paged else "flash_decode_spec"] = checks
    out["device_us"] = kernel_device_us(fa)
    if hasattr(fa, "spec_plan"):
        out["ms_by_splits"] = ms_by_splits(fa)
        out["ms_by_shape"] = ms_by_shape(fa)
    if args.serve:
        cfg = get_config("llama3.2-1b")
        reqs = chip_smoke.make_requests(serve, cfg.vocab_size)
        out["serve_paged"], out["serve_spec"], _ = chip_smoke.paged_and_spec_phases(
            fa, serve, build_model, cfg, reqs, None)
    print(json.dumps({"bench_decode_spec": out}))
    bad = [c for k in ("flash_decode_spec", "flash_decode_spec_paged") for c in out[k]
           if not c["ok"]]
    chip_smoke.check(not bad, f"kernel disagrees with its plain version: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
