#!/usr/bin/env python3
"""Time the depthwise-conv and RMSNorm kernels of one source tree on one GPU.

    python3 bench_depthwise_rmsnorm.py [--src DIR] [--no-cnn] [--no-attention]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's check of ``depthwise_conv``: every stride-1 depthwise layer
  shape of MobileNetV2 and ShuffleNetV2 at batch 128, 3x3, in f32 and bf16,
  and a 5x5 case; and of ``rmsnorm_fwd`` and ``rmsnorm_bwd`` at 4096 x 2048
  (f32, bf16), 512 x 512 and 4096 x 96. Each against its plain version,
  with the kernel's, the plain version's and the library call's times
  (``F.conv2d(groups=C)``, ``F.rms_norm`` and its backward) and the bound;
- the device time of each kernel one ``rmsnorm_bwd`` call launches, at
  4096 x 2048 in f32 and bf16 (``torch.profiler``, L2 flushed before each
  of 20 calls): the kernel beside the wrapper's sum of its partials;
- phase 12 (unless ``--no-cnn``): each CNN's forward ms at batch 128,
  pallas and naive, with the device ms of one forward's depthwise launches
  beside the same layers on ``F.conv2d(groups=C)``;
- phase 3's attention and decode checks (unless ``--no-attention``), for
  their times beside the parent's.

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


def rmsnorm_bwd_device_us(rn) -> dict:
    """Device us of each kernel one rmsnorm_bwd call launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        x, cot = (torch.randn(4096, 2048, generator=g, device="cuda").to(dtype)
                  for _ in range(2))
        s = torch.randn(2048, generator=g, device="cuda").to(dtype)
        rn.rmsnorm_bwd(x, s, cot)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                rn.rmsnorm_bwd(x, s, cot)
            torch.cuda.synchronize()
        key = str(dtype).replace("torch.", "")
        out[key] = {e.key[:80]: e.self_device_time_total / e.count
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key}
        print(f"[bench] rmsnorm_bwd 4096x2048 {key} device us a call: {out[key]}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--no-cnn", action="store_true", help="skip phase 12")
    ap.add_argument("--no-attention", action="store_true",
                    help="skip the attention and decode kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_depthwise_rmsnorm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import build_model
    from repro_torch.paging import gather_paged_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"[bench] {smi}; repro_torch from {dw.__file__}", flush=True)
    out = {"src": args.src, "device": smi,
           "depthwise_conv": chip_smoke.check_depthwise(dw, ref)}
    out["rmsnorm_fwd"], out["rmsnorm_bwd"] = chip_smoke.check_rmsnorm(rn, ref)
    out["rmsnorm_bwd_device_us"] = rmsnorm_bwd_device_us(rn)
    if not args.no_attention:
        out["flash_fwd"] = chip_smoke.check_flash_fwd(fa, ref)
        out["flash_bwd_dq"], out["flash_bwd_dkv"] = chip_smoke.check_flash_bwd(fb, ref)
        out["flash_decode"] = chip_smoke.check_flash_decode(fa, ref)
        out["flash_decode_paged"] = chip_smoke.check_flash_decode_paged(
            fa, ref, gather_paged_kv)
        out["flash_decode_spec"] = chip_smoke.check_flash_decode_spec(
            fa, ref, gather_paged_kv, paged=False)
        out["flash_decode_spec_paged"] = chip_smoke.check_flash_decode_spec(
            fa, ref, gather_paged_kv, paged=True)
    for name, checks in out.items():
        if isinstance(checks, list):
            for c in checks:
                chip_smoke.check(c["ok"], f"{name} disagrees with its plain version: {c}")
    if not args.no_cnn:
        out["cnn_forward"], _ = chip_smoke.cnn_forward_phase(dw, build_model, get_config)
    print(json.dumps({"bench_depthwise_rmsnorm": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
