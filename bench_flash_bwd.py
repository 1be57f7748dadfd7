#!/usr/bin/env python3
"""Time the attention backward kernels of one source tree on one GPU.

    python3 bench_flash_bwd.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs two pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's check of ``flash_bwd_dq`` and ``flash_bwd_dkv``: B4 H32 S512
  hd64 causal in f32, in bf16 with lowp and in bf16 without it, B2 in f32,
  then a ragged f32 case; each against its plain version, with the
  kernel's, the plain version's and SDPA's backward times and the bound;
- phase 8: llama3.2-1b at full width on the default rung ladder under the
  interference trace 2:6:3.0, 10 steps, with each rung's median step ms
  and a profile of one more step on the last (bf16) rung.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import ref
    from repro_torch.launch.train import make_batch_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"[bench] {smi}; repro_torch from {fb.__file__}", flush=True)
    dq, dkv = chip_smoke.check_flash_bwd(fb, ref)
    for c in dq + dkv:
        chip_smoke.check(c["ok"], f"kernel disagrees with its plain version: {c}")
    cfg = get_config("llama3.2-1b")
    batch_fn = make_batch_fn(cfg, chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"],
                             seed=chip_smoke.TRAIN["seed"])
    adaptive = chip_smoke.adaptive_phase(fa, cfg, batch_fn)
    print(json.dumps({"bench_flash_bwd": {"src": args.src, "device": smi,
                                          "flash_bwd_dq": dq, "flash_bwd_dkv": dkv,
                                          "adaptive": adaptive}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
