#!/usr/bin/env python3
"""Time the attention forward kernel of one source tree on one GPU.

    python3 bench_flash_fwd.py [--src DIR] [--no-adaptive]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be compared on one card in one call, each in its own
process, in turns: parent, change, change, parent. Runs two pieces of
``chip_smoke.py`` (this checkout's) against that tree:

- phase 3's check of ``flash_fwd``: B1 H32 hd64 causal at S 512, 509 and
  256, and the train step's B4 S512, in f32 (and at S512 with lowp), in
  bf16 with lowp and in bf16 without it; each against its plain version,
  with the kernel's, the plain version's and SDPA's times and the bound;
- where the tree's wrapper plans the FFMA kernel's groups of warps a block
  (``fwd_groups``): the f32 forward at B1 S 192, 256, 320, 509 and 512 and
  at B4 S512 with one group and with two, whatever the plan would choose;
- phase 8 (unless ``--no-adaptive``): llama3.2-1b at full width on the
  default rung ladder under the interference trace 2:6:3.0, 10 steps, with
  each rung's median step ms and a profile of one more step on the last
  (bf16) rung: its device-busy ms and the forward kernel's device ms.

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


def ms_by_groups(fa) -> dict:
    """The f32 FFMA forward's ms at each shape under both group plans."""
    g = torch.Generator(device="cuda").manual_seed(1)
    plan, out = fa.fwd_groups, {}
    try:
        for B, S in [(1, 192), (1, 256), (1, 320), (1, 509), (1, 512), (4, 512)]:
            q, k, v = (torch.randn(B, 32, S, 64, generator=g, device="cuda")
                       for _ in range(3))
            for groups in (1, 2):
                fa.fwd_groups = lambda *a, n=groups: n
                out[f"B{B} S{S} groups {groups}"] = chip_smoke.time_ms(
                    lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True))
                print(f"[bench] f32 B{B} S{S} groups {groups}: "
                      f"{out[f'B{B} S{S} groups {groups}']:.4f} ms", flush=True)
    finally:
        fa.fwd_groups = plan
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--no-adaptive", action="store_true",
                    help="time the kernel only, without phase 8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.train import make_batch_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"[bench] {smi}; repro_torch from {fa.__file__}", flush=True)
    fwd = chip_smoke.check_flash_fwd(fa, ref)
    for c in fwd:
        chip_smoke.check(c["ok"], f"kernel disagrees with its plain version: {c}")
    out = {"src": args.src, "device": smi, "flash_fwd": fwd}
    if hasattr(fa, "fwd_groups"):
        out["f32_ms_by_groups"] = ms_by_groups(fa)
    if not args.no_adaptive:
        cfg = get_config("llama3.2-1b")
        batch_fn = make_batch_fn(cfg, chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"],
                                 seed=chip_smoke.TRAIN["seed"])
        out["adaptive"] = chip_smoke.adaptive_phase(fa, cfg, batch_fn)
    print(json.dumps({"bench_flash_fwd": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
