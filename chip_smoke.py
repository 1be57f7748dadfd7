#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: exits non-zero, printing no result, unless
   ``torch.cuda.is_available()``. TF32 is switched off for matmuls and
   cuDNN, so every f32 product on the card runs in full f32.
2. Build: compiles the six ``src/repro_torch/csrc/*.cu`` for sm_90a with
   nvcc (one process per source, started together) into ``build/kernels/``.
3. Kernels: calls each kernel's wrapper on the card at the shapes of the
   serve and train paths and holds it against its plain PyTorch version
   (``kernels/ref.py``) on the same inputs: 2e-5 in f32, 5e-2 with bf16 dot
   inputs, 1e-3 for the attention kernels' bf16 inputs without lowp (the
   forward's bf16 o against the plain version's f32 result, beside half a
   bf16 unit for its own rounding). The forward runs in its four modes:
   f32 without and with lowp (FFMA), bf16 with lowp and bf16 without it
   (tensor cores).
   Times the kernel, the plain version and one PyTorch library call for the
   same function (``scaled_dot_product_attention``, its backward through
   ``torch.autograd.grad`` for the backward kernels; used here only as a
   yardstick), and computes the least time the card could take (bytes
   over 3.35 TB/s or operations over the type's peak, the larger).
4. Serve: llama3.2-1b at full width (16 layers, d_model 2048), f32 params
   drawn by the port from a seeded generator, through
   ``ContinuousBatchingEngine(attn_impl="pallas")``: 8 slots, 16 requests,
   ragged prompts of 192-320 tokens, 32 greedy tokens each, max_seq 1024.
   The decode step runs compiled, as by default (``launch/steps.
   CompiledStep``: its first call eager, the second captures a CUDA graph,
   later calls replay it): the requests are served eager, captured,
   captured, eager (``jit=False`` for eager), the streams of all four
   token-identical and their launch counts equal; each run's tok/s, the
   capture ms and the peak memory with the graphs alive are printed. The
   kernels' launch counts are set to 0 just before the first captured run
   and read just after; both must be > 0. Prints a ``torch.profiler``
   breakdown of one captured decode step (and of an eager one), with the
   device ms of its flash_decode launches.
5. Reference: the same requests through the plain attention path
   (``attn_impl="naive"``) on the card. Streams must be token-identical; a
   divergence is tolerated (and printed) only where the plain path's top-2
   logit margin at that step is below LOGIT_TOL.

6. Train: llama3.2-1b at full width and depth, f32 params from a seeded
   generator, adam lr 3e-4, batch 4 x 512 tokens, 6 steps through
   ``TrainSession.run`` on a static rung with ``attn_impl="pallas"``,
   eager and then captured (``Rung.jitted_step``; the first step of a
   captured run is eager, the second captures). The launch counts are
   set to 0 just before each and read just after: flash_fwd, flash_bwd_dq
   and flash_bwd_dkv must each read 16 x 6. Captured and eager losses agree
   to 1e-3 relative, and a replayed step's gradients (an optimizer that
   records them, the third call; one sequence of 512) the eager step's to
   1e-4 norm-wise. The
   same steps with ``attn_impl="naive"``, captured: per-step losses agree
   to 1e-3 relative, and the first step's gradients (taken apart from both
   runs) to 1e-4 norm-wise. Prints the median step time (steps 3-6
   captured, 2-6 eager), tokens/s, the capture ms, the peak memory with the
   graph alive and a ``torch.profiler`` breakdown of one captured and one
   eager step.
7. Checkpoint and resume: full width cut to 2 layers (the state of the full
   depth is 15 GB, too slow to write and read back here); 3 steps with a
   checkpoint every 3, then a resumed session to step 6. Losses of steps
   3-5 equal an uninterrupted run's to 1e-5 relative.
8. Adaptive: full width and depth, the default rung ladder (microbatch 1,
   2, then 4 in bf16) under the interference trace ``2:6:3.0``, 10 steps,
   wall-clock latencies. At least one interference downgrade, every
   migration in place, every loss finite, and each step launches the three
   attention kernels 16 x its microbatch count times each (the bf16 rung's
   forward and backward run the tensor-core kernels without lowp), replays
   included. The rungs' steps are captured into one graph pool of the
   session; a rung's first two steps (eager, capture) are tagged warmup.
   Prints the median steady step ms of each rung, the capture ms, the peak
   memory with the graphs alive and a ``torch.profiler`` breakdown of one
   more step on the last rung, captured and eager, with its device-busy ms
   and the forward and backward kernels' device ms.
9. Paged serve: llama3.2-1b at full width cut to 8 layers (``PAGED``:
   the eager paged prefill chunks set these phases' time, and the
   comparisons with eager runs doubled them), f32, 8 slots, max_seq 1024,
   ``kv_layout="paged"`` with 16-position blocks, on the phase-4 requests
   with half of them sharing a 128-token prefix and two of them identical
   (prefix hits, skipped chunks, a read-only recompute and copy-on-write).
   Served with ``attn_impl="pallas"`` and ``"naive"``; flash_decode_paged
   launches > 0, prefill_chunks_skipped > 0, cow_copies >= 1, and both
   streams meet phase 5's rule against a contiguous pallas run of the same
   requests. The pallas run is compared with an eager run before it, as
   are phases 10 and 11's runs.
10. Swap: the same paged run with ``admission_policy="swap"`` and the pool
   cut to about half the worst-case demand of 8 residents: swap_outs > 0,
   swap_ins == swap_outs, streams under the same rule against phase 9's.
11. Speculative: ``draft_depth=4`` with the n-gram draft, contiguous and
   paged, pallas, on the phase-4 requests: flash_decode_spec and
   flash_decode_spec_paged launched > 0 on their own paths, streams under
   the same rule against phase 4's (non-speculative greedy). Prints tokens
   per verify pass, the acceptance rate and tok/s; the weights are random,
   so no rate is required.

12. CNN forward: the paper's ResNet34, MobileNetV2 and ShuffleNetV2 at
   full width (``configs/cnn_paper.py``), f32 params from a seeded
   generator, batch 128 of ``synthetic_cnn_batch``, with
   ``impl="pallas"`` (the depthwise kernel on every stride-1 depthwise
   layer) and ``"naive"``: logits within 1e-4 of the largest, top-1
   identical but where the plain top-2 margin is below LOGIT_TOL, and 0,
   13 and 13 depthwise launches per forward, on the layer shapes of
   ``DW_LAYERS``. Prints forward ms, and the device ms of one forward's
   depthwise launches (``torch.profiler``) beside the same layers run one
   call each on ``F.conv2d(groups=C)`` and on the kernel (CUDA events).
13. CNN training: each model through ``TrainSession`` on one static rung
   (``attn_impl="naive"``: the depthwise kernel has no gradient, as in the
   reference), adam lr 1e-3, 8 steps on one fixed batch of 128 (the first of
   the seeded stream), captured and then eager: losses finite and the last
   below the first; step ms, images/s, capture ms, peak memory and a
   profiled step of each. With
   ``attn_impl="pallas"`` MobileNetV2 and ShuffleNetV2 must raise at the
   first backward.
14. CNN adaptive: MobileNetV2 on ``default_rung_ladder(include_bf16=False)``
   (the reference's conv refuses the bf16 rung's mixed dtypes) under
   ``2:6:3.0``, 10 steps, wall-clock latencies, captured: at least one
   migration, all in place; capture ms and peak memory.
15. RMSNorm: ``ops.rmsnorm`` forward and forward+backward at
   ``benchmarks/kernel_bench.py``'s shapes, 4096 x 2048 and 512 x 512, as
   its ``bench_rmsnorm`` drives the reference; the launch counts of both
   kernels over the run.
16. Planner: llama3.2-1b at full width, batch 4 x 512, adam lr 3e-4, the
   default ladder (``full``, ``accum``, ``lean``; pallas) explored through
   ``ExplorationState`` by ``core.profiler.profile_rung`` on one state
   carried from rung to rung (each rung's eager step, its capture, then at
   least three replays timed with CUDA events; peak memory; the card's
   power from nvidia-smi over the replays), planned by
   ``plan_from_profiles``, then ``TrainSession`` on ``plan.rung_ladder()``
   for 8 steps under ``2:6:3.0`` counted from the session's first step.
   Prints each profile (ms, peak GB, W, J, the power's source, capture ms),
   the pruned ladder and the selected choice, beside the card's name and
   power limit. Fails unless the ladder is ``core.cost.ladder``'s, the
   selected choice the fastest, every timed step a replay, every explored
   and session step launched flash_fwd, flash_bwd_dq and flash_bwd_dkv 16 x
   its microbatch count times, every loss finite, and the session made an
   interference downgrade (a ladder of several rungs) or no migration (one).
17. Co-tenancy: ``repro_torch.launch.mixed.main`` on the card, (a) at full
   width: training (default rung ladder, adam, batch 4 x 512, pallas) beside
   a contiguous serve engine of 8 slots over 1024 positions (f32 weights,
   ``default_serve_ladder``) under the thermal trace ``0.2:0.25:3.0``, 48
   ticks, an upgrade patience of 1; each job must migrate, the serve job must reach serve-lean (a bf16
   KV cache under f32 queries: the mixed-dtype decode) and come back up,
   with one decode capture per cache dtype; (b) cut to 2 layers (a
   foreground pause checkpoints the state), paged, ``--admission-policy
   swap``, ``--fg-burst 6:9`` and ``--chaos-seed 0``: pool_pressure,
   ckpt_torn and fg_burst must apply, every pause resume at its step; (c)
   the serve ladder walked down and up twice through ServeJob's migrations
   at full width: captures stay at one per cache dtype, the second walk
   allocates nothing, the first grows reserved memory by at most the bf16
   cache's storage and one graph pool; (d) the phase-4 requests through a
   ladder of slot caps only, migrating under a burst, token-identical to an
   engine fixed at serve-full; (e) bf16-cache engines over f32 weights at 8
   layers, contiguous and paged at draft depth 0 and 4 (the four
   mixed-dtype kernels), held to the plain path's bf16-cache streams under
   phase 5's rule; (f) bf16 weights over an f32 cache (bf16 queries over an
   f32 cache), reported. Prints ticks and migrations per job, each rung's
   median step ms, tokens/s by serve rung, captures and replays, memory.

Every path's launch counts are set to 0 just before its run and read just
after. Phase 3 holds the contiguous decode at the serve run's shape (B8 K8
G4 hd64, Smax 1024) and at Smax 8192, in f32 and bf16 with lowp, each with
the splits its plan chose. It also holds the three paged and speculative kernels against
their plain versions (B8 K8 G4 hd64, 64 blocks of 16, a shuffled table with
out-of-range entries, ragged lengths including 0 and past the capacity,
speculative windows of S = 2 and 5; the paged decode and the speculative
kernels also at 512 blocks a row (Smax 8192), and the speculative kernels
at S = 17, 68 rows, each in the row blocks and splits its plan chose);
their library yardsticks are one SDPA
call with a boolean mask (speculative, contiguous) and a gather followed by
SDPA (the paged two, two calls). It holds the depthwise kernel at every
stride-1 depthwise layer shape of MobileNetV2 and ShuffleNetV2 at batch 128
(``DW_LAYERS``; the largest, (128, 32, 32, 192) 3x3, first), in f32 and
bf16, and at a 5x5 case, against one ``F.conv2d(groups=C)`` as the library
yardstick, and checks that a backward through it raises; and the RMSNorm
forward and backward kernels at
4096 x 2048 (f32, bf16), 512 x 512 and 4096 x 96 against ``F.rms_norm``
and its autograd backward. Last, the decode kernels with the cache in
another dtype than the queries (``MIXED_CASES``): f32 q over a bf16 cache in
all four, bf16 q over an f32 cache in flash_decode, at the serve shape.

Output: progress lines, then JSON lines ``{"serve": ...}``, ``{"train":
...}``, ``{"serve_paged": ...}``, ``{"serve_spec": ...}``, ``{"cnn": ...}``,
``{"rmsnorm": ...}``, ``{"planner": ...}``, ``{"cotenancy": ...}`` and
``{"kernels": [...]}`` (all ten kernels, then the five mixed-dtype decode
entries with their phase-17 launches), the card's name and power limit as
``nvidia-smi`` gives them, and as the last line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS = 67e12            # f32 on the CUDA cores
BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# the attention backward with bf16 inputs but f32 dot inputs (no lowp): its
# split products stay within 2^-16 sum |x||y| of the f32 ones (about 1e-5
# relative; csrc/flash_bwd.cu); the tolerance of tests/test_torch_cuda.py
SPLIT_TOL = dict(rtol=1e-3, atol=1e-3)
LOGIT_TOL = 1e-3  # pallas vs naive logits differ by f32 summation order only

SERVE = dict(slots=8, requests=16, prompt_lo=192, prompt_hi=320, gen=32,
             max_seq=1024, seed=0)
PAGED = dict(block_size=16, shared_prefix=128, draft_depth=4, layers=8)
TRAIN = dict(batch=4, seq=512, steps=6, lr=3e-4, seed=0)
LOSS_RTOL = 1e-3      # pallas vs naive per-step losses (f32 summation order)
GRAD_RTOL = 1e-4      # first-step gradients, norm-wise
RESUME_RTOL = 1e-5    # resumed vs uninterrupted losses


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, *, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, with L2 flushed before each call.

    A sleep kernel queued ahead of each call keeps the device busy while the
    host enqueues the flush and ``fn``'s launches, so the events bracket
    device work and not the host's launch overhead.
    """
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def max_err(got, want, tol) -> tuple[float, bool]:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    return float(diff.max()), ok


def max_err_bf16_out(got, want, tol) -> tuple[float, bool]:
    """A bf16 ``got`` against the plain version's f32 ``want``: within
    ``tol`` beside half a bf16 unit, the kernel's one rounding of its f32
    result (two f32 values within ``tol`` may round to neighbouring bf16
    values, so the plain version's own bf16 output is not the yardstick)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    eps = tol["atol"] + tol["rtol"] * want.abs()
    _, e = torch.frexp(want.abs() + eps)  # |want| + eps in [2^(e-1), 2^e)
    ok = bool((diff <= eps + torch.ldexp(torch.ones_like(want), e - 9)).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_flash_fwd(fa, ref):
    """Prefill attention: B=1, H=32, hd=64, causal, at S=512, a prime S near
    it and S=256 (inside the serve run's prompt range); then the train
    step's B=4, S=512. In its four modes: f32 without and with lowp (the
    FFMA kernel), bf16 with lowp and bf16 without it (the tensor-core
    kernel, p split into bf16 pairs: o within SPLIT_TOL of the plain
    version's f32 result beside its own rounding to bf16, lse within
    SPLIT_TOL). Each f32 check records the FFMA kernel's groups of warps a
    block, where the tree's wrapper has that plan."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for B, S, dtype, lowp in [(1, 512, torch.float32, False),
                              (1, 509, torch.float32, False),
                              (1, 256, torch.float32, False),
                              (1, 512, torch.float32, True),
                              (1, 512, torch.bfloat16, True),
                              (1, 509, torch.bfloat16, True),
                              (1, 512, torch.bfloat16, False),
                              (1, 509, torch.bfloat16, False),
                              (4, 512, torch.float32, False),   # the train step's
                              (4, 512, torch.bfloat16, True),
                              (4, 512, torch.bfloat16, False)]:  # the lean rung's
        H, hd = 32, 64
        split = dtype == torch.bfloat16 and not lowp
        q, k, v = (torch.randn(B, H, S, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True, lowp=lowp)
        if split:  # the plain version's f32 result, before its cast of o to bf16
            ro, rl = ref.ref_flash_attention_fwd(q.float(), k.float(), v.float(),
                                                 causal=True)
        else:
            ro, rl = ref.ref_flash_attention_fwd(q, k, v, causal=True, lowp=lowp)
        torch.cuda.synchronize()
        tol = BF16_TOL if lowp else SPLIT_TOL if split else F32_TOL
        err_o, ok_o = (max_err_bf16_out if split else max_err)(o, ro, tol)
        err_l, ok_l = max_err(lse, rl, tol)
        elt = q.element_size()
        nbytes = 4 * B * H * S * hd * elt + B * H * S * 4  # q,k,v read; o, lse written
        # QK^T and PV over the causal pairs; the split issues PV twice; bf16
        # inputs run on the tensor cores
        flops = (6 if split else 4) * hd * B * H * S * (S + 1) // 2
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        c = {
            "shape": [B, H, S, hd], "dtype": str(dtype).replace("torch.", ""),
            "lowp": lowp, "max_abs_err": max(err_o, err_l), "tol": tol["atol"],
            "ok": ok_o and ok_l,
            "ms": time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, causal=True,
                                                             lowp=lowp)),
            "plain_ms": time_ms(lambda: ref.ref_flash_attention_fwd(
                q, k, v, causal=True, lowp=lowp)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
            else "operations",
            "o_tol_plus_half_bf16_unit": split,
        }
        if dtype == torch.float32 and hasattr(fa, "fwd_groups"):
            c["groups"] = fa.fwd_groups(-(-S // 64) * B * H, hd,
                                        torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"[kernels] flash_fwd {c['shape']} {c['dtype']} lowp={lowp}: "
              f"max_abs_err={c['max_abs_err']:.3g} (tol {c['tol']}) "
              f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"sdpa {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']})", flush=True)
        checks.append(c)
    return checks


DECODE_LONG = [0, 1, 1544, 2400, 4088, 5600, 8192, 8193]  # Smax 8192: the serve lengths x 8


def check_flash_decode(fa, ref):
    """Decode attention: B=8, K=8, G=4, hd=64, Smax=1024, ragged lengths
    including 0 and Smax + 1, in f32 and bf16 with lowp; then Smax=8192
    (268 MB of f32 cache) at the lengths x 8. Each check records the splits
    of the tree's plan."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    B, K, G, hd = 8, 8, 4, 64
    checks = []
    for Smax, dtype, lowp in [(1024, torch.float32, False), (1024, torch.bfloat16, True),
                              (8192, torch.float32, False), (8192, torch.bfloat16, True)]:
        lens_list = [0, 1, 193, 300, 511, 700, 1024, 1025] if Smax == 1024 else DECODE_LONG
        lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        splits = (fa.decode_plan(Smax, B * K * -(-G // fa.DECODE_ROWS),
                                 torch.cuda.get_device_properties(0).multi_processor_count)[0]
                  if hasattr(fa, "decode_plan") else 1)  # the parent's kernel: no split
        q = torch.randn(B, K, G, hd, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(B, Smax, K, hd, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        out = fa.flash_decode(q, k, v, lengths, lowp=lowp)
        want = ref.ref_flash_decode(q, k, v, lengths, lowp=lowp)
        torch.cuda.synchronize()
        tol = BF16_TOL if lowp else F32_TOL
        err, ok = max_err(out, want, tol)
        ok = ok and not bool(out[0].any())  # the length-0 row returns zeros
        # the library yardstick: SDPA over (B, H, 1, hd) queries with GQA and
        # a length mask (its length-0 row is NaN; only its time is used)
        qh = q.reshape(B, K * G, 1, hd)
        kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
        mask = (torch.arange(Smax, device="cuda")[None, :]
                < lengths.clamp(max=Smax)[:, None].long())[:, None, None, :]
        elt = q.element_size()
        live = sum(min(n, Smax) for n in lens_list)
        nbytes = live * K * 2 * hd * elt + 2 * B * K * G * hd * elt + B * 4
        flops = live * K * G * 4 * hd
        peak = BF16_FLOPS if lowp else F32_FLOPS
        c = {
            "shape": [B, K, G, hd, Smax], "lengths": lens_list, "splits": splits,
            "dtype": str(dtype).replace("torch.", ""), "lowp": lowp,
            "max_abs_err": err, "tol": tol["atol"], "ok": ok,
            "ms": time_ms(lambda: fa.flash_decode(q, k, v, lengths, lowp=lowp)),
            "plain_ms": time_ms(lambda: ref.ref_flash_decode(q, k, v, lengths,
                                                             lowp=lowp)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
            else "operations",
        }
        print(f"[kernels] flash_decode {c['shape']} splits={splits} {c['dtype']} "
              f"lowp={lowp}: max_abs_err={err:.3g} (tol {c['tol']}) kernel "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, sdpa "
              f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']})", flush=True)
        checks.append(c)
    return checks


def check_flash_bwd(fb, ref):
    """The two backward kernels at the train step's shape, B=4, H=32, S=512,
    hd=64, causal, in their three modes: f32 (FFMA), bf16 with lowp and
    bf16 without it (tensor cores, p and ds split into bf16 pairs, held to
    SPLIT_TOL); in f32 at the ``accum`` rung's microbatch, B=2; then a
    ragged case, Sq=300 against Sk=373, full attention.
    Both kernels get the same o, lse and delta as their plain versions. The
    library yardstick is one ``torch.autograd.grad`` through SDPA (dq, dk
    and dv together; its forward runs before the timing)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(3)
    dq_checks, dkv_checks = [], []
    for B, Sq, Sk, causal, dtype, lowp in [(4, 512, 512, True, torch.float32, False),
                                           (2, 512, 512, True, torch.float32, False),
                                           (4, 512, 512, True, torch.bfloat16, True),
                                           (4, 512, 512, True, torch.bfloat16, False),
                                           (2, 300, 373, False, torch.float32, False)]:
        H, hd = 32, 64
        q, do = (torch.randn(B, H, Sq, hd, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, H, Sk, hd, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        o, lse = ref.ref_flash_attention_fwd(q, k, v, causal=causal, lowp=lowp)
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=causal, lowp=lowp)
        dq = fb.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        want_dq, want_dk, want_dv = ref.ref_flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        split = dtype == torch.bfloat16 and not lowp
        tol = BF16_TOL if lowp else SPLIT_TOL if split else F32_TOL
        err_q, ok_q = max_err(dq, want_dq, tol)
        err_k, ok_k = max_err(dk, want_dk, tol)
        err_v, ok_v = max_err(dv, want_dv, tol)

        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        library_ms = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                         retain_graph=True))
        del out, qs, ks, vs

        elt = q.element_size()
        # live (query, key) pairs: the causal triangle or the full rectangle
        pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        # bf16 inputs run on the tensor cores (lowp or split); an f32 call
        # with lowp is rounded to bf16 by the wrapper
        peak = BF16_FLOPS if lowp or split else F32_FLOPS
        inputs = (2 * B * H * Sq * hd + 2 * B * H * Sk * hd) * elt + 2 * B * H * Sq * 4

        def bound(nbytes, flops):
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
            return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"

        # the kernels sum in the order a plain GEMM does, so their f32 results
        # may equal the plain version's bit for bit; |ref| shows the scale
        ref_max = {"dq": float(want_dq.abs().max()),
                   "dkv": float(torch.maximum(want_dk.abs().max(), want_dv.abs().max()))}
        common = {"shape": [B, H, Sq, Sk, hd], "causal": causal,
                  "dtype": str(dtype).replace("torch.", ""), "lowp": lowp,
                  "tol": tol["atol"], "library_ms": library_ms,
                  "library_computes": "dq, dk and dv in one call"}
        # dq: q.k, do.v and ds.k; dkv: k.q, v.do, p^T do and ds^T q. Split
        # (bf16 without lowp): ds.k, p^T do and ds^T q each run twice, as hi
        # and lo halves, so 4 and 6 products at the bf16 peak
        b_q, by_q = bound(inputs + B * H * Sq * hd * 4, (4 if split else 3) * 2 * hd * pairs)
        b_kv, by_kv = bound(inputs + 2 * B * H * Sk * hd * 4,
                            (6 if split else 4) * 2 * hd * pairs)
        dq_checks.append(dict(common, max_abs_err=err_q, ok=ok_q, bound_ms=b_q,
                              ref_max_abs=ref_max["dq"],
                              bound_by=by_q,
                              ms=time_ms(lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, **kw)),
                              plain_ms=time_ms(lambda: ref.ref_flash_bwd_dq(
                                  q, k, v, do, lse, delta, **kw))))
        dkv_checks.append(dict(common, max_abs_err=max(err_k, err_v), ok=ok_k and ok_v,
                               ref_max_abs=ref_max["dkv"],
                               bound_ms=b_kv, bound_by=by_kv,
                               ms=time_ms(lambda: fb.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)),
                               plain_ms=time_ms(lambda: ref.ref_flash_bwd_dkv(
                                   q, k, v, do, lse, delta, **kw))))
        for kname, c in (("flash_bwd_dq", dq_checks[-1]), ("flash_bwd_dkv", dkv_checks[-1])):
            print(f"[kernels] {kname} {c['shape']} causal={causal} {c['dtype']} "
                  f"lowp={lowp}: max_abs_err={c['max_abs_err']:.3g} (tol {c['tol']}; "
                  f"|ref| up to {c['ref_max_abs']:.3g}) "
                  f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                  f"sdpa backward {library_ms:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})", flush=True)
    return dq_checks, dkv_checks


def paged_inputs(g, dtype, B, K, hd, bs, T):
    """Pools of B*T + 1 blocks and a shuffled (B, T) table over blocks
    1..B*T with a few entries outside [0, NB-1] (wrapper and kernel clamp
    them, as the plain version does)."""
    NB = B * T + 1
    kp, vp = (torch.randn(NB, bs, K, hd, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    table = (torch.randperm(B * T, generator=g, device="cuda") + 1).reshape(B, T)
    table[1, 3], table[5, 0], table[6, T - 1] = -7, NB + 11, 2 * NB
    return kp, vp, table.to(torch.int32)


def kernel_check(label, got, want, tol, *, ms, plain_ms, library_ms, nbytes,
                 flops, lowp, **extra):
    """One kernel-vs-plain comparison with its times and bound."""
    err, ok = max_err(got, want, tol)
    peak = BF16_FLOPS if lowp else F32_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    c = dict(extra, lowp=lowp, max_abs_err=err, tol=tol["atol"], ok=ok, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=max(by_bytes, by_ops) * 1e3,
             bound_by="bytes" if by_bytes >= by_ops else "operations")
    print(f"[kernels] {label} {c.get('dtype')} lowp={lowp}: max_abs_err={err:.3g} "
          f"(tol {c['tol']}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms ({c['library_calls']}), bound "
          f"{c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    return c


DEC = dict(B=8, K=8, G=4, hd=64, bs=16, T=64)  # the paged serve run's shapes


def check_flash_decode_paged(fa, ref, gather):
    """Paged decode at the paged serve run's shape: B=8, K=8, G=4, hd=64,
    64 blocks of 16 per row, ragged lengths including 0 and past T*bs; then
    in f32 at a long table, T=512 (lengths up to 8200), which the kernel
    cuts into many splits. Each check records the splits of the tree's
    plan (1 where the tree has none)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(4)
    B, K, G, hd, bs = (DEC[k] for k in ("B", "K", "G", "hd", "bs"))
    checks = []
    for T, dtype, lowp in [(DEC["T"], torch.float32, False), (DEC["T"], torch.bfloat16, True),
                           (512, torch.float32, False)]:
        cap = bs * T
        lens_list = ([0, 1, 193, 300, 511, 700, 1024, 1030] if T == DEC["T"]
                     else [0, 1, 193, 1030, 2900, 5000, 8192, 8200])
        lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        splits = (fa.decode_paged_plan(T, bs, B * K * -(-G // fa.DECODE_ROWS),
                                       torch.cuda.get_device_properties(0).multi_processor_count)[0]
                  if hasattr(fa, "decode_paged_plan") else 1)
        q = torch.randn(B, K, G, hd, generator=g, device="cuda").to(dtype)
        kp, vp, table = paged_inputs(g, dtype, B, K, hd, bs, T)
        out = fa.flash_decode_paged(q, kp, vp, table, lengths, lowp=lowp)
        want = ref.ref_flash_decode_paged(q, kp, vp, table, lengths, lowp=lowp)
        torch.cuda.synchronize()
        check(not bool(out[0].any()), "flash_decode_paged: length-0 row not zero")
        qh = q.reshape(B, K * G, 1, hd)
        mask = (torch.arange(cap, device="cuda")[None, :]
                < lengths.clamp(max=cap)[:, None].long())[:, None, None, :]

        def library():  # gather the table's view, then one SDPA call
            kh = gather(kp, table).transpose(1, 2)
            vh = gather(vp, table).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)

        elt = q.element_size()
        live = sum(min(n, cap) for n in lens_list)
        nbytes = live * K * 2 * hd * elt + 2 * B * K * G * hd * elt + B * T * 4 + B * 4
        checks.append(kernel_check(
            f"flash_decode_paged T={T} splits={splits}", out, want,
            BF16_TOL if lowp else F32_TOL,
            shape=[B, K, G, hd, bs, T], lengths=lens_list, splits=splits,
            dtype=str(dtype).replace("torch.", ""),
            ms=time_ms(lambda: fa.flash_decode_paged(q, kp, vp, table, lengths,
                                                     lowp=lowp)),
            plain_ms=time_ms(lambda: ref.ref_flash_decode_paged(
                q, kp, vp, table, lengths, lowp=lowp)),
            library_ms=time_ms(library), library_calls="gather + SDPA, two calls",
            nbytes=nbytes, flops=live * K * G * 4 * hd, lowp=lowp))
    return checks


SPEC_LONG_BASES = [0, 1, 193, 1030, 2900, 5000, 8189, 8192]  # T = 512 (Smax 8192)


def check_flash_decode_spec(fa, ref, gather, paged: bool):
    """Speculative verify at the serve runs' shape, S = 5 (draft depth 4,
    the serve runs' window) and S = 2, in f32 and bf16 with lowp: base
    lengths including 0, a window past the capacity and an idle slot at
    it; contiguous Smax = 1024 or 64 blocks of 16. Then in f32 at a long
    cache (T = 512, Smax = 8192, bases up to it) and at S = 17, R = 68 rows,
    past the parent's 64-row ceiling (skipped on a tree that refuses it:
    one without ``spec_plan``). Each check records the tree's row blocks and
    splits (the parent's: one split, groups of 8 rows)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(5 + paged)
    B, K, G, hd, bs = (DEC[k] for k in ("B", "K", "G", "hd", "bs"))
    base_serve = [0, 1, 193, 300, 511, 700, 1021, 1024]
    name = "flash_decode_spec_paged" if paged else "flash_decode_spec"
    kernel = getattr(fa, name)
    plain = getattr(ref, "ref_" + name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checks = []
    for S, T, dtype, lowp in [(5, DEC["T"], torch.float32, False),
                              (5, DEC["T"], torch.bfloat16, True),
                              (2, DEC["T"], torch.float32, False),
                              (2, DEC["T"], torch.bfloat16, True),
                              (5, 512, torch.float32, False),
                              (17, DEC["T"], torch.float32, False)]:
        if S * G > 64 and not hasattr(fa, "spec_plan"):
            continue
        cap = bs * T
        base_list = base_serve if T == DEC["T"] else SPEC_LONG_BASES
        base = torch.tensor(base_list, dtype=torch.int32, device="cuda")
        if hasattr(fa, "spec_plan"):
            n_rb, splits, _ = fa.spec_plan(B, K, S * G, T if paged else cap // 64,
                                           bs if paged else 64, sms)
        else:
            n_rb, splits = -(-S * G // 8), 1
        q = torch.randn(B, K, S, G, hd, generator=g, device="cuda").to(dtype)
        if paged:
            kp, vp, table = paged_inputs(g, dtype, B, K, hd, bs, T)
            args = (q, kp, vp, table, base)
        else:
            kc, vc = (torch.randn(B, cap, K, hd, generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
            args = (q, kc, vc, base)
        out = kernel(*args, lowp=lowp)
        want = plain(*args, lowp=lowp)
        torch.cuda.synchronize()
        # SDPA over (B, H, S, hd) queries, head h = k*G + g, with the
        # per-row causal window as a boolean (B, 1, S, cap) mask
        qh = q.permute(0, 1, 3, 2, 4).reshape(B, K * G, S, hd)
        limit = (base[:, None].long() + torch.arange(S, device="cuda") + 1
                 ).clamp(max=cap)
        mask = (torch.arange(cap, device="cuda")[None, None, :]
                < limit[:, :, None])[:, None]
        if paged:
            def library():
                kh = gather(kp, table).transpose(1, 2)
                vh = gather(vp, table).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
            calls = "gather + SDPA, two calls"
        else:
            kh, vh = (x.transpose(1, 2) for x in (kc, vc))

            def library():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
            calls = "SDPA with a boolean mask, one call"
        elt = q.element_size()
        live = sum(min(n + S, cap) for n in base_list)       # keys read
        pairs = int(limit.sum()) * K * G                     # (row, key) pairs
        nbytes = live * K * 2 * hd * elt + 2 * B * K * S * G * hd * elt + B * 4 \
            + (B * T * 4 if paged else 0)
        checks.append(kernel_check(
            f"{name} S={S} T={T} row_blocks={n_rb} splits={splits}", out, want,
            BF16_TOL if lowp else F32_TOL,
            shape=[B, K, S, G, hd] + ([bs, T] if paged else [cap]),
            lengths=base_list, row_blocks=n_rb, splits=splits,
            dtype=str(dtype).replace("torch.", ""),
            ms=time_ms(lambda: kernel(*args, lowp=lowp)),
            plain_ms=time_ms(lambda: plain(*args, lowp=lowp)),
            library_ms=time_ms(library), library_calls=calls,
            nbytes=nbytes, flops=pairs * 4 * hd, lowp=lowp))
    return checks


MIXED_CASES = [("flash_decode", torch.float32, torch.bfloat16),
               ("flash_decode", torch.bfloat16, torch.float32),
               ("flash_decode_paged", torch.float32, torch.bfloat16),
               ("flash_decode_spec", torch.float32, torch.bfloat16),
               ("flash_decode_spec_paged", torch.float32, torch.bfloat16)]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def check_mixed_decode(fa, ref, gather):
    """The decode kernels with q and the cache in two dtypes, at the serve
    shape (B8 K8 G4 hd64 over 1024 positions: contiguous Smax 1024, or 64
    blocks of 16; speculative S = 5), ragged lengths including 0 and past
    the capacity: f32 q over a bf16 cache (the serve-lean rung) in all four
    kernels, and bf16 q over an f32 cache in flash_decode. Held to the
    plain version at the f32 decode checks' tolerance (bf16 values are
    exact in f32); a bf16 output against the plain version's f32 result
    beside half a bf16 unit. Bytes bound with the cache at its own element
    size; the library yardstick casts the bf16 operand to f32 first, then
    SDPA (paged: then the gather), as the f32 checks' library column does."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(6)
    B, K, G, hd, bs, T = (DEC[k] for k in ("B", "K", "G", "hd", "bs", "T"))
    cap = bs * T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checks = []
    for name, qdt, kvdt in MIXED_CASES:
        spec, paged = "spec" in name, name.endswith("paged")
        S = 5 if spec else 1
        lens_list = ([0, 1, 193, 300, 511, 700, 1021, 1024] if spec
                     else [0, 1, 193, 300, 511, 700, 1024, 1025])
        lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        q = torch.randn((B, K) + ((S,) if spec else ()) + (G, hd), generator=g,
                        device="cuda").to(qdt)
        if paged:
            kp, vp, table = paged_inputs(g, kvdt, B, K, hd, bs, T)
            args = (q, kp, vp, table, lengths)
        else:
            kc, vc = (torch.randn(B, cap, K, hd, generator=g, device="cuda").to(kvdt)
                      for _ in range(2))
            args = (q, kc, vc, lengths)
        kernel, plain = getattr(fa, name), getattr(ref, "ref_" + name)
        fa.reset_launches()
        out = kernel(*args)
        check(fa.mixed_launches[f"{name}:{dtype_name(qdt)}:{dtype_name(kvdt)}"] == 1,
              f"{name} with {qdt} q and a {kvdt} cache did not launch its "
              f"mixed-dtype instantiation: {fa.mixed_launches}")
        want = plain(q.float(), *args[1:])  # the plain version's f32 result
        torch.cuda.synchronize()
        check(out.dtype == qdt, f"{name}: output {out.dtype}, not q's {qdt}")
        if qdt == torch.bfloat16:
            err, ok = max_err_bf16_out(out, want, F32_TOL)
        else:
            err, ok = max_err(out, want, F32_TOL)
        ok = ok and (spec or not bool(out[0].any()))  # a length-0 row: zeros
        # SDPA in f32 over (B, H, S, hd) queries, head h = k*G + g, with the
        # (per-row causal) length mask
        if spec:
            qh = q.permute(0, 1, 3, 2, 4).reshape(B, K * G, S, hd)
        else:
            qh = q.reshape(B, K * G, 1, hd)
        limit = (lengths[:, None].long() + (torch.arange(S, device="cuda") + 1
                                            if spec else 0)).clamp(max=cap)
        if not spec:
            limit = limit.expand(B, 1)
        mask = (torch.arange(cap, device="cuda")[None, None, :]
                < limit[:, :, None])[:, None]

        def library():
            qf = qh.float()
            if paged:
                kh = gather(kp.float(), table).transpose(1, 2)
                vh = gather(vp.float(), table).transpose(1, 2)
            else:
                kh, vh = (x.float().transpose(1, 2) for x in (kc, vc))
            return F.scaled_dot_product_attention(qf, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)

        q_elt, kv_elt = q.element_size(), torch.finfo(kvdt).bits // 8
        live = sum(min(n + S, cap) if spec else min(n, cap) for n in lens_list)
        pairs = int(limit.sum()) * K * G
        nbytes = live * K * 2 * hd * kv_elt + 2 * q.numel() * q_elt + B * 4 \
            + (B * T * 4 if paged else 0)
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, pairs * 4 * hd / F32_FLOPS
        if paged:
            calls = "upcast + gather + SDPA"
        else:
            calls = "upcast + SDPA"
        c = {"name": name, "q_dtype": dtype_name(qdt), "kv_dtype": dtype_name(kvdt),
             "shape": list(q.shape) + ([bs, T] if paged else [cap]),
             "lengths": lens_list, "dtype": f"{dtype_name(qdt)} q, {dtype_name(kvdt)} KV",
             "lowp": False, "max_abs_err": err, "tol": F32_TOL["atol"], "ok": ok,
             "ms": time_ms(lambda: kernel(*args)),
             "plain_ms": time_ms(lambda: plain(*args)),
             "library_ms": time_ms(library), "library_calls": calls,
             "bound_ms": max(by_bytes, by_ops) * 1e3,
             "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        print(f"[kernels] {name} {c['dtype']}: max_abs_err={err:.3g} (tol "
              f"{c['tol']}) kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"library {c['library_ms']:.4f} ms ({calls}), bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
        checks.append(c)
    return checks


DW_MAIN = (128, 32, 32, 192)  # MobileNetV2's largest stride-1 depthwise input, batch 128
# every stride-1 depthwise layer of the two depthwise CNNs (models/cnn.py with
# configs/cnn_paper.py), all 3x3: (H, W, C) and its launches in one forward
DW_LAYERS = {"mobilenet-v2": [((32, 32, 192), 1), ((16, 16, 144), 1), ((8, 8, 192), 2),
                              ((4, 4, 384), 4), ((4, 4, 576), 2), ((2, 2, 960), 3)],
             "shufflenet-v2": [((16, 16, 58), 3), ((8, 8, 116), 7), ((4, 4, 232), 3)]}


def depthwise_taps(H, W, kh, kw) -> int:
    """Output positions times taps that fall inside the image (SAME): the
    multiply-adds this input needs per (batch, channel)."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return sum((H - abs(a - ph)) * (W - abs(c - pw)) for a in range(kh) for c in range(kw))


def check_depthwise(dw, ref):
    """Depthwise conv at every stride-1 layer shape of MobileNetV2 and
    ShuffleNetV2 at batch 128, 3x3, in f32 and bf16, the largest,
    (128, 32, 32, 192), first; then a 5x5 case. The library yardstick is one
    ``F.conv2d(groups=C)`` on the channels-last view (cuDNN, TF32 off); the
    port never calls it. A backward through the op must raise."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(DW_MAIN, 3, torch.float32, "mobilenet-v2", 1),
             (DW_MAIN, 3, torch.bfloat16, "mobilenet-v2", 1)]
    for model, layers in DW_LAYERS.items():
        for hwc, n in layers:
            for dtype in (torch.float32, torch.bfloat16):
                if (128, *hwc) != DW_MAIN:
                    cases.append(((128, *hwc), 3, dtype, model, n))
    cases.append(((128, 32, 32, 96), 5, torch.float32, None, 0))
    checks = []
    for shape, k, dtype, model, per_forward in cases:
        B, H, W, C = shape
        x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
        w = torch.randn(k, k, C, generator=g, device="cuda").to(dtype)
        out = dw.depthwise_conv(x, w)
        want = ref.ref_depthwise_conv(x, w)
        torch.cuda.synchronize()
        xc = x.permute(0, 3, 1, 2)                 # NCHW view of NHWC memory
        wc = w.permute(2, 0, 1)[:, None].contiguous()  # (C, 1, kh, kw)
        elt = x.element_size()
        lowp = dtype == torch.bfloat16
        checks.append(kernel_check(
            f"depthwise_conv {list(shape)} {k}x{k}", out, want,
            BF16_TOL if lowp else F32_TOL, shape=list(shape), k=k,
            dtype=str(dtype).replace("torch.", ""), model=model,
            launches_per_forward=per_forward,
            ms=time_ms(lambda: dw.depthwise_conv(x, w)),
            plain_ms=time_ms(lambda: ref.ref_depthwise_conv(x, w)),
            library_ms=time_ms(lambda: F.conv2d(xc, wc, padding=k // 2, groups=C)),
            library_calls="F.conv2d(groups=C), channels-last, one call",
            nbytes=(2 * B * H * W * C + k * k * C) * elt,
            flops=2 * B * C * depthwise_taps(H, W, k, k), lowp=lowp))
    x = torch.randn(1, 8, 8, 16, device="cuda", requires_grad=True)
    y = dw.depthwise_conv(x, torch.randn(3, 3, 16, device="cuda"))
    try:
        y.sum().backward()
        raised = False
    except NotImplementedError as e:
        raised = True
        print(f"[kernels] depthwise_conv backward raises as in the reference: {e}")
    check(raised, "a backward through depthwise_conv did not raise")
    return checks


def check_rmsnorm(rn, ref):
    """RMSNorm forward and backward at kernel_bench's full shape, 4096 x 2048,
    in f32 and bf16, then 512 x 512 and a d of 96. Library yardsticks:
    ``F.rms_norm`` and one ``torch.autograd.grad`` through it (dx and dscale;
    its forward runs before the timing)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(7)
    fwd, bwd = [], []
    for rows, d, dtype in [(4096, 2048, torch.float32), (4096, 2048, torch.bfloat16),
                           (512, 512, torch.float32), (4096, 96, torch.float32)]:
        x, cot = (torch.randn(rows, d, generator=g, device="cuda").to(dtype)
                  for _ in range(2))
        s = torch.randn(d, generator=g, device="cuda").to(dtype)
        y = rn.rmsnorm_fwd(x, s)
        dx, ds = rn.rmsnorm_bwd(x, s, cot)
        want_dx, want_ds = ref.ref_rmsnorm_bwd(x, s, cot)
        want_y = ref.ref_rmsnorm(x, s)
        torch.cuda.synchronize()
        lowp = dtype == torch.bfloat16
        tol = BF16_TOL if lowp else F32_TOL
        elt = x.element_size()
        n = rows * d
        common = dict(shape=[rows, d], dtype=str(dtype).replace("torch.", ""), lowp=lowp)
        fwd.append(kernel_check(
            f"rmsnorm_fwd [{rows}, {d}]", y, want_y, tol, **common,
            ms=time_ms(lambda: rn.rmsnorm_fwd(x, s)),
            plain_ms=time_ms(lambda: ref.ref_rmsnorm(x, s)),
            library_ms=time_ms(lambda: F.rms_norm(x, (d,), weight=s, eps=1e-5)),
            library_calls="F.rms_norm, one call",
            nbytes=2 * n * elt + d * elt, flops=4 * n))
        xs, ss = x.detach().clone().requires_grad_(), s.detach().clone().requires_grad_()
        out = F.rms_norm(xs, (d,), weight=ss, eps=1e-5)
        library_ms = time_ms(lambda: torch.autograd.grad(out, (xs, ss), cot,
                                                         retain_graph=True))
        del out, xs, ss
        # dx and dscale against the plain version (dscale sums 4096 rows in
        # another order: compared relative to its largest element)
        scale_ds = float(want_ds.float().abs().max())
        got = torch.cat([dx.float().flatten(), ds.float().flatten() / scale_ds])
        want = torch.cat([want_dx.float().flatten(), want_ds.float().flatten() / scale_ds])
        bwd.append(kernel_check(
            f"rmsnorm_bwd [{rows}, {d}]", got, want, tol, **common,
            ms=time_ms(lambda: rn.rmsnorm_bwd(x, s, cot)),
            plain_ms=time_ms(lambda: ref.ref_rmsnorm_bwd(x, s, cot)),
            library_ms=library_ms,
            library_calls="autograd.grad through F.rms_norm (dx, dscale), one call",
            nbytes=3 * n * elt + 2 * d * elt, flops=10 * n))
    return fwd, bwd


# ---------------------------------------------------------------------------
# phases 4 and 5: serve llama3.2-1b at full width
# ---------------------------------------------------------------------------


def make_requests(serve, vocab):
    rng = np.random.default_rng(SERVE["seed"])
    return [serve.Request(uid=u,
                          prompt=rng.integers(0, vocab, int(rng.integers(
                              SERVE["prompt_lo"], SERVE["prompt_hi"] + 1))
                          ).astype(np.int32),
                          max_new_tokens=SERVE["gen"])
            for u in range(SERVE["requests"])]


def run_engine(serve, model, params, reqs, **engine_kw):
    engine = serve.ContinuousBatchingEngine(model, params,
                                            max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"],
                                            **engine_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run([serve.Request(uid=r.uid, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens)
                       for r in reqs])
    torch.cuda.synchronize()
    return done, engine, time.perf_counter() - t0


def profile_decode(serve, model, params, reqs, steps: int = 4, label="",
                   budget: int = 12, eager: bool = False, **engine_kw):
    """Where a batched decode step's time goes: admit one request per slot
    and run two steps (the compiled step's eager first call and its
    capture), then trace ``steps`` decode steps with torch.profiler; with
    ``eager``, put eager builds (``jit=False``) of the same steps in the
    engine's place and trace ``steps`` more. Prints the host time per step,
    the device time per step (sum of kernel times), the kernels with the
    most device time and the device time of the decode attention kernels
    (every kernel named ``flash_decode*``). Returns (host ms, device ms,
    decode-attention device ms) a step, captured, and with ``eager`` the
    eager triple after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = serve.ContinuousBatchingEngine(model, params,
                                            max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"],
                                            **engine_kw)
    for r in reqs[:SERVE["slots"]]:
        engine.submit(serve.Request(uid=r.uid, prompt=r.prompt,
                                    max_new_tokens=budget))
    engine.step()  # admits every slot and runs the first decode
    engine.step()  # the capture, where the step is compiled

    def trace(mode):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
        # kernels only: an aten op's own entry repeats its kernels' device time
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
        print(f"[profile] decode step ({model.build_kwargs['impl']}{label}, {mode}): "
              f"host {host_ms:.3f} ms/step, device busy {dev_ms:.3f} ms/step "
              f"({100 * dev_ms / host_ms:.1f}% of the step)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8 if mode == "captured" else 3]:
            print(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
                  f"{e.count // steps:5d} calls/step  {e.key[:90]}")
        attn = [e for e in events if "flash_decode" in e.key]
        attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
        print(f"[profile]   flash_decode* kernels: {attn_ms:.4f} ms/step in "
              f"{sum(e.count for e in attn) // steps} calls/step")
        return host_ms, dev_ms, attn_ms

    out = trace("captured" if engine_kw.get("jit", True) else "eager")
    if not eager:
        return out
    paged = engine.kv is not None
    engine._decode = (serve.build_paged_decode_step if paged
                      else serve.build_decode_step)(model, jit=False)
    engine._spec_decode = (serve.build_paged_spec_decode_step if paged
                           else serve.build_spec_decode_step)(model, jit=False)
    return out, trace("eager")


def compiled_vs_eager(fa, serve, model, params, reqs, label,
                      order=(False, True, True, False), **engine_kw):
    """The same requests served eager, captured, captured, eager (``order``,
    ``jit`` of each run; one engine each; the launch counts set to 0 just
    before each run and read just after, the peak memory likewise).
    Captured and eager streams must be token-identical and their launch
    counts equal. Returns (the first captured run: its finished requests,
    engine, wall s and launch counts; the JSON object of the runs: tok/s of
    each, the capture ms, the peak memory with the graphs alive)."""
    runs = {True: [], False: []}
    for jit in order:
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        done, engine, wall = run_engine(serve, model, params, reqs, jit=jit,
                                        **engine_kw)
        steps = [engine._decode, engine._spec_decode]
        runs[jit].append(dict(
            done=done, engine=engine, wall=wall, launches=fa.all_launches(),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            capture_ms=1e3 * sum(getattr(f, "capture_s", 0.0) for f in steps),
            captures=sum(getattr(f, "captures", 0) for f in steps),
            tok_s=engine.tokens_out / wall))
        check(sum(getattr(f, "replays", 0) for f in steps) > 0 if jit else
              not any(hasattr(f, "replays") for f in steps),
              f"{label}: jit={jit} but the steps replayed {[f for f in steps]}")
    want = runs[True][0]
    for r in runs[True] + runs[False]:
        check(streams_of(r["done"]) == streams_of(want["done"]),
              f"{label}: captured and eager streams differ")
        check(r["launches"] == want["launches"],
              f"{label}: launches {r['launches']} != {want['launches']}")
    out = {"tok_s_captured": [r["tok_s"] for r in runs[True]],
           "tok_s_eager": [r["tok_s"] for r in runs[False]],
           "capture_ms": [r["capture_ms"] for r in runs[True]],
           "captures": runs[True][0]["captures"],
           "peak_memory_gb_captured": max(r["peak_gb"] for r in runs[True]),
           "peak_memory_gb_eager": max(r["peak_gb"] for r in runs[False]),
           "identical_to_eager": True}
    print(f"[{label}] captured vs eager ({', '.join('captured' if j else 'eager' for j in order)}): tok/s "
          f"{[round(x, 1) for x in out['tok_s_captured']]} captured, "
          f"{[round(x, 1) for x in out['tok_s_eager']]} eager; streams "
          f"token-identical, launches equal; {out['captures']} captures in "
          f"{[round(x, 1) for x in out['capture_ms']]} ms; peak memory "
          f"{out['peak_memory_gb_captured']:.2f} GB captured, "
          f"{out['peak_memory_gb_eager']:.2f} GB eager", flush=True)
    for r in runs[True][1:] + runs[False]:
        del r["engine"]
    return (want["done"], want["engine"], want["wall"], want["launches"]), out


def profile_paged_prefill(serve, model, params, req, **engine_kw):
    """Where chunked paged prefill's time goes: one request with a budget of
    one token, so one engine step is its admission (every prompt chunk) and
    nothing else, traced with torch.profiler. Returns (chunks, host ms per
    chunk, device busy ms per chunk)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = serve.ContinuousBatchingEngine(model, params,
                                            max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"], **engine_kw)
    engine.submit(serve.Request(uid=req.uid, prompt=req.prompt, max_new_tokens=1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    n = engine.prefill_chunks
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] paged prefill of {len(req.prompt)} tokens: {n} chunks, host "
          f"{host_ms / n:.3f} ms/chunk, device busy {dev_ms / n:.3f} ms/chunk "
          f"({100 * dev_ms / host_ms:.1f}% of the admission)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/chunk "
              f"{e.count // n:5d} calls/chunk  {e.key[:90]}")
    return n, host_ms / n, dev_ms / n


@torch.inference_mode()
def top2_margin(model, params, prompt, tokens, index, cache_dtype=torch.float32):
    """The plain path's top-2 logit margin where it chose ``tokens[index]``,
    replaying the request alone (prefill, then greedy decode over a
    ``cache_dtype`` cache)."""
    logits, pcache = model.prefill(params, {"tokens": torch.as_tensor(
        prompt, device="cuda")[None]})
    cache = model.init_cache(1, SERVE["max_seq"], cache_dtype)
    for name in cache:
        cache[name][:, :, :len(prompt)] = pcache[name]
    for i in range(index):
        tok = torch.tensor([[tokens[i]]], dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, len(prompt) + i)
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def shared_prefix_requests(serve, reqs):
    """The phase-4 requests with the first half sharing one 128-token prefix
    and request 1 a copy of request 0, whose length is kept off a block
    boundary so its first decode lands in the shared tail block (COW)."""
    prefix = reqs[0].prompt[:PAGED["shared_prefix"]]
    out = []
    for r in reqs:
        p = r.prompt.copy()
        if r.uid < len(reqs) // 2:
            p[:len(prefix)] = prefix
        out.append(serve.Request(uid=r.uid, prompt=p,
                                 max_new_tokens=r.max_new_tokens))
    if len(out[0].prompt) % PAGED["block_size"] == 0:
        out[0].prompt = out[0].prompt[:-1]
    out[1].prompt = out[0].prompt.copy()
    return out


def same_streams(label, got, want, naive, params, reqs, cache_dtype=torch.float32):
    """Phase 5's rule: streams token-identical, or diverging only where the
    plain path's top-2 logit margin (over a ``cache_dtype`` cache) is below
    LOGIT_TOL. Returns the number of identical streams."""
    check(sorted(got) == sorted(want), f"{label}: requests missing")
    identical = 0
    by_uid = {r.uid: r for r in reqs}
    for u in sorted(want):
        a, b = got[u], want[u]
        if a == b:
            identical += 1
            continue
        check(len(a) == len(b), f"{label}: uid {u} has {len(a)} tokens, not {len(b)}")
        i = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(naive, params, by_uid[u].prompt, b, i, cache_dtype)
        print(f"[{label}] uid {u} diverges at token {i}: {a[i]} vs {b[i]}, "
              f"plain top-2 margin {margin:.3g} (tolerance {LOGIT_TOL})")
        check(margin < LOGIT_TOL, f"{label}: uid {u} diverges where the margin "
              f"is {margin}")
    print(f"[{label}] {identical}/{len(want)} streams token-identical", flush=True)
    return identical


def streams_of(done):
    return {u: f.tokens for u, f in done.items()}


def paged_and_spec_phases(fa, serve, build_model, cfg, reqs, contig_streams,
                          spec_phase: bool = True):
    """Phases 9-11 (9-10 without ``spec_phase``). Phase 11's streams are
    held to ``contig_streams`` (phase 4's), or, where that is None, to a
    contiguous pallas run of the same requests made here. Returns (the
    serve_paged and serve_spec JSON objects, each new path's launch
    counts)."""
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    naive = build_model(cfg, impl="naive", device="cuda")
    paged_kw = dict(kv_layout="paged", block_size=PAGED["block_size"])
    launches, compiled = {}, {}

    def run(path, m, rs, compare=False, **kw):
        """One captured run of ``rs``; with ``compare``, beside an eager one
        before it (``compiled_vs_eager``: phase 4 holds the interleaved
        four; the paged runs spend most of their time in the eager paged
        prefill)."""
        if compare:
            (done, engine, wall, counts), compiled[path] = compiled_vs_eager(
                fa, serve, m, params, rs, path,
                order=(False, True), **kw)
        else:
            fa.reset_launches()
            done, engine, wall = run_engine(serve, m, params, rs, **kw)
            counts = fa.all_launches()
        if path:
            launches[path] = counts
        st = engine.stats()
        print(f"[{path or 'ref'}] {m.build_kwargs['impl']} {kw}: "
              f"{engine.tokens_out} tokens in {wall:.3f} s "
              f"({engine.tokens_out / wall:.1f} tok/s), {engine.decode_steps} "
              f"steps, launches {counts}", flush=True)
        return streams_of(done), engine, wall, st

    # -- phase 9: paged serve with prefix sharing ----------------------------
    print(f"[serve_paged] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}",
          flush=True)
    shared = shared_prefix_requests(serve, reqs)
    ref_streams, _, _, _ = run(None, model, shared)  # contiguous pallas
    paged, eng_p, wall_p, st_p = run("serve_paged", model, shared, compare=True,
                                     **paged_kw)
    check(launches["serve_paged"]["flash_decode_paged"] > 0,
          "the paged run did not launch flash_decode_paged")
    check(st_p["prefill_chunks_skipped"] > 0, f"no prefix chunk skipped: {st_p}")
    check(st_p["cow_copies"] >= 1, f"no copy-on-write: {st_p}")
    ident_p = same_streams("serve_paged", paged, ref_streams, naive, params, shared)
    paged_n, eng_pn, wall_pn, _ = run("serve_paged_naive", naive, shared, **paged_kw)
    ident_pn = same_streams("serve_paged_naive", paged_n, ref_streams, naive,
                            params, shared)
    prof_p, prof_pe = profile_decode(serve, model, params, reqs, label=", paged",
                                     eager=True, **paged_kw)
    prof_pre = profile_paged_prefill(serve, model, params, reqs[0], **paged_kw)

    # -- phase 10: swap over a pool cut to half the worst case ----------------
    bs = PAGED["block_size"]
    worst = sorted(-(-min(len(r.prompt) + r.max_new_tokens, SERVE["max_seq"]) // bs)
                   for r in shared)
    demand = sum(worst[-SERVE["slots"]:])
    num_blocks = demand // 2 + 1
    swapped, eng_s, wall_s, st_s = run(
        "swap", model, shared, compare=True, admission_policy="swap",
        num_blocks=num_blocks, **paged_kw)
    check(st_s["swap_outs"] > 0 and st_s["swap_ins"] == st_s["swap_outs"]
          and st_s["swapped"] == 0, f"swap counts: {st_s}")
    check(launches["swap"]["flash_decode_paged"] > 0, "swap run: no paged kernel")
    ident_s = same_streams("swap", swapped, paged, naive, params, shared)

    # -- phase 11: speculative, contiguous and paged --------------------------
    spec = {}
    if spec_phase and contig_streams is None:
        contig_streams = run(None, model, reqs)[0]
    for path, kw, kname in (("spec_contig", {}, "flash_decode_spec"),
                            ("spec_paged", paged_kw, "flash_decode_spec_paged")
                            )[:2 if spec_phase else 0]:
        streams, eng, wall, st = run(path, model, reqs, compare=True,
                                     draft_depth=PAGED["draft_depth"], **kw)
        check(launches[path][kname] > 0, f"{path} did not launch {kname}")
        ident = same_streams(path, streams, contig_streams, naive, params, reqs)
        # tokens each sequence gains per verify pass (the first token of a
        # request comes from its prefill)
        per_pass = (eng.tokens_out - len(reqs)) / max(1, st["spec_rounds"])
        print(f"[{path}] {per_pass:.3f} tokens per sequence per verify pass, "
              f"{eng.decode_steps} verify passes, acceptance "
              f"{st['spec_accepted']}/{st['spec_drafted']} = "
              f"{st['spec_acceptance']:.4f}, {eng.tokens_out / wall:.1f} tok/s",
              flush=True)
        spec[path] = {"tok_s": eng.tokens_out / wall, "wall_s": wall,
                      "tokens": eng.tokens_out, "verify_passes": eng.decode_steps,
                      "spec_rounds": st["spec_rounds"],
                      "tokens_per_verify_pass": per_pass,
                      "spec_accepted": st["spec_accepted"],
                      "spec_drafted": st["spec_drafted"],
                      "acceptance": st["spec_acceptance"],
                      "identical_streams": ident, "launches": launches[path],
                      "compiled": compiled[path]}
    if spec_phase:
        prof_spec, prof_spec_e = profile_decode(
            serve, model, params, reqs, label=", spec paged", budget=60, eager=True,
            draft_depth=PAGED["draft_depth"], **paged_kw)
        spec["decode_step_profile_paged"] = {"host_ms": prof_spec[0],
                                             "device_ms": prof_spec[1],
                                             "eager_host_ms": prof_spec_e[0],
                                             "eager_device_ms": prof_spec_e[1]}
        spec["draft_depth"] = PAGED["draft_depth"]

    paged_out = {
        "n_layers": cfg.n_layers,
        "block_size": bs, "num_blocks": st_p["pool"]["num_blocks"],
        "tok_s": eng_p.tokens_out / wall_p, "wall_s": wall_p,
        "naive_tok_s": eng_pn.tokens_out / wall_pn,
        "tokens": eng_p.tokens_out, "decode_steps": eng_p.decode_steps,
        "identical_streams": ident_p, "naive_identical_streams": ident_pn,
        "prefill_chunks": st_p["prefill_chunks"],
        "prefill_chunks_skipped": st_p["prefill_chunks_skipped"],
        "cow_copies": st_p["cow_copies"], "peak_blocks": st_p["pool"]["peak_blocks_in_use"],
        "prefix_hit_rate": st_p["pool"]["prefix"]["hit_rate"],
        "decode_step_host_ms": prof_p[0], "decode_step_device_ms": prof_p[1],
        "eager_decode_step_host_ms": prof_pe[0],
        "eager_decode_step_device_ms": prof_pe[1],
        "compiled": {p: compiled[p] for p in ("serve_paged", "swap")},
        "prefill_profile": {"chunks": prof_pre[0], "host_ms_per_chunk": prof_pre[1],
                            "device_ms_per_chunk": prof_pre[2]},
        "swap": {"num_blocks": num_blocks, "worst_case_demand": demand,
                 "tok_s": eng_s.tokens_out / wall_s, "swap_outs": st_s["swap_outs"],
                 "swap_ins": st_s["swap_ins"], "identical_streams": ident_s,
                 "decode_steps": eng_s.decode_steps},
        "launches": {p: launches[p] for p in ("serve_paged", "serve_paged_naive", "swap")},
    }
    del model, naive, params
    free_cuda()
    return paged_out, spec, launches


def serve_phases(fa, serve, build_model, cfg, reqs):
    """Phases 4 and 5: ``reqs`` served at full width through the kernels
    (with a profiled decode step, its flash_decode device ms among it),
    then through the plain path, streams held to phase 5's rule. Returns
    (the JSON object, phase 4's launch counts, phase 4's streams)."""
    # -- phase 4: serve with the kernels ---------------------------------------
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    naive = build_model(cfg, impl="naive", device="cuda")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, f32; "
          f"prompts {[len(r.prompt) for r in reqs]}", flush=True)

    with torch.inference_mode():  # small-input agreement of the two paths
        toks = torch.as_tensor(reqs[0].prompt[:64], device="cuda")[None]
        lk, ck = model.prefill(params, {"tokens": toks})
        ln, cn = naive.prefill(params, {"tokens": toks})
    check(lk.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(lk).all()),
          f"prefill logits not finite of shape (1, 1, V): {tuple(lk.shape)}")
    diff = float((lk - ln).abs().max())
    check(diff < LOGIT_TOL, f"pallas vs naive prefill logits differ by {diff}")
    check(ck["k"].shape == (cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim),
          f"prefill cache shape {tuple(ck['k'].shape)}")
    print(f"[serve] prefill of 64 tokens: pallas vs naive max |dlogit| {diff:.3g}")

    run_engine(serve, model, params, reqs[:1])  # warm-up: cuBLAS handles, allocator
    (done, engine, wall, launches), compiled = compiled_vs_eager(
        fa, serve, model, params, reqs, "serve")
    serve_launches = dict(launches)
    tok_s = engine.tokens_out / wall
    print(f"[serve] pallas, captured: {engine.tokens_out} tokens in {wall:.3f} s "
          f"({tok_s:.1f} tok/s), {engine.decode_steps} decode steps, occupancy "
          f"{engine.occupancy:.3f}, launches {launches}", flush=True)
    check(launches["flash_fwd"] > 0 and launches["flash_decode"] > 0,
          f"the serve run did not go through both kernels: {launches}")
    check(sorted(done) == list(range(SERVE["requests"])), "requests missing")
    for u, f in done.items():
        check(len(f.tokens) == SERVE["gen"] and f.reason == "length"
              and all(0 <= t < cfg.vocab_size for t in f.tokens),
              f"request {u}: {len(f.tokens)} tokens, reason {f.reason}")

    prof_pallas, prof_eager = profile_decode(serve, model, params, reqs, eager=True)
    prof = {"pallas": prof_pallas, "naive": profile_decode(serve, naive, params, reqs)}

    # -- phase 5: the same requests through the plain path ---------------------
    done_n, engine_n, wall_n = run_engine(serve, naive, params, reqs)
    print(f"[serve] naive: {engine_n.tokens_out} tokens in {wall_n:.3f} s "
          f"({engine_n.tokens_out / wall_n:.1f} tok/s)", flush=True)
    identical = same_streams("serve", streams_of(done), streams_of(done_n),
                             naive, params, reqs)

    serve_out = {
        "tok_s": tok_s, "wall_s": wall, "tokens": engine.tokens_out,
        "decode_steps": engine.decode_steps, "occupancy": engine.occupancy,
        "naive_tok_s": engine_n.tokens_out / wall_n,
        "identical_streams": identical,
        "decode_step_host_ms": {k: v[0] for k, v in prof.items()},
        "decode_step_device_ms": {k: v[1] for k, v in prof.items()},
        "decode_step_flash_decode_ms": prof["pallas"][2],
        "compiled": dict(compiled, eager_decode_step_host_ms=prof_eager[0],
                         eager_decode_step_device_ms=prof_eager[1])}
    contig_streams = streams_of(done)
    del model, naive, params, engine, engine_n, done, done_n, lk, ln, ck, cn
    free_cuda()
    return serve_out, serve_launches, contig_streams


# ---------------------------------------------------------------------------
# phases 6-8: train llama3.2-1b
# ---------------------------------------------------------------------------


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def grad_agreement(build_model, cfg, batch, tree_leaves, device="cuda"):
    """Loss and gradients of one step's batch from the seeded initial params
    through the kernels and through the plain path: (losses, norm-wise
    relative error of the gradients)."""
    grads, losses = {}, {}
    for impl in ("pallas", "naive"):
        model = build_model(cfg, impl=impl, device=device)
        params = model.init(model.generator(TRAIN["seed"]))
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss(params, batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        losses[impl] = float(loss.detach())
        del params, leaves, loss
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(grads["pallas"], grads["naive"]))
    den = sum(float(b.double().square().sum()) for b in grads["naive"])
    del grads
    free_cuda()
    return losses, (num / den) ** 0.5


def recording_optimizer():
    """An optimizer that copies each step's gradients into its state and
    updates nothing, so that a captured train step's gradients can be read."""
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.tree import tree_map

    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        tree_map(lambda s, g: s.copy_(g), state, grads)
        return tree_map(lambda g: g.new_zeros(()), grads), state  # broadcast 0

    return Optimizer("record_grads", init, update, 4)


def captured_grad_agreement(build_model, cfg, batch, tree_leaves, device="cuda"):
    """Norm-wise relative error of the step-0 gradients of a replayed train
    step (the third call: eager, capture, replay) against an eager step's,
    both from the seeded initial parameters, through the kernels (phase 6
    passes the first sequence of its first batch)."""
    from repro_torch.engine.rungs import Rung
    from repro_torch.launch.steps import init_train_state
    grads = {}
    for jit in (True, False):
        rung = Rung(name="static", attn_impl="pallas")
        model = rung.build_model(cfg, device)
        opt = recording_optimizer()
        state = init_train_state(model, opt, model.generator(TRAIN["seed"]))
        step = rung.jitted_step(cfg, opt, device=device, jit=jit)
        for _ in range(3 if jit else 1):
            state, _ = step(state, batch)
        if jit:
            check(step.last_call == "replay", "the gradient step did not replay")
        grads[jit] = tree_leaves(state["opt"])
        del state, step, rung, model
        free_cuda()
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(grads[True], grads[False]))
    den = sum(float(b.double().square().sum()) for b in grads[False])
    del grads
    free_cuda()
    return (num / den) ** 0.5


def run_session(TrainSession, rungs, cfg, batch_fn, steps, *, start=0,
                state=None, device="cuda", **kw):
    sess = TrainSession(cfg, rungs, optimizer=kw.pop("optimizer"),
                        lr=kw.pop("lr", TRAIN["lr"]), batch_fn=batch_fn, verbose=True,
                        device=device, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.run(steps, start=start, state=state, rng_seed=TRAIN["seed"])
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def step_ms(res) -> list:
    return [s.latency_s * 1e3 for s in res.timeline.steps]


def profile_train_step(step_fn, state, batch):
    """Where one train step's time goes: ``torch.profiler`` over one step
    (after the run warmed everything up; a compiled step first runs until
    its next call replays). Returns (host ms, device busy ms,
    [(ms, calls, kernel name)] of the kernels with the most device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    compiles = getattr(step_fn, "compiles", None)
    while compiles and compiles(state, batch):  # at most an eager call and a capture
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        host_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.self_device_time_total / 1e3, e.count, e.key)
           for e in sorted(events, key=lambda e: -e.self_device_time_total)]
    return host_ms, dev_ms, top


def train_phases(fa, build_model, cfg, device="cuda"):
    """Phases 6-8; returns (the train JSON object, the train run's launch
    counts). ``device`` is for rehearsing the control flow on the CPU."""
    # -- phase 6: train with the kernels, then the plain path ------------------
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.engine.rungs import Rung
    from repro_torch.engine.session import TrainSession
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import adam
    from repro_torch.tree import tree_leaves

    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    batch_fn = make_batch_fn(cfg, B, S, seed=TRAIN["seed"])
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f}B params f32, adam lr {TRAIN['lr']}, "
          f"batch {B} x {S} tokens, {steps} steps", flush=True)
    first = {k: torch.as_tensor(v, device=device) for k, v in batch_fn(0).items()}
    first_losses, grad_rel = grad_agreement(build_model, cfg, first, tree_leaves,
                                            device)
    print(f"[train] step-0 gradients, pallas vs naive: norm-wise relative error "
          f"{grad_rel:.3g} (limit {GRAD_RTOL}); losses {first_losses}", flush=True)
    check(grad_rel <= GRAD_RTOL, f"first-step gradients differ by {grad_rel}")

    # pallas eager, then captured (a step's time spreads by well under 1%
    # between runs), then the plain path, captured
    runs, order = {}, [("pallas", False), ("pallas", True), ("naive", True)]
    for impl, jit in order:
        key = impl if jit else f"{impl}_eager"
        rung = Rung(name="static", attn_impl=impl)
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res, wall_t = run_session(TrainSession, [rung], cfg, batch_fn, steps,
                                  optimizer=adam(), adaptive=False, device=device,
                                  jit=jit)
        counts = fa.all_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = step_ms(res)
        med = statistics.median(ms[2:] if jit else ms[1:])
        step_fn = rung.jitted_step(cfg, adam(), lr=TRAIN["lr"], device=device, jit=jit)
        run = dict(losses=res.losses, step_ms=ms, median_step_ms=med,
                   tokens_per_s=B * S / (med / 1e3), wall_s=wall_t,
                   peak_memory_gb=peak_gb, launches=counts)
        if jit:
            run.update(capture_ms=1e3 * step_fn.capture_s, captures=step_fn.captures,
                       replays=step_fn.replays)
            check(step_fn.captures == 1 and step_fn.replays == steps - 1,
                  f"{impl}: {step_fn.captures} captures and {step_fn.replays} "
                  f"replays in {steps} steps")
        print(f"[train] {impl} {'captured' if jit else 'eager'}: losses "
              f"{[round(x, 5) for x in res.losses]}; step ms "
              f"{[round(x, 1) for x in ms]}; median (steps {3 if jit else 2}-{steps}) "
              f"{med:.1f} ms = {B * S / (med / 1e3):.0f} tokens/s; peak memory "
              f"{peak_gb:.2f} GB{' with the graph alive' if jit else ''}; capture "
              f"{run.get('capture_ms', 0):.1f} ms; launches {counts}", flush=True)
        check(all(map(lambda x: x == x and abs(x) < 1e9, res.losses)),
              f"{impl} losses not finite: {res.losses}")
        if impl == "pallas":
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                check(counts[kname] == cfg.n_layers * steps,
                      f"{kname} launched {counts[kname]} times in the train run, "
                      f"not {cfg.n_layers} x {steps}")
        runs[key] = run
        if key == "pallas":
            train_launches = counts
            prof = {}
            for mode, fn in (("captured", step_fn),
                             ("eager", rung.train_step_fn(rung.build_model(cfg, device),
                                                          adam(), lr=TRAIN["lr"]))):
                host_ms, dev_ms, top = profile_train_step(fn, res.state, batch_fn(steps))
                attn_ms = sum(t for t, _, k in top if "flash_" in k)
                print(f"[profile] train step (pallas, {mode}): host {host_ms:.1f} ms, "
                      f"device busy {dev_ms:.1f} ms ({100 * dev_ms / host_ms:.1f}% of "
                      f"the step); the three attention kernels {attn_ms:.2f} ms",
                      flush=True)
                for t, n, k in top[:12 if mode == "captured" else 4]:
                    print(f"[profile]   {t:8.3f} ms {n:5d} calls  {k[:90]}")
                prof[mode] = {"host_ms": host_ms, "device_ms": dev_ms,
                              "attention_kernels_ms": attn_ms,
                              "top": [[t, n, k[:120]] for t, n, k in top[:12]]}
            check(step_fn.last_call == "replay", "the profiled train step did not replay")
            run["profile"] = prof["captured"]
            run["profile_eager"] = prof["eager"]
        del res, rung, step_fn
        free_cuda()
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["pallas"]["losses"],
                                               runs["naive"]["losses"])]
    print(f"[train] pallas vs naive per-step loss relative difference: max "
          f"{max(rel):.3g} (limit {LOSS_RTOL})", flush=True)
    check(max(rel) <= LOSS_RTOL, f"pallas and naive losses differ: {rel}")
    rel_c = [abs(a - b) / abs(b) for a, b in zip(runs["pallas"]["losses"],
                                                 runs["pallas_eager"]["losses"])]
    grad_rel_c = captured_grad_agreement(
        build_model, cfg, {k: v[:1] for k, v in batch_fn(0).items()}, tree_leaves,
        device)
    print(f"[train] captured vs eager: per-step loss relative difference max "
          f"{max(rel_c):.3g} (limit {LOSS_RTOL}); a replayed step's gradients "
          f"against the eager step's: norm-wise {grad_rel_c:.3g} (limit {GRAD_RTOL})",
          flush=True)
    check(max(rel_c) <= LOSS_RTOL, f"captured and eager losses differ: {rel_c}")
    check(grad_rel_c <= GRAD_RTOL, f"captured gradients differ by {grad_rel_c}")

    # -- phase 7: checkpoint and resume -----------------------------------------
    cut = dataclasses.replace(cfg, n_layers=2)
    ckdir = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    rung = Rung(name="static", attn_impl="pallas")
    whole, _ = run_session(TrainSession, [rung], cut, batch_fn, steps,
                           optimizer=adam(), adaptive=False, device=device)
    mgr = CheckpointManager(str(ckdir), level=0)
    t0 = time.perf_counter()
    part, _ = run_session(TrainSession, [rung], cut, batch_fn, 3,
                          optimizer=adam(), adaptive=False, ckpt=mgr, ckpt_every=3,
                          device=device)
    first_half_s = time.perf_counter() - t0
    del part
    free_cuda()
    t0 = time.perf_counter()
    start, state = mgr.restore_latest()
    restore_s = time.perf_counter() - t0
    ckpt_gb = sum(f.stat().st_size for f in ckdir.iterdir()) / 1e9
    rest, _ = run_session(TrainSession, [rung], cut, batch_fn, steps, start=start,
                          state=state, optimizer=adam(), adaptive=False, device=device)
    resumed = rest.losses
    ref_tail = whole.losses[start:]
    rel_resume = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref_tail))
    print(f"[ckpt] {cut.n_layers}-layer full-width cut: resumed at step {start} "
          f"from {ckpt_gb:.2f} GB on disk (restore {restore_s:.1f} s; 3 steps and "
          f"the saves {first_half_s:.1f} s); losses {[round(x, 6) for x in resumed]} "
          f"vs uninterrupted {[round(x, 6) for x in ref_tail]}: max relative "
          f"difference {rel_resume:.3g} (limit {RESUME_RTOL})", flush=True)
    check(start == 3 and len(resumed) == steps - 3, f"resumed at {start}: {resumed}")
    check(rel_resume <= RESUME_RTOL, f"resumed losses differ by {rel_resume}")
    del whole, rest, state
    shutil.rmtree(ckdir, ignore_errors=True)
    free_cuda()

    # -- phase 8: adaptive ladder under interference ------------------------------
    adaptive_out = adaptive_phase(fa, cfg, batch_fn, device)
    return {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "params": cfg.param_count(), "dtype": "float32", **TRAIN},
        "pallas": runs["pallas"], "naive": runs["naive"],
        "pallas_eager": runs["pallas_eager"],
        "captured_vs_eager": {"loss_rel_diff_max": max(rel_c),
                              "replayed_grad_rel_err": grad_rel_c},
        "first_step_grad_rel_err": grad_rel, "loss_rel_diff_max": max(rel),
        "resume": {"n_layers": cut.n_layers, "start": start, "losses": resumed,
                   "uninterrupted": ref_tail, "rel_diff_max": rel_resume,
                   "ckpt_gb": ckpt_gb, "restore_s": restore_s},
        "adaptive": adaptive_out}, train_launches


def adaptive_phase(fa, cfg, batch_fn, device="cuda"):
    """Phase 8: the default rung ladder (microbatch 1, 2, then 4 in bf16)
    under the interference trace 2:6:3.0, 10 steps, with the checks of the
    module docstring; returns its JSON object, with the median step ms of
    each rung and a profile of one more step on the last rung."""
    from repro_torch.engine.events import InterferenceTrace
    from repro_torch.engine.rungs import default_rung_ladder
    from repro_torch.engine.session import TrainSession
    from repro_torch.optim.optimizers import adam

    ladder = default_rung_ladder(batch=TRAIN["batch"], microbatch=1, attn_impl="pallas")
    snaps = []

    def counted_batches(step):  # launches so far, at the start of every step
        snaps.append(fa.all_launches())
        return batch_fn(step)

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    adaptive_steps = 10
    res, _ = run_session(TrainSession, ladder, cfg, counted_batches, adaptive_steps,
                         optimizer=adam(), adaptive=True, device=device,
                         trace=InterferenceTrace.parse("2:6:3.0"))
    snaps.append(fa.all_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: snaps[-1][k] - snaps[0][k] for k in snaps[-1]}
    migrations = [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
                  for m in res.timeline.migrations]
    rungs_by_step = [s.rung for s in res.timeline.steps]
    micro = {r.name: r.microbatch for r in ladder}
    print(f"[adaptive] migrations {migrations}; rung per step {rungs_by_step}; "
          f"losses {[round(x, 4) for x in res.losses]}", flush=True)
    check(any(m[3] == "interference" for m in migrations),
          f"no interference downgrade: {migrations}")
    check(all(m[4] == "in-place" for m in migrations), f"{migrations}")
    check(all(x == x and abs(x) < 1e9 for x in res.losses), f"{res.losses}")
    for i, rname in enumerate(rungs_by_step):
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n = snaps[i + 1][kname] - snaps[i][kname]
            check(n == cfg.n_layers * micro[rname],
                  f"step {i} on {rname}: {kname} launched {n} times")
    ms = step_ms(res)
    # steady steps only: a rung's first step runs eagerly and its second
    # captures (both tagged warmup, as the controller skips them)
    steady = [not s.warmup for s in res.timeline.steps]
    by_rung = {r.name: statistics.median(
        [t for t, n, ok in zip(ms, rungs_by_step, steady) if n == r.name and ok]
        or [t for t, n in zip(ms, rungs_by_step) if n == r.name])
        for r in ladder if r.name in rungs_by_step}
    steps_fn = {r.name: r.jitted_step(cfg, adam(), lr=TRAIN["lr"], device=device)
                for r in ladder if r.name in rungs_by_step}
    capture_ms = {k: 1e3 * f.capture_s for k, f in steps_fn.items()}
    print(f"[adaptive] median steady step ms by rung: "
          f"{ {k: round(v, 2) for k, v in by_rung.items()} }; step ms "
          f"{[round(x, 1) for x in ms]} (warmup {[not x for x in steady]}); capture ms "
          f"{ {k: round(v, 1) for k, v in capture_ms.items()} }; captures "
          f"{ {k: f.captures for k, f in steps_fn.items()} }; peak memory "
          f"{peak_gb:.2f} GB with the graphs alive", flush=True)
    adaptive_out = {"migrations": migrations, "rungs": rungs_by_step,
                    "losses": res.losses, "step_ms": ms, "steady": steady,
                    "median_step_ms_by_rung": by_rung, "capture_ms": capture_ms,
                    "captures": {k: f.captures for k, f in steps_fn.items()},
                    "peak_memory_gb": peak_gb,
                    "reached_bf16": "lean" in rungs_by_step, "launches": launches}
    last = next(r for r in ladder if r.name == rungs_by_step[-1])
    adaptive_out["profile"] = {"rung": last.name}
    for mode, fn in (("captured", steps_fn[last.name]),
                     ("eager", last.train_step_fn(last.build_model(cfg, device), adam(),
                                                  lr=TRAIN["lr"]))):
        host_ms, dev_ms, top = profile_train_step(fn, res.state, batch_fn(adaptive_steps))
        bwd_ms = sum(t for t, _, k in top if "flash_bwd" in k)
        fwd_ms = sum(t for t, _, k in top if "flash_fwd" in k)
        print(f"[profile] one step on {last.name} ({mode}): host {host_ms:.1f} ms, "
              f"device busy {dev_ms:.1f} ms; the forward kernel {fwd_ms:.2f} ms in "
              f"{sum(n for _, n, k in top if 'flash_fwd' in k)} launches; the backward "
              f"kernels {bwd_ms:.2f} ms in "
              f"{sum(n for _, n, k in top if 'flash_bwd' in k)} launches", flush=True)
        for t, n, k in top[:8 if mode == "captured" else 4]:
            print(f"[profile]   {t:8.3f} ms {n:5d} calls  {k[:90]}")
        adaptive_out["profile"][mode] = {
            "host_ms": host_ms, "device_ms": dev_ms, "forward_kernel_ms": fwd_ms,
            "backward_kernels_ms": bwd_ms, "top": [[t, n, k[:120]] for t, n, k in top[:8]]}
    check(steps_fn[last.name].last_call == "replay",
          f"the profiled step on {last.name} did not replay")
    del res
    free_cuda()
    return adaptive_out


# ---------------------------------------------------------------------------
# phases 12-14: the paper's CNNs; phase 15: the RMSNorm path
# ---------------------------------------------------------------------------


CNN = dict(batch=128, steps=8, lr=1e-3, seed=0, adaptive_steps=10, trace="2:6:3.0")
CNN_ARCHS = {"resnet34": 0, "mobilenet-v2": 13, "shufflenet-v2": 13}  # depthwise launches per forward
CNN_LOGIT_RTOL = 1e-4  # pallas vs naive logits, relative to the largest


def cuda_ms(fn, iters: int = 5) -> float:
    """Host wall time per call of ``fn`` over ``iters`` calls, each ended by
    a device synchronise (a whole forward: launches and device work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_kernels(fn):
    """[(device ms, launches, kernel name)] of the kernels ``fn`` runs, from
    ``torch.profiler`` over one call (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def depthwise_in_forward(dw, forward):
    """The depthwise kernel's share of one forward: the device ms of its
    launches inside the forward (``torch.profiler``), beside the same layers,
    recorded from that forward, run one call each on ``F.conv2d(groups=C)``
    (cuDNN; the library yardstick, never on the port's path) and on the
    kernel alone, each set timed with CUDA events (``time_ms``, L2 flushed
    before the set)."""
    import torch.nn.functional as F
    layers, plain = [], dw._forward

    def record(x, w):
        layers.append((tuple(x.shape), tuple(w.shape)))
        return plain(x, w)

    dw._forward = record
    try:
        forward()
    finally:
        dw._forward = plain
    in_fwd = device_kernels(forward)
    dw_ms = sum(ms for ms, n, name in in_fwd if "dw_conv" in name)
    dw_n = sum(n for ms, n, name in in_fwd if "dw_conv" in name)
    g = torch.Generator(device="cuda").manual_seed(9)
    ins = [(torch.randn(xs, generator=g, device="cuda"), torch.randn(ws, generator=g,
                                                                      device="cuda"))
           for xs, ws in layers]
    convs = [(x.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None].contiguous(),
              (w.shape[0] // 2, w.shape[1] // 2)) for x, w in ins]

    def library():
        for x, w, pad in convs:
            F.conv2d(x, w, padding=pad, groups=x.shape[1])

    def kernel():
        for x, w in ins:
            dw.depthwise_conv(x, w)

    out = {"layers": [list(xs) for xs, _ in layers],
           "launches_profiled": dw_n, "kernel_device_ms": dw_ms,
           "forward_device_ms": sum(ms for ms, _, _ in in_fwd),
           "conv2d_ms": time_ms(library), "kernel_alone_ms": time_ms(kernel)}
    check(dw_ms > 0 and out["conv2d_ms"] > 0 and out["kernel_alone_ms"] > 0,
          f"depthwise timings of the forward not measured: {out}")
    return out


def cnn_forward_phase(dw, build_model, get_config, device="cuda"):
    """Phase 12: each CNN forward at full width, batch 128, through the
    depthwise kernel and through the plain path. Returns (the JSON object
    per arch, each forward's depthwise launch counts)."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.tree import tree_leaves

    B = CNN["batch"]
    out, launches = {}, {}
    for arch, want_launches in CNN_ARCHS.items():
        cfg = get_config(arch)
        batch_fn = make_batch_fn(cfg, B, 0, seed=CNN["seed"])
        images = torch.as_tensor(batch_fn(0)["images"], device=device)
        model = build_model(cfg, impl="pallas", device=device)
        naive = build_model(cfg, impl="naive", device=device)
        params = model.init(model.generator(CNN["seed"]))
        with torch.no_grad():
            dw.launches["depthwise_conv"] = 0
            logits = model.forward(params, {"images": images})
            n = dw.launches["depthwise_conv"]
            want = naive.forward(params, {"images": images})
            torch.cuda.synchronize()
            check(logits.shape == (B, cfg.n_classes) and bool(torch.isfinite(logits).all()),
                  f"{arch}: logits not finite of shape (B, n_classes)")
            rel = float((logits - want).abs().max() / want.abs().max())
            top2 = want.float().topk(2, dim=-1)
            margin = top2.values[:, 0] - top2.values[:, 1]
            differ = logits.argmax(-1) != top2.indices[:, 0]
            check(rel <= CNN_LOGIT_RTOL, f"{arch}: pallas vs naive logits differ by {rel}")
            check(bool((margin[differ] < LOGIT_TOL).all()),
                  f"{arch}: top-1 differs where the plain margin is >= {LOGIT_TOL}")
            check(n == want_launches, f"{arch}: {n} depthwise launches per forward, "
                  f"not {want_launches}")
            fwd_ms = {impl: cuda_ms(lambda m=m: m.forward(params, {"images": images}))
                      for impl, m in (("pallas", model), ("naive", naive))}
            dwf = None
            if want_launches:
                dwf = depthwise_in_forward(
                    dw, lambda: model.forward(params, {"images": images}))
                want_layers = [[B, *hwc] for hwc, k in DW_LAYERS[arch] for _ in range(k)]
                check(sorted(dwf["layers"]) == sorted(want_layers)
                      and dwf["launches_profiled"] == want_launches,
                      f"{arch}: the forward's depthwise layers {dwf['layers']} "
                      f"({dwf['launches_profiled']} profiled launches) are not DW_LAYERS'")
        launches[f"cnn_forward_{arch}"] = n
        n_params = sum(p.numel() for p in tree_leaves(params))
        print(f"[cnn] {arch}: {n_params / 1e6:.3f}M params, batch {B} x "
              f"{cfg.image_size}x{cfg.image_size}x{cfg.in_channels}: pallas vs naive "
              f"logits max |d| / max |logit| = {rel:.3g} (limit {CNN_LOGIT_RTOL}), "
              f"{int(differ.sum())} top-1 differences; {n} depthwise launches per "
              f"forward; forward {fwd_ms['pallas']:.2f} ms pallas, "
              f"{fwd_ms['naive']:.2f} ms naive", flush=True)
        if dwf:
            print(f"[cnn] {arch}: the forward's {dwf['launches_profiled']} depthwise "
                  f"launches {dwf['kernel_device_ms']:.4f} ms of {dwf['forward_device_ms']:.3f} "
                  f"ms device time; the same layers, one call each, on "
                  f"F.conv2d(groups=C) {dwf['conv2d_ms']:.4f} ms, on the kernel "
                  f"{dwf['kernel_alone_ms']:.4f} ms", flush=True)
        out[arch] = {"params": n_params, "logit_rel_diff": rel,
                     "top1_differences": int(differ.sum()),
                     "depthwise_launches_per_forward": n,
                     "forward_ms": fwd_ms, "depthwise_in_forward": dwf}
        del model, naive, params, logits, want
        free_cuda()
    return out, launches


def cnn_phases(dw, build_model, get_config, device="cuda"):
    """Phases 12-14. Returns (the cnn JSON object, each forward path's
    depthwise launch counts). ``device`` is for rehearsing the control flow
    on the CPU."""
    from repro_torch.engine.events import InterferenceTrace
    from repro_torch.engine.rungs import Rung, default_rung_ladder
    from repro_torch.engine.session import TrainSession
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import adam

    B = CNN["batch"]
    # -- phase 12: forward at full width, the kernel against the plain path ----
    out, launches = cnn_forward_phase(dw, build_model, get_config, device)

    # -- phase 13: train each model through TrainSession (plain path) --------
    # on one fixed batch: only label mod 7 can be learnt from
    # synthetic_cnn_batch, and on a stream of fresh batches adam at lr 1e-3
    # first raises the 600-class models' loss (every head weight moves by lr,
    # towards the labels just seen), so a fixed batch is what shows learning
    # in 8 steps
    for arch in CNN_ARCHS:
        cfg = get_config(arch)
        first = make_batch_fn(cfg, B, 0, seed=CNN["seed"])(0)
        batch_fn = lambda step, first=first: first  # noqa: E731
        train = {}
        for jit in (True, False):  # captured, then eager
            rung = Rung(name="static", attn_impl="naive")
            torch.cuda.reset_peak_memory_stats()
            res, wall = run_session(TrainSession, [rung], cfg, batch_fn, CNN["steps"],
                                    optimizer=adam(), adaptive=False, lr=CNN["lr"],
                                    device=device, jit=jit)
            ms = step_ms(res)
            med = statistics.median(ms[2:] if jit else ms[1:])
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            check(all(x == x and abs(x) < 1e9 for x in res.losses),
                  f"{arch}: losses not finite: {res.losses}")
            check(res.losses[-1] < res.losses[0],
                  f"{arch}: the last loss is not below the first: {res.losses}")
            step_fn = rung.jitted_step(cfg, adam(), lr=CNN["lr"], device=device, jit=jit)
            host_ms, dev_ms, top = profile_train_step(step_fn, res.state, first)
            top = top[:8]
            mode = "captured" if jit else "eager"
            print(f"[cnn-train] {arch} {mode}: losses {[round(x, 4) for x in res.losses]}; "
                  f"step ms {[round(x, 1) for x in ms]}; median (steps "
                  f"{3 if jit else 2}-{CNN['steps']}) {med:.1f} ms = "
                  f"{B / (med / 1e3):.0f} images/s; peak memory {peak_gb:.2f} GB; "
                  f"capture {1e3 * getattr(step_fn, 'capture_s', 0):.1f} ms; profiled "
                  f"step: host {host_ms:.1f} ms, device busy {dev_ms:.1f} ms "
                  f"({100 * (1 - dev_ms / host_ms):.1f}% idle)", flush=True)
            for t, k, name in top[:6 if jit else 3]:
                print(f"[profile]   {t:8.3f} ms {k:5d} calls  {name[:90]}")
            train[mode] = {"losses": res.losses, "step_ms": ms, "median_step_ms": med,
                           "images_per_s": B / (med / 1e3), "peak_memory_gb": peak_gb,
                           "capture_ms": 1e3 * getattr(step_fn, "capture_s", 0.0),
                           "profile": {"host_ms": host_ms, "device_ms": dev_ms,
                                       "top": [[t, k, n[:120]] for t, k, n in top]}}
            del res, rung, step_fn
            free_cuda()
        rel = max(abs(a - b) / abs(b) for a, b in zip(train["captured"]["losses"],
                                                      train["eager"]["losses"]))
        print(f"[cnn-train] {arch}: captured vs eager losses, max relative "
              f"difference {rel:.3g}", flush=True)
        out[arch]["train"] = dict(train["captured"], eager=train["eager"],
                                  captured_vs_eager_loss_rel_diff=rel)
    for arch in ("mobilenet-v2", "shufflenet-v2"):  # the kernel has no gradient
        cfg = get_config(arch)
        try:
            run_session(TrainSession, [Rung(name="static", attn_impl="pallas")], cfg,
                        make_batch_fn(cfg, B, 0, seed=CNN["seed"]), 1,
                        optimizer=adam(), adaptive=False, lr=CNN["lr"],
                                device=device)
            raised = ""
        except NotImplementedError as e:
            raised = str(e)
        check(bool(raised), f"{arch}: training through the depthwise kernel did not raise")
        print(f"[cnn-train] {arch} with attn_impl='pallas' raises at the first "
              f"backward: {raised[:80]}...", flush=True)
        free_cuda()

    # -- phase 14: the adaptive ladder (no bf16 rung) on mobilenet-v2 ---------
    cfg = get_config("mobilenet-v2")
    ladder = default_rung_ladder(batch=B, attn_impl="naive", include_bf16=False)
    torch.cuda.reset_peak_memory_stats()
    res, _ = run_session(TrainSession, ladder, cfg, make_batch_fn(cfg, B, 0, seed=CNN["seed"]),
                         CNN["adaptive_steps"], optimizer=adam(), adaptive=True,
                         lr=CNN["lr"], trace=InterferenceTrace.parse(CNN["trace"]),
                         device=device)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    migrations = [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
                  for m in res.timeline.migrations]
    rungs_by_step = [s.rung for s in res.timeline.steps]
    capture_ms = {r.name: 1e3 * r.jitted_step(cfg, adam(), lr=CNN["lr"],
                                              device=device).capture_s
                  for r in ladder if r.name in rungs_by_step}
    print(f"[cnn-adaptive] mobilenet-v2 under {CNN['trace']}: migrations {migrations}; "
          f"rung per step {rungs_by_step}; step ms "
          f"{[round(x, 1) for x in step_ms(res)]} (warmup "
          f"{[s.warmup for s in res.timeline.steps]}); losses "
          f"{[round(x, 4) for x in res.losses]}; capture ms "
          f"{ {k: round(v, 1) for k, v in capture_ms.items()} }; peak memory "
          f"{peak_gb:.2f} GB with the graphs alive", flush=True)
    check(migrations and all(m[4] == "in-place" for m in migrations),
          f"no in-place migration: {migrations}")
    check(all(x == x and abs(x) < 1e9 for x in res.losses), f"{res.losses}")
    out["adaptive"] = {"arch": cfg.name, "migrations": migrations,
                       "rungs": rungs_by_step, "losses": res.losses,
                       "step_ms": step_ms(res),
                       "warmup": [s.warmup for s in res.timeline.steps],
                       "capture_ms": capture_ms, "peak_memory_gb": peak_gb}
    del res
    free_cuda()
    out["config"] = dict(CNN)
    return out, launches


def rmsnorm_path(ops, rn):
    """Phase 15: ``ops.rmsnorm`` forward and forward+backward (the gradient
    of sum(rmsnorm(x, s)) for x and s) at kernel_bench's full and CI shapes,
    4096 x 2048 and 512 x 512, f32, as ``bench_rmsnorm`` drives the
    reference. Returns (the JSON object, the launch counts)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    out, iters = {}, 20
    for k in rn.launches:
        rn.launches[k] = 0
    for rows, d in ((4096, 2048), (512, 512)):
        x = torch.randn(rows, d, generator=g, device="cuda", requires_grad=True)
        s = torch.randn(d, generator=g, device="cuda", requires_grad=True)

        def fwd():
            with torch.no_grad():
                return ops.rmsnorm(x, s)

        def fwdbwd():
            return torch.autograd.grad(ops.rmsnorm(x, s).sum(), (x, s))

        out[f"{rows}x{d}"] = {"fwd_us": time_ms(fwd, iters=iters) * 1e3,
                              "fwdbwd_us": time_ms(fwdbwd, iters=iters) * 1e3}
    counts = dict(rn.launches)
    calls = 2 * (3 + iters)  # two shapes, time_ms's 3 warm-up calls and the timed ones
    check(counts == {"rmsnorm_fwd": 2 * calls, "rmsnorm_bwd": calls},
          f"rmsnorm path launches {counts}, not {2 * calls} forwards and {calls} "
          f"backwards")
    print(f"[rmsnorm] ops.rmsnorm f32: {json.dumps(out)}; launches {counts}",
          flush=True)
    return out, counts


# ---------------------------------------------------------------------------
# phase 16: the Swan planner on the card
# ---------------------------------------------------------------------------

PLANNER = dict(trace="2:6:3.0", session_steps=8)  # the trace counts from the session's start


def planner_phase(fa, cfg, smi: str):
    """Phase 16: the default ladder explored by ``profile_rung`` through
    ``ExplorationState`` on one state carried from rung to rung, planned by
    ``plan_from_profiles``, then ``TrainSession`` on ``plan.rung_ladder()``;
    with the checks of the module docstring. Returns its JSON object and the
    launch counts of its exploration and session."""
    from repro_torch.core.cost import ladder as cost_ladder
    from repro_torch.core.planner import ExplorationState, plan_from_profiles
    from repro_torch.core.profiler import profile_rung
    from repro_torch.engine.events import InterferenceTrace
    from repro_torch.engine.rungs import default_rung_ladder
    from repro_torch.engine.session import TrainSession
    from repro_torch.launch.steps import init_train_state
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import adam

    batch_fn = make_batch_fn(cfg, TRAIN["batch"], TRAIN["seq"], seed=TRAIN["seed"])
    rungs = default_rung_ladder(batch=TRAIN["batch"], microbatch=1, attn_impl="pallas")
    micro = {r.name: r.microbatch for r in rungs}
    opt = adam()
    snaps, rung_of_step = [], []

    def counted_batches(step):  # launches so far, at the start of every step
        snaps.append(fa.all_launches())
        return batch_fn(step)

    def per_step_launches(names):
        for i, rname in enumerate(names):
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                n = snaps[i + 1][kname] - snaps[i][kname]
                check(n == cfg.n_layers * micro[rname],
                      f"planner step {i} on {rname}: {kname} launched {n} times, "
                      f"not {cfg.n_layers} x {micro[rname]}")
        return {k: snaps[-1][k] - snaps[0][k] for k in snaps[-1]}

    model = rungs[0].build_model(cfg, "cuda")
    carried = {"state": init_train_state(model, opt, model.generator(TRAIN["seed"])),
               "step": 0}
    del model

    def profiler(rung):
        # popped: the parameters a cast replaces are freed before the rung runs
        prof, carried["state"] = profile_rung(
            rung, cfg, carried.pop("state"), optimizer=opt, batch_fn=counted_batches,
            start=carried["step"], lr=TRAIN["lr"], position=rungs.index(rung),
            n=len(rungs), device="cuda")
        carried["step"] += prof.meta["steps"]
        rung_of_step.extend([rung.name] * prof.meta["steps"])
        free_cuda()
        print(f"[planner] {rung.name}: {prof.latency_s * 1e3:.2f} ms a step (median of "
              f"{len(prof.meta['step_s'])} replays "
              f"{[round(t * 1e3, 2) for t in prof.meta['step_s']]}), peak "
              f"{prof.memory_bytes / 1e9:.2f} GB, {prof.power_w:.1f} W "
              f"({prof.meta['power']}), {prof.energy_j:.2f} J a step, cost key "
              f"{prof.cost_key}, capture {prof.meta['capture_ms']:.1f} ms, calls "
              f"{prof.meta['calls']}, losses {[round(x, 4) for x in prof.meta['losses']]}; "
              f"{smi}", flush=True)
        return prof

    print(f"[planner] {cfg.name} at full width, adam lr {TRAIN['lr']}, batch "
          f"{TRAIN['batch']} x {TRAIN['seq']}: exploring {[r.name for r in rungs]}",
          flush=True)
    fa.reset_launches()
    t0 = time.perf_counter()
    explorer = ExplorationState(rungs, profiler)
    while not explorer.complete:
        explorer.explore_one()
    explore_s = time.perf_counter() - t0
    snaps.append(fa.all_launches())
    explore_launches = per_step_launches(rung_of_step)
    profiles = explorer.done
    plan = plan_from_profiles(cfg.name, torch.cuda.get_device_name(0), profiles)
    ladder_names = [p.name for p in plan.ladder]
    fastest = min(profiles, key=lambda p: p.latency_s)
    print(f"[planner] explored {plan.explored_names} in {explore_s:.1f} s "
          f"({carried['step']} train steps); pruned ladder {ladder_names}; selected "
          f"{plan.selected.name}; {smi}", flush=True)
    check(ladder_names == [p.name for p in cost_ladder(profiles)],
          f"the plan's ladder {ladder_names} is not core.cost.ladder's")
    check(plan.selected is fastest, f"selected {plan.selected.name}, not the fastest "
          f"profile {fastest.name}")
    for prof in profiles:
        check(prof.meta["calls"][:2] == ["warmup", "capture"]
              and set(prof.meta["calls"][2:]) == {"replay"},
              f"{prof.name}: calls {prof.meta['calls']}")
    losses = [x for p in profiles for x in p.meta["losses"]]

    # -- the session on the planned ladder -----------------------------------
    planned = plan.rung_ladder()
    micro.update({r.name: r.microbatch for r in planned})
    start, steps = carried["step"], PLANNER["session_steps"]
    b0, b1, slow = PLANNER["trace"].split(":")
    trace = InterferenceTrace.parse(f"{start + int(b0)}:{start + int(b1)}:{slow}")
    snaps.clear()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res, wall_s = run_session(TrainSession, planned, cfg, counted_batches, start + steps,
                              start=start, state=carried.pop("state"), optimizer=adam(),
                              adaptive=True, trace=trace)
    snaps.append(fa.all_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rungs_by_step = [s.rung for s in res.timeline.steps]
    session_launches = per_step_launches(rungs_by_step)
    migrations = [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
                  for m in res.timeline.migrations]
    print(f"[planner] session on {[r.name for r in planned]} under {trace.to_json()}: "
          f"migrations {migrations}; rung per step {rungs_by_step}; step ms "
          f"{[round(x, 1) for x in step_ms(res)]}; losses "
          f"{[round(x, 4) for x in res.losses]}; peak {peak_gb:.2f} GB; {smi}",
          flush=True)
    losses += res.losses
    check(all(x == x and abs(x) < 1e9 for x in losses), f"planner losses {losses}")
    if len(planned) > 1:
        check(any(m[3] == "interference" for m in migrations),
              f"no interference downgrade on the planned ladder: {migrations}")
    else:
        check(not migrations, f"a one-rung ladder migrated: {migrations}")
    out = {"profiles": [{"name": p.name, "latency_ms": p.latency_s * 1e3,
                         "peak_memory_gb": p.memory_bytes / 1e9, "power_w": p.power_w,
                         "energy_j": p.energy_j, "cost_key": list(p.cost_key),
                         "power_source": p.meta["power"],
                         "capture_ms": p.meta["capture_ms"], "calls": p.meta["calls"],
                         "step_ms": [t * 1e3 for t in p.meta["step_s"]],
                         "losses": p.meta["losses"]} for p in profiles],
           "ladder": ladder_names, "selected": plan.selected.name,
           "collapsed_to": ladder_names[0] if len(ladder_names) == 1 else None,
           "explore_s": explore_s, "explored_steps": start,
           "session": {"rungs": rungs_by_step, "migrations": migrations,
                       "losses": res.losses, "step_ms": step_ms(res),
                       "peak_memory_gb": peak_gb, "wall_s": wall_s},
           "device": smi}
    del res
    free_cuda()
    return out, {k: explore_launches[k] + session_launches[k] for k in explore_launches}


# ---------------------------------------------------------------------------
# phase 17: serving co-scheduled with training under one arbiter
# ---------------------------------------------------------------------------

# (a) full width: training at batch 4 x 512 beside a contiguous serve engine
# of 8 slots over 1024 positions, f32 weights; the thermal trace's summed
# draw (2.0 on both top rungs) trips the throttle at tick 7, the arbiter
# walks train full -> accum, serve full -> capped, train -> lean, serve ->
# lean (bf16 KV), the die cools below 0.5 and both come back up. An upgrade
# patience of 1 (the CLI's default is 5): a job walks up on its first clear
# tick, so the return up is decided by the trace, not by five ticks in a row
# whose wall times stay within 8% of one calibrating step (on a card whose
# step times vary that much, five such ticks may not come within the run;
# the throttle's 3x keeps the walks down trace-driven either way). 8 requests
# in 8 slots: every request is admitted at tick 0, so no eager prefill lands
# inside the measured steps. (b) cut to 2 layers (a foreground pause
# checkpoints the state; 15 GB at full depth), paged, swap policy, a
# foreground burst and a seeded chaos schedule.
COTENANT = dict(ticks=48, thermal="0.2:0.25:3.0", patience=1, requests=8,
                prompt_len=256, gen=80, layers_b=2, ticks_b=40, requests_b=24,
                prompt_len_b=64, gen_b=24, fg_burst="6:9", chaos_seed=0,
                walk_steps=3, walk_gen=96)


def mixed_argv(**kw):
    argv = ["--arch", "llama3.2-1b", "--batch", str(TRAIN["batch"]), "--seq",
            str(TRAIN["seq"]), "--optimizer", "adam", "--lr", str(TRAIN["lr"]),
            "--attn-impl", "pallas", "--slots", str(SERVE["slots"]), "--max-seq",
            str(SERVE["max_seq"])]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return argv


def run_mixed(fa, mixed, label, argv, layers=None):
    """``launch.mixed.main(argv)`` on the card (both models cut to
    ``layers``, where given), the launch counts set to 0 just before and
    read just after. Returns (the RuntimeResult, the JSON payload main
    wrote, a summary: ticks and migrations per job, each rung's steps and
    median ms, serve tokens/s by rung, decode captures and replays, peak
    memory, launches)."""
    import tempfile
    get_config = mixed.get_config
    if layers is not None:  # depth cut as phase 7 cuts it; widths are the published ones
        mixed.get_config = lambda name: dataclasses.replace(get_config(name),
                                                            n_layers=layers)
    with tempfile.TemporaryDirectory(prefix="mixed_") as tmp:
        out = str(Path(tmp) / "mixed.json")
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = mixed.main(argv + ["--json-out", out])
        finally:
            mixed.get_config = get_config
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        payload = json.loads(Path(out).read_text())
    serve_job = res.jobs["serve"]
    steps = serve_job.engine.compiled_steps()
    summary = {
        "wall_s": wall, "ticks": res.ticks,
        "steps": {n: len(j.timeline.steps) for n, j in res.jobs.items()},
        "migrations": {n: [(m.step, m.from_rung, m.to_rung, m.reason)
                           for m in res.timeline.migrations if m.job == n]
                       for n in res.jobs},
        "per_rung": {n: mixed.rung_summary(res.jobs[n].timeline)
                     for n in ("train", "serve")},
        "serve_tokens": serve_job.engine.tokens_out,
        "decode_captures": sum(f.captures for f in steps),
        "decode_replays": sum(f.replays for f in steps),
        "cache_dtypes": sorted(str(d).replace("torch.", "")
                               for d in serve_job.engine._kv_store),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": fa.all_launches(), "mixed_launches": dict(fa.mixed_launches),
        "preemptions": res.preemptions,
    }
    print(f"[cotenancy] {label}: {res.ticks} ticks in {wall:.1f} s, steps "
          f"{summary['steps']}, peak {summary['peak_memory_gb']:.2f} GB", flush=True)
    for n, migs in summary["migrations"].items():
        print(f"[cotenancy] {label}: {n} migrations {migs}")
    for n, rungs in summary["per_rung"].items():
        unit = "samples" if n == "train" else "tokens"
        for rung, r in rungs.items():
            print(f"[cotenancy] {label}: {n} on {rung}: {r['steps']} ticks, median "
                  f"{r['median_ms']:.2f} ms over {r['steady']} steady, "
                  f"{r['work_per_s']:.1f} {unit}/s")
    print(f"[cotenancy] {label}: decode captures {summary['decode_captures']}, "
          f"replays {summary['decode_replays']}, cache dtypes "
          f"{summary['cache_dtypes']}; launches {summary['launches']}; mixed "
          f"{ {k: v for k, v in summary['mixed_launches'].items() if v} }", flush=True)
    return res, payload, summary


def check_tokens(label, engine, vocab):
    for slot, toks in enumerate(engine.generated):
        check(all(0 <= t < vocab for t in toks), f"{label}: slot {slot} token out of range")
    for u, f in engine.finished.items():
        check(f.tokens and all(0 <= t < vocab for t in f.tokens),
              f"{label}: request {u} emitted {f.tokens}")


def ladder_walk(fa, serve, build_model, cfg, reqs):
    """(c) The default serve ladder walked down (serve-full -> capped ->
    lean, bf16 KV) and back up twice, through ServeJob's migrations, on a
    contiguous engine at full width decoding 8 residents: each cache dtype's
    decode graph is captured once and replayed after every later walk,
    the second walk allocates nothing, and memory grows across the first
    by at most the bf16 cache's storage and one graph pool (the memory the
    first capture reserved)."""
    from repro_torch.engine.jobs import ServeJob, default_serve_ladder
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    engine = serve.ContinuousBatchingEngine(model, params, max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"])
    job = ServeJob(engine, [serve.Request(uid=r.uid, prompt=r.prompt,
                                          max_new_tokens=COTENANT["walk_gen"])
                            for r in reqs[:SERVE["slots"]]],
                   rungs=default_serve_ladder(SERVE["slots"]), adaptive=False)
    fa.reset_launches()
    job.prepare()
    tick = 0
    warm = []

    def run(n):
        nonlocal tick
        for _ in range(n):
            warm.append((job.active_rung.name, job.step(tick).warmup))
            tick += 1

    def mark():
        # a capture empties the allocator's cache as it starts, so every mark
        # does too: reserved memory is then what is live, graph pools included
        torch.cuda.synchronize()
        free_cuda()
        return (torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved(),
                engine._decode.captures, engine._decode.replays)

    run(1)  # admissions and the eager first call
    before_capture = mark()
    run(1)  # the capture
    pool_bytes = mark()[1] - before_capture[1]
    check(pool_bytes > 0, f"ladder walk: the first capture reserved {pool_bytes} bytes")
    run(COTENANT["walk_steps"] - 2)
    marks = [mark()]
    for _ in range(2):
        for direction in ("down", "down", "up", "up"):
            job.migrate(direction, "walk", tick)
            run(COTENANT["walk_steps"])
        marks.append(mark())
    store_bytes = sum(t.numel() * t.element_size()
                      for t in engine._kv_store[torch.bfloat16].values())
    out = {"peak_allocated_gb": [m[0] / 1e9 for m in marks],
           "reserved_gb": [m[1] / 1e9 for m in marks],
           "captures": [m[2] for m in marks], "replays": [m[3] for m in marks],
           "bf16_store_gb": store_bytes / 1e9, "first_capture_pool_gb": pool_bytes / 1e9,
           "launches": fa.all_launches(), "mixed_launches": dict(fa.mixed_launches),
           "warmup_ticks": [w for w in warm if w[1]]}
    print(f"[cotenancy] ladder walk x2: captures {out['captures']}, replays "
          f"{out['replays']}; max_memory_allocated before the first walk to "
          f"serve-lean {out['peak_allocated_gb'][0]:.3f} GB, after the walks back "
          f"{out['peak_allocated_gb'][1]:.3f}, {out['peak_allocated_gb'][2]:.3f} GB; "
          f"reserved {[round(x, 3) for x in out['reserved_gb']]} GB; bf16 cache "
          f"storage {out['bf16_store_gb']:.3f} GB, first capture's pool "
          f"{out['first_capture_pool_gb']:.3f} GB; warmup ticks {out['warmup_ticks']}",
          flush=True)
    check(job.active_rung.name == "serve-full" and engine.cache["k"].dtype == torch.float32,
          "ladder walk: not back on serve-full's f32 cache")
    check(out["captures"] == [1, 2, 2], f"ladder walk: captures {out['captures']}, "
          f"want one per cache dtype (f32, bf16) and none on the second walk")
    check(marks[2][:2] == marks[1][:2], f"ladder walk: the second walk allocated "
          f"memory: {marks[1][:2]} -> {marks[2][:2]}")
    slack = 8 << 20  # the allocator's 2 MiB segments
    check(marks[1][1] - marks[0][1] <= store_bytes + pool_bytes + slack,
          f"ladder walk: reserved memory grew by {marks[1][1] - marks[0][1]} bytes, "
          f"more than the bf16 storage ({store_bytes}) and one graph pool ({pool_bytes})")
    check(out["mixed_launches"]["flash_decode:float32:bfloat16"] > 0,
          "ladder walk: serve-lean did not launch the mixed-dtype decode")
    engine.run([])
    check(sorted(engine.finished) == [r.uid for r in reqs[:SERVE["slots"]]],
          "ladder walk: requests missing")
    check_tokens("ladder walk", engine, cfg.vocab_size)
    del job, engine, model, params
    free_cuda()
    return out


def slot_cap_streams(fa, serve, build_model, cfg, reqs):
    """(d) The phase-4 requests through a ServeJob that migrates along a
    ladder of slot caps only (default_serve_ladder without the bf16 rung,
    virtual latencies under a burst), and through one fixed at serve-full:
    token-identical streams, since caps change scheduling, not math."""
    from repro_torch.engine.events import InterferenceTrace
    from repro_torch.engine.jobs import ServeJob, default_serve_ladder, trace_latency_fn
    from repro_torch.engine.runtime import SwanRuntime
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    runs = {}
    for migrating in (False, True):
        rungs = default_serve_ladder(SERVE["slots"], include_bf16_kv=False)
        for r in rungs:
            r.latency_estimate_s = 0.01 * r.rel_latency
        trace = InterferenceTrace.parse("10:40:4.0") if migrating else None
        engine = serve.ContinuousBatchingEngine(model, params, max_batch=SERVE["slots"],
                                                max_seq=SERVE["max_seq"])
        job = ServeJob(engine, [serve.Request(uid=r.uid, prompt=r.prompt,
                                              max_new_tokens=r.max_new_tokens)
                                for r in reqs],
                       rungs=rungs, latency_fn=trace_latency_fn(trace),
                       adaptive=migrating, name="serve")
        fa.reset_launches()
        res = SwanRuntime([job], trace=trace).run(100_000)
        runs[migrating] = (streams_of(engine.finished),
                           [(m.step, m.from_rung, m.to_rung) for m in res.timeline.migrations],
                           fa.all_launches())
        del job, engine
    (fixed, _, n_fixed), (moved, migs, n_moved) = runs[False], runs[True]
    print(f"[cotenancy] slot caps only: migrations {migs}; streams "
          f"{'token-identical' if moved == fixed else 'DIFFER'} to serve-full's "
          f"({len(fixed)} requests); flash_decode launches {n_moved['flash_decode']} "
          f"/ {n_fixed['flash_decode']}", flush=True)
    check(len(migs) >= 2, f"slot caps only: the burst forced {migs}")
    check(moved == fixed, "slot caps only: the migrating engine's streams differ "
          "from the fixed one's")
    del model, params
    free_cuda()
    return {"migrations": migs, "identical": True, "requests": len(fixed),
            "launches": n_moved}


def bf16_cache_streams(fa, serve, build_model, cfg, reqs):
    """(e) Engines with a bf16 cache over f32 weights (the serve-lean
    rung's arithmetic), full width cut to PAGED["layers"] as phases 9-11,
    the first 8 phase-4 requests: through the kernels contiguous and paged,
    each at draft depth 0 and 4 (the four mixed-dtype kernels), held to the
    plain path's contiguous bf16-cache streams under phase 5's rule (the
    margin over a bf16 cache). (f) f32 queries' converse: bf16 weights over
    the default f32 cache, through the kernels and the plain path; the
    streams are reported, not held (bf16 weights round every product)."""
    from repro_torch.launch.steps import cast_params
    pallas = build_model(cfg, impl="pallas", device="cuda")
    naive = build_model(cfg, impl="naive", device="cuda")
    params = pallas.init(pallas.generator(0))
    sub = [serve.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
           for r in reqs[:SERVE["slots"]]]
    bf = torch.bfloat16
    want, _, _ = run_engine(serve, naive, params, sub, cache_dtype=bf)
    want = streams_of(want)
    out = {}
    for layout in ("contig", "paged"):
        for depth in (0, 4):
            fa.reset_launches()
            done, engine, wall = run_engine(serve, pallas, params, sub, cache_dtype=bf,
                                            kv_layout=layout, draft_depth=depth)
            mixed = {k: v for k, v in fa.mixed_launches.items() if v}
            key = f"{layout} depth {depth}"
            ident = same_streams(f"bf16 KV {key}", streams_of(done), want, naive,
                                 params, sub, cache_dtype=bf)
            kernel = {("contig", 0): "flash_decode", ("paged", 0): "flash_decode_paged",
                      ("contig", 4): "flash_decode_spec",
                      ("paged", 4): "flash_decode_spec_paged"}[(layout, depth)]
            check(fa.mixed_launches[f"{kernel}:float32:bfloat16"] > 0,
                  f"bf16 KV {key}: {kernel} ran no f32-q, bf16-KV launch: {mixed}")
            check(engine.cache["k"].dtype == bf, f"bf16 KV {key}: cache {engine.cache['k'].dtype}")
            out[key] = {"identical_streams": ident, "tok_s": engine.tokens_out / wall,
                        "mixed_launches": mixed}
            print(f"[cotenancy] bf16 KV over f32 weights, {key}: {ident}/{len(want)} "
                  f"streams token-identical to the plain path's, "
                  f"{engine.tokens_out / wall:.1f} tok/s, launches {mixed}", flush=True)
            del engine, done
    # (f) bf16 weights, f32 cache: bf16 queries over an f32 cache
    bparams = cast_params(params, bf)
    fa.reset_launches()
    done_b, engine_b, wall_b = run_engine(serve, pallas, bparams, sub)
    mixed = {k: v for k, v in fa.mixed_launches.items() if v}
    check(fa.mixed_launches["flash_decode:bfloat16:float32"] > 0,
          f"bf16 weights: no bf16-q, f32-KV launch: {mixed}")
    check(engine_b.cache["k"].dtype == torch.float32, "bf16 weights: cache not f32")
    check(sorted(done_b) == [r.uid for r in sub], "bf16 weights: requests missing")
    check_tokens("bf16 weights", engine_b, cfg.vocab_size)
    done_bn, _, _ = run_engine(serve, naive, bparams, sub)
    same = sum(streams_of(done_b)[u] == f.tokens for u, f in done_bn.items())
    out["bf16 weights, f32 cache"] = {"identical_streams": same,
                                      "tok_s": engine_b.tokens_out / wall_b,
                                      "mixed_launches": mixed}
    print(f"[cotenancy] bf16 weights over an f32 cache: {same}/{len(sub)} streams "
          f"token-identical to the plain path's (reported, not held), "
          f"{engine_b.tokens_out / wall_b:.1f} tok/s, launches {mixed}", flush=True)
    del engine_b, done_b, done_bn, pallas, naive, params, bparams
    free_cuda()
    return out


def cotenancy_phase(fa, serve, build_model, cfg, reqs):
    """Phase 17: ``launch.mixed.main`` on the card, (a) at full width and
    (b) cut to 2 layers with the paged swap engine, a foreground burst and
    chaos; then (c) the ladder walked twice, (d) slot-cap migrations against
    a fixed engine, (e) bf16-cache engines against the plain path and (f)
    bf16 weights over an f32 cache. Returns (the JSON object, the launch
    counts of each path, the mixed-dtype launch counts of each path)."""
    from repro_torch.launch import mixed
    C = COTENANT
    launches, mixed_launches = {}, {}
    # -- (a) full width --------------------------------------------------------
    res, payload, a = run_mixed(fa, mixed, "full width", mixed_argv(
        ticks=C["ticks"], requests=C["requests"], prompt_len=C["prompt_len"],
        gen=C["gen"], thermal_trace=C["thermal"], upgrade_patience=C["patience"]))
    launches["cotenancy"], mixed_launches["cotenancy"] = a["launches"], a["mixed_launches"]
    serve_steps = res.jobs["serve"].timeline.steps
    serve_rungs = [s.rung for s in serve_steps]
    # each serve tick: rung, wall ms, the ms the monitor read, warmup
    a["serve_ticks"] = [(s.rung, round(1e3 * s.latency_s, 3), round(1e3 * s.observed_s, 3),
                         s.warmup) for s in serve_steps]
    print(f"[cotenancy] full width: serve ticks {a['serve_ticks']}", flush=True)
    smig, tmig = a["migrations"]["serve"], a["migrations"]["train"]
    check(tmig and smig, f"full width: train {tmig}, serve {smig}: each job must migrate")
    check("serve-lean" in serve_rungs, "full width: the serve job never reached serve-lean")
    check(any(m[1] == "serve-lean" for m in smig),
          f"full width: the serve job did not come back up from serve-lean: {smig}")
    check(a["mixed_launches"]["flash_decode:float32:bfloat16"] > 0,
          "full width: serve-lean did not launch the f32-q, bf16-KV decode")
    check(a["decode_captures"] == len(a["cache_dtypes"]),
          f"full width: {a['decode_captures']} decode captures for cache dtypes "
          f"{a['cache_dtypes']}: want one per signature")
    losses = res.jobs["train"].result().losses
    check(losses and all(np.isfinite(losses)), f"full width: losses {losses}")
    check(a["launches"]["flash_bwd_dq"] > 0 and a["launches"]["flash_decode"] > 0,
          f"full width: launches {a['launches']}")
    check_tokens("full width", res.jobs["serve"].engine, cfg.vocab_size)
    a["losses"] = [losses[0], losses[-1]]
    del res
    free_cuda()
    # -- (b) cut to 2 layers: paged, swap, foreground burst, chaos -------------
    res, payload, b = run_mixed(fa, mixed, f"{C['layers_b']} layers", mixed_argv(
        ticks=C["ticks_b"], requests=C["requests_b"], prompt_len=C["prompt_len_b"],
        gen=C["gen_b"], thermal_trace=C["thermal"], kv_layout="paged",
        admission_policy="swap", fg_burst=C["fg_burst"], chaos_seed=C["chaos_seed"]),
        layers=C["layers_b"])
    launches["cotenancy_paged"] = b["launches"]
    mixed_launches["cotenancy_paged"] = b["mixed_launches"]
    applied = set(payload["chaos"]["applied"])
    b["chaos_applied"] = sorted(applied)
    b["chaos_skipped"] = sorted({e["kind"] for e in payload["chaos"]["log"] if "skipped" in e})
    print(f"[cotenancy] {C['layers_b']} layers: chaos.applied {sorted(applied)}, "
          f"skipped {b['chaos_skipped']}, preemptions {res.preemptions}", flush=True)
    check({"pool_pressure", "ckpt_torn", "fg_burst"} <= applied,
          f"{C['layers_b']} layers: chaos applied only {sorted(applied)}")
    train = res.jobs["train"]
    pauses = [m.step for m in train.timeline.migrations if m.reason == "pause"]
    resumes = [m.step for m in train.timeline.migrations if m.reason == "resume"]
    check(res.preemptions >= 1 and pauses and pauses == resumes,
          f"{C['layers_b']} layers: pauses {pauses} resumed at {resumes}")
    check([s.step for s in train.timeline.steps] == list(range(len(train.timeline.steps))),
          f"{C['layers_b']} layers: train steps not contiguous")
    check(all(np.isfinite(train.result().losses)), f"{C['layers_b']} layers: losses")
    check(b["launches"]["flash_decode_paged"] > 0,
          f"{C['layers_b']} layers: no paged decode launch: {b['launches']}")
    check_tokens(f"{C['layers_b']} layers", res.jobs["serve"].engine, cfg.vocab_size)
    b["pauses"], b["resumes"] = pauses, resumes
    b["serve_stats"] = {k: payload["serve_stats"].get(k) for k in (
        "held_blocks", "swap_outs", "swap_ins", "timeouts", "rejected", "accepting")}
    del res, train
    free_cuda()
    # -- (c) the ladder walked twice, (d) slot caps, (e)-(f) bf16 caches -------
    walk = ladder_walk(fa, serve, build_model, cfg, reqs)
    launches["ladder_walk"], mixed_launches["ladder_walk"] = walk["launches"], \
        walk["mixed_launches"]
    caps = slot_cap_streams(fa, serve, build_model, cfg, reqs)
    launches["slot_caps"] = caps["launches"]
    cut = dataclasses.replace(cfg, n_layers=PAGED["layers"])
    bf16 = bf16_cache_streams(fa, serve, build_model, cut, reqs)
    for key, v in bf16.items():
        mixed_launches[f"bf16_kv {key}"] = v["mixed_launches"]
    out = {"full_width": a, "cut": b, "ladder_walk": walk, "slot_caps": caps,
           "bf16_kv": bf16, "config": C}
    return out, launches, mixed_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ops, ref
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.paging import gather_paged_kv

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul and cudnn)", flush=True)

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = list(backend.LIBRARIES)
    backend.build_libraries(libs)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(libs)} for sm_90a in {build_s:.1f} s", flush=True)
    for lib in libs:  # -Xptxas -v: registers and spills per instantiation
        log = backend.library_path(lib).with_suffix(".log").read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {lib}: {len(regs)} kernels, registers "
              f"{min(regs)}-{max(regs)}, spill stores up to {max(spills)} bytes "
              f"({sum(1 for x in spills if x)} kernels spill)")

    seconds = {"build": build_s}
    t0 = time.perf_counter()

    def lap(name):  # host seconds of each group of phases
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1
        print(f"[time] {name}: {seconds[name]:.1f} s", flush=True)

    # -- phase 3: kernels against their plain versions -------------------------
    fwd = check_flash_fwd(fa, ref)
    dec = check_flash_decode(fa, ref)
    bwd_dq, bwd_dkv = check_flash_bwd(fb, ref)
    dec_paged = check_flash_decode_paged(fa, ref, gather_paged_kv)
    spec = check_flash_decode_spec(fa, ref, gather_paged_kv, paged=False)
    spec_paged = check_flash_decode_spec(fa, ref, gather_paged_kv, paged=True)
    dwc = check_depthwise(dw, ref)
    rms_fwd, rms_bwd = check_rmsnorm(rn, ref)
    mixed_dec = check_mixed_decode(fa, ref, gather_paged_kv)
    for c in (fwd + dec + bwd_dq + bwd_dkv + dec_paged + spec + spec_paged + dwc
              + rms_fwd + rms_bwd + mixed_dec):
        check(c["ok"], f"kernel disagrees with its plain version: {c}")
    lap("phase 3")

    # -- phases 4 and 5: serve with the kernels, then the plain path -----------
    cfg = get_config("llama3.2-1b")
    reqs = make_requests(serve, cfg.vocab_size)
    serve_out, serve_launches, contig_streams = serve_phases(fa, serve, build_model,
                                                             cfg, reqs)
    lap("phases 4-5")
    train_out, train_launches = train_phases(fa, build_model, cfg)
    lap("phases 6-8")
    paged_out, spec_out, path_launches = paged_and_spec_phases(
        fa, serve, build_model, dataclasses.replace(cfg, n_layers=PAGED["layers"]),
        reqs, None)
    lap("phases 9-11")
    cnn_out, cnn_launches = cnn_phases(dw, build_model, get_config)
    lap("phases 12-14")
    rms_out, rms_launches = rmsnorm_path(ops, rn)
    lap("phase 15")
    planner_out, planner_launches = planner_phase(fa, cfg, smi)
    lap("phase 16")
    cotenancy_out, cotenancy_launches, cotenancy_mixed = cotenancy_phase(
        fa, serve, build_model, cfg, reqs)
    lap("phase 17")

    def entry(kname, source, replaces, checks, launches_by_path):
        main_c = checks[0]  # f32, the path's dtype
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": main_c["max_abs_err"], "max_err": main_c["max_abs_err"],
            "ms": main_c["ms"], "kernel_ms": main_c["ms"],
            "plain_ms": main_c["plain_ms"], "bound_ms": main_c["bound_ms"],
            "bound_by": main_c["bound_by"], "library_ms": main_c["library_ms"],
            "checks": checks,
        }

    adaptive_launches = train_out["adaptive"]["launches"]
    kernels = [
        entry("flash_fwd", "src/repro_torch/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention.py:111 (_fwd_kernel, "
              "pallas_call at :173)", fwd,
              {"serve": serve_launches["flash_fwd"],
               "train": train_launches["flash_fwd"],
               "adaptive": adaptive_launches["flash_fwd"]}),
        entry("flash_bwd_dq", "src/repro_torch/csrc/flash_bwd.cu",
              "src/repro/kernels/flash_attention.py:205 (_dq_kernel, "
              "pallas_call at :309)", bwd_dq,
              {"train": train_launches["flash_bwd_dq"],
               "adaptive": adaptive_launches["flash_bwd_dq"]}),
        entry("flash_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
              "src/repro/kernels/flash_attention.py:251 (_dkv_kernel, "
              "pallas_call at :338)", bwd_dkv,
              {"train": train_launches["flash_bwd_dkv"],
               "adaptive": adaptive_launches["flash_bwd_dkv"]}),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode_paged.cu",
              "src/repro/kernels/flash_attention.py:438 (_decode_kernel, "
              "pallas_call at :536)", dec,
              {"serve": serve_launches["flash_decode"]}),
        entry("flash_decode_paged", "src/repro_torch/csrc/flash_decode_paged.cu",
              "src/repro/kernels/flash_attention.py:551 (_decode_paged_kernel, "
              "pallas_call at :616)", dec_paged,
              {p: path_launches[p]["flash_decode_paged"]
               for p in ("serve_paged", "swap")}),
        entry("flash_decode_spec", "src/repro_torch/csrc/flash_decode_spec.cu",
              "src/repro/kernels/flash_attention.py:631 (_spec_decode_kernel, "
              "pallas_call at :736)", spec,
              {"spec_contig": path_launches["spec_contig"]["flash_decode_spec"]}),
        entry("flash_decode_spec_paged", "src/repro_torch/csrc/flash_decode_spec.cu",
              "src/repro/kernels/flash_attention.py:746 "
              "(_spec_decode_paged_kernel, pallas_call at :801)", spec_paged,
              {"spec_paged":
               path_launches["spec_paged"]["flash_decode_spec_paged"]}),
        entry("depthwise_conv", "src/repro_torch/csrc/depthwise_conv.cu",
              "src/repro/kernels/depthwise_conv.py:28 (_dw_kernel, "
              "pallas_call at :60)", dwc,
              {p: n for p, n in cnn_launches.items() if n}),
        entry("rmsnorm_fwd", "src/repro_torch/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm.py:31 (_rmsnorm_kernel, pallas_call at :51)",
              rms_fwd, {"rmsnorm": rms_launches["rmsnorm_fwd"]}),
        entry("rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm.py:38 (_rmsnorm_bwd_kernel, "
              "pallas_call at :77)", rms_bwd,
              {"rmsnorm": rms_launches["rmsnorm_bwd"]}),
    ]
    # each attention kernel's three modes side by side: the forward at the
    # serve path's B1 S512, the backward at the train shape
    def by_mode(checks, keep):
        return {f"{c['dtype']}{'+lowp' if c['lowp'] else ''}": c["ms"]
                for c in checks if keep(c)}
    kernels[0]["ms_by_mode"] = by_mode(fwd, lambda c: c["shape"][:3] == [1, 32, 512])
    # the f32 forward at each prefill length and at the train step's B4
    kernels[0]["ms_f32_by_shape"] = {f"B{c['shape'][0]} S{c['shape'][2]}": c["ms"]
                                     for c in fwd if c["dtype"] == "float32" and not c["lowp"]}
    for e in kernels[:3]:  # the planner's exploration and session (phase 16)
        e["launches_by_path"]["planner"] = planner_launches[e["name"]]
    for e in kernels[1:3]:
        e["ms_by_mode"] = by_mode(e["checks"], lambda c: c["shape"][0] == TRAIN["batch"])
    # the paths that ran after phase 4 launched these too
    for e in kernels:
        for p in ("spec_contig", "serve_paged", "swap", "spec_paged"):
            n = path_launches[p].get(e["name"], 0)
            if n and p not in e["launches_by_path"]:
                e["launches_by_path"][p] = n
        for p, counts in cotenancy_launches.items():  # phase 17
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    # the decode kernels' mixed-dtype instantiations (phase 3's checks,
    # phase 17's launches): a KV cache in another dtype than the queries'
    replaces = {e["name"]: e["replaces"] for e in kernels}
    for c in mixed_dec:
        key = f"{c['name']}:{c['q_dtype']}:{c['kv_dtype']}"
        by_path = {p: n[key] for p, n in cotenancy_mixed.items() if n.get(key)}
        check(by_path, f"phase 17 launched no {key}")
        e = entry(f"{c['name']} ({c['q_dtype']} q, {c['kv_dtype']} KV)",
                  "src/repro_torch/csrc/" + ("flash_decode_spec.cu" if "spec" in c["name"]
                                             else "flash_decode_paged.cu"),
                  replaces[c["name"]], [c], by_path)
        kernels.append(e)
    print(json.dumps({"serve": serve_out}))
    print(json.dumps({"train": dict(train_out, build_s=build_s, seconds=seconds,
                                    seconds_total=time.perf_counter() - t_start)}))
    print(json.dumps({"serve_paged": paged_out}))
    print(json.dumps({"serve_spec": spec_out}))
    print(json.dumps({"cnn": cnn_out}))
    print(json.dumps({"rmsnorm": rms_out}))
    print(json.dumps({"planner": planner_out}))
    print(json.dumps({"cotenancy": cotenancy_out}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
