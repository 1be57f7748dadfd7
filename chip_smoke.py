#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: exits non-zero, printing no result, unless
   ``torch.cuda.is_available()``. TF32 is switched off for matmuls and
   cuDNN, so every f32 product on the card runs in full f32.
2. Build: compiles the seven ``src/repro_torch/csrc/*.cu`` for sm_90a with
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
18. Federated learning: (a) ``fl.real.run_real``, the real FedAvg cohort
   of ``benchmarks/table4_fl.py`` at ResNet34's published widths (35
   classes, 1x32x32, 21.29M parameters, seeded f32 weights): 8 clients x 6
   rounds x 4 local sgd steps (lr 0.05) of batch 16, captured on cuDNN's
   default algorithms, then captured and eager on deterministic ones (the
   default conv backward sums with atomics, which 192 steps amplify to
   about 1% between two runs). Gates: every loss finite, one capture for
   the 192 local steps of each captured run, the deterministic captured and
   eager round losses within LOSS_RTOL, and each round's ``fedavg`` on the
   card (the first run) within 1e-6 of each leaf's largest magnitude of a
   float64 host mean of the same deltas. Prints the
   round losses, whether the last is below the first (reported, not
   gated), the median local step ms and images/s, the ms of a ``fedavg``
   round beside its bytes bound, the peak memory and the kernel launches
   (none: ResNet34 has no depthwise layer and trains on the plain path).
   (b) ``repro_torch.launch.fleet.main`` at its documented usage (480
   clients, 6 rounds, 20 a round, churn 0.1 and 0.35 in round 4, drop, dup
   and corrupt 0.05) with a coordinator crash in round 2, then without:
   the resumed run's aggregates equal the crash-free run's (crc32), and
   every class of ``engine.chaos.FLEET_KINDS`` was applied; wall seconds.
19. Sampled serving (``SAMPLE``: temperature 0.9, top-k 32, sample seed 1,
   ``benchmarks/spec_bench.py``'s settings; the draw inside the captured
   decode step, keys ``fold_in(fold_in(PRNGKey(seed), uid), index)`` from
   ``repro_torch.prng``). (a) The phase-4 requests at 16 layers, eager,
   captured, captured: streams and launches equal; uid 0 alone in a 1-slot
   engine gives its batched stream; the plain path's streams under the
   stream rule (equal up to a first difference, where the held run's
   decision — the perturbed top-2 margin of its draw, or |u·p(d) − q(d)| of
   an accept test — lay within NEAR_TIE of a tie; an eager rerun of the held
   path records the margins, only where a stream differs). Prints tok/s,
   a captured sampled step's host and device ms, and the sampler's own
   device ms at (8, 128256) beside a greedy argmax. (b) temperature 5.0 and
   top-k 1 give phase 4's greedy streams exactly. (c) At 8 layers, as
   phases 9-11: paged with shared prefixes, swap, and draft depth 4 with
   the n-gram draft, contiguous and paged, each held to the plain path
   under the stream rule; tok/s and acceptance. (d) A sampled ``ModelDraft``
   over the full vocabulary (``MODEL_DRAFT``: temperature 1.0, no top-k,
   the full width cut to 2 layers) drafting 4 for the 8-layer target on 8
   of the requests, 16 tokens each, held likewise. (e) ``prng`` on the
   card: (8, 128256) random bits and uniforms equal the CPU's, Gumbel noise
   within 1e-6, the draws equal but at a near tie.
20. The dense family at full width. First the attention kernels at
   nemotron-4-15b's geometry (hd 128, G = 6; the verify at S*G = 30) in
   bf16 without lowp and in f32 against their plain versions, timed beside
   SDPA and their bounds (``check_dense_kernels``). (a) nemotron-4-15b (32
   layers, d_model 6144, 48/8 heads, untied 256000-token head, LayerNorm,
   squared ReLU) with bf16 weights (``param_dtype``, 31.3 GB) and a bf16 KV
   cache, ``ContinuousBatchingEngine(attn_impl="pallas")`` captured: 4
   slots, 8 requests of 192-320 prompt tokens and 16 greedy tokens, max_seq
   512; contiguous, paged (blocks of 16, phase 9's shared prefixes) and
   speculative (n-gram, depth 4). flash_fwd (not on the paged path, whose
   prefill is plain) and each path's decode kernel launched; each path's
   streams held to the same requests through the plain path under phase
   5's rule, where a bf16 model's bf16 logits admit a margin of one bf16
   unit of the top logit (their resolution; ``same_streams``), every
   divergence and its margin recorded; tok/s, peak memory and a captured
   decode step's host and device ms. (b) granite-3-2b (40 layers, d_model
   2048, tied 49155-token head), f32: first-step loss and gradients under
   remat none, dots and full (eager autograd) within LOSS_RTOL and
   GRAD_RTOL of none's, and under full the kernels against the plain path
   likewise; the memory the forward keeps for the backward, and the
   forward's peak memory, strictly ordered none > dots > full (the
   backward's peak, which stacks each leaf's gradients at its end, and a
   whole step's, which adam's update sets, are printed). Then ``TrainSession``
   on the f32 ``full`` rung (adam, lr 3e-4, batch 4 x 512, 4 steps: eager,
   capture, two replays) under each policy in turn, each policy's graphs
   freed before the next: losses within LOSS_RTOL of none's (whether they
   are bitwise equal is recorded), flash_fwd launched twice a layer and
   step under remat (the recomputed forward), the backward kernels once;
   then the bf16 ``lean`` rung under full. Prints each run's step ms and
   peak memory (a whole step's, which adam's update sets).
21. Telemetry on the card (``repro_torch.obs``; ``benchmarks/obs_bench.py``'s
   gate of at most 3% tokens/s). (a) obs_bench's engine (2 layers, d_model
   64, 4/2 heads, vocab 256, plain attention, paged blocks of 4, 4 slots,
   max_seq 64), the decode step captured and warmed, waves of 8 prompts of
   8 tokens and 16 new tokens, telemetry off and on interleaved in 40
   pairs, each run timed over its decode steps alone (its admissions, the
   eager paged prefill, timed to a synchronise and taken out: their host
   jitter spreads a whole wave by more than 3%); the same with telemetry
   off in both arms (A/A). Gate: the "on" runs recorded spans, and the
   median of the pairs' on/off ratios is at least 0.97, and so is the A/A
   median (the method resolves the gate). (b) phase 4's engine and
   requests at full width, captured, obs_bench's own method on whole
   waves: 15 interleaved repetitions a mode, best of each, on/off at least
   0.97; streams on equal to off and to phase 4's, ``serve.decode`` once
   a decode step, no capture in the timed runs; each span's mean host µs.
   (c) the serve
   CLI (``launch.serve.main``) at full width with ``--telemetry-out`` and
   ``--json-out``, contiguous greedy and paged at draft depth 4: decode and
   verify spans equal the payload's steps, ``serve.prefill`` the
   admissions, ``serve.prefill_chunk`` and ``serve.cow_copy`` the engine's
   counters, the final ``spec_*`` metrics its ``spec_drafted`` and
   ``spec_accepted``, ``schema_version`` in the payload, and
   ``launch/obs_report.py``'s re-derived trace the span names of
   ``trace.json``. (d) phase 17(b)'s mixed run at 2 layers (paged, without
   the burst and chaos, whose pauses the audit records as such), with
   ``--battery-j 200`` and ``--telemetry-out``: the assertions of
   ``tests/test_obs.py::test_mixed_run_emits_complete_bundle`` (metric
   families, span names, one ``runtime.tick`` a tick, an audit commit with
   scores for every migration, ``runtime.tick`` the top span). Every span
   wraps an engine's call of a step from the host, so a replay counts as
   an eager call does; spans time host work only.
22. The deepseek family at full width, in bf16 and in f32. (a)
   ``flash_decode_mla`` and ``flash_decode_mla_paged`` (``MLA_KERNEL``:
   deepseek-v3's latent geometry, H = G 128, keys of r 512 + rd 64, values
   the 512-wide latent, scale 1/sqrt(192); B 8 over 4096 positions, 256
   blocks of 16 paged, ragged lengths with 0 and 4097) against their plain
   versions, f32 q over a bf16 and an f32 cache, beside one SDPA over the
   128 heads as one head's query rows (cat, upcast, and the gather paged,
   in its time); then the GQA kernels at deepseek-moe-16b's geometry (K 16,
   G 1, hd 128: ``check_dense_kernels``). (b) deepseek-v3-671b cut to 4
   layers (its 3 dense MLA layers, 1 MLA + MoE layer of 256 routed experts
   and 1 shared, the MTP head's params: 671B does not fit one card) and (c)
   deepseek-moe-16b whole (28 layers), each served as the serve CLI's
   ``--attn-impl auto`` builds it (the kernels at max_seq 512), captured,
   ``DEEPSEEK``'s 4 slots, 8 requests of 192-320 tokens and 16 greedy
   tokens: (b) contiguous and paged (the MLA kernels launch on each; the
   prefill warns once and takes the chunked path, as the reference's
   does), (c) contiguous, paged and speculative (draft depth 4); then both
   again with f32 weights and cache (63.2 and 65.5 GB). Streams compared
   with the plain path's (``naive``) under ``moe_streams``: phase 5's rule,
   the plain path's margin taken from its own batched run (a replay alone
   would change what shares the experts' capacity), or else the causally
   first decisions the two paths took differently in that token's past (a
   router top-k, a capacity cut, another stream's token where capacity
   couples the streams; ordered by call, then moe layer), each within phase
   5's rule, from eager recorded reruns that must give the captured
   streams. The f32 runs are held to it. The bf16 runs are reported, not
   held: the bf16 residual stream rounds each layer's output, so two correct
   summation orders drift apart by several units of the router logits by
   the deep layers, and a first decision outside one unit says nothing of
   the kernel there. Prints each path's tok/s, peak memory, launches, and
   (bf16) a profiled decode step's host and device ms.
23. Training of the moe family. The flash forward and backward at
   deepseek-moe-16b's train geometry (``MOE_GEOMETRY``: B4 H16 S512 hd128,
   causal) in f32 and bf16 against their plain versions, timed beside SDPA
   and their bounds; the MoE layer's forward and backward at its
   full-width shape (T 2048, E 64, top-6, d 2048, ff 1408) twice on the
   same inputs: every gradient the same bits. (a) deepseek-moe-16b at full
   width cut to 5 layers (``MOE_TRAIN``: the dense layer and 4 MoE layers,
   2.85B params, f32; the whole model's state does not fit a card), adam lr
   3e-4, phase 6's batch 4 x 512 and 6 steps through ``TrainSession`` on a
   static rung, pallas eager, pallas captured, then naive captured, held to
   phase 6's rules: flash_fwd, flash_bwd_dq and flash_bwd_dkv 5 x 6 each on
   the pallas runs, none on the plain one; captured and eager losses within
   LOSS_RTOL, a replayed step's gradients within GRAD_RTOL of an eager
   step's; pallas and naive losses within LOSS_RTOL and first-step
   gradients within GRAD_RTOL. The routing and capacity decisions the two
   paths took differently in the first step's forward are printed with
   their margins, the causally first (the earliest moe layer) first.
   Prints the median step ms, tokens/s, capture ms, peak memory, a profiled
   captured step's kernels, and an eager step's device time split into the
   expert ``bmm``s, the flash kernels and the rest. (b) the default
   ladder's ``lean`` rung (bf16 parameters, adam's f32 moments, microbatch
   4), captured: flash launches 5 x 4 x 6 each, losses finite, their
   distance from (a)'s and the routing drift of bf16 parameters reported.
   (c) deepseek-v3 cut to its dense MLA layer and the MTP head (3.12B
   params, f32; one of its MoE layers alone is 11.3B), eager and captured,
   losses within LOSS_RTOL; the batch is 4 x 512 unless the reckoned peak
   (``activation_gb``) passes 75 GB, then 2 x 512.

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
``{"rmsnorm": ...}``, ``{"planner": ...}``, ``{"cotenancy": ...}``,
``{"fl": ...}``, ``{"serve_sampled": ...}``, ``{"dense": ...}``,
``{"obs": ...}``, ``{"deepseek": ...}``, ``{"moe_train": ...}`` and
``{"kernels": [...]}`` (all ten kernels, with phase 19's to 23's launches
on those they run and phase 20's, 22's and 23's checks at nemotron-4-15b's
and deepseek-moe-16b's serve and train geometries appended to their
checks, then the five mixed-dtype decode entries with
their phase-17 and 21(d) launches, then the MLA latent decode's two
layouts with phase 22(a)'s checks and 22(b)'s launches), the
card's name and power limit as ``nvidia-smi`` gives them, and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
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


FWD_CHECKS = [(1, 32, 512, 64, torch.float32, False),  # B, H, S, hd, dtype, lowp
              (1, 32, 509, 64, torch.float32, False),
              (1, 32, 256, 64, torch.float32, False),
              (1, 32, 512, 64, torch.float32, True),
              (1, 32, 512, 64, torch.bfloat16, True),
              (1, 32, 509, 64, torch.bfloat16, True),
              (1, 32, 512, 64, torch.bfloat16, False),
              (1, 32, 509, 64, torch.bfloat16, False),
              (4, 32, 512, 64, torch.float32, False),   # the train step's
              (4, 32, 512, 64, torch.bfloat16, True),
              (4, 32, 512, 64, torch.bfloat16, False)]  # the lean rung's


def check_flash_fwd(fa, ref, cases=None):
    """Prefill attention: B=1, H=32, hd=64, causal, at S=512, a prime S near
    it and S=256 (inside the serve run's prompt range); then the train
    step's B=4, S=512. In its four modes: f32 without and with lowp (the
    FFMA kernel), bf16 with lowp and bf16 without it (the tensor-core
    kernel, p split into bf16 pairs: o within SPLIT_TOL of the plain
    version's f32 result beside its own rounding to bf16, lse within
    SPLIT_TOL). ``cases`` replaces ``FWD_CHECKS`` (phase 20: nemotron-4-15b's
    prefill). Each f32 check records the FFMA kernel's groups of warps a
    block, where the tree's wrapper has that plan."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for B, H, S, hd, dtype, lowp in cases or FWD_CHECKS:
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


BWD_CHECKS = [(4, 32, 512, 512, 64, True, torch.float32, False),  # B, H, Sq, Sk, hd,
              (2, 32, 512, 512, 64, True, torch.float32, False),  # causal, dtype, lowp
              (4, 32, 512, 512, 64, True, torch.bfloat16, True),
              (4, 32, 512, 512, 64, True, torch.bfloat16, False),
              (2, 32, 300, 373, 64, False, torch.float32, False)]


def check_flash_bwd(fb, ref, cases=None):
    """The two backward kernels at the train step's shape, B=4, H=32, S=512,
    hd=64, causal, in their three modes: f32 (FFMA), bf16 with lowp and
    bf16 without it (tensor cores, p and ds split into bf16 pairs, held to
    SPLIT_TOL); in f32 at the ``accum`` rung's microbatch, B=2; then a
    ragged case, Sq=300 against Sk=373, full attention. ``cases`` replaces
    ``BWD_CHECKS`` (phase 23: deepseek-moe-16b's train geometry).
    Both kernels get the same o, lse and delta as their plain versions. The
    library yardstick is one ``torch.autograd.grad`` through SDPA (dq, dk
    and dv together; its forward runs before the timing)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(3)
    dq_checks, dkv_checks = [], []
    for B, H, Sq, Sk, hd, causal, dtype, lowp in cases or BWD_CHECKS:
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
                 flops, lowp, err_fn=max_err, **extra):
    """One kernel-vs-plain comparison with its times and bound (``err_fn``:
    ``max_err_bf16_out`` for a bf16 result held to the plain version's f32
    one)."""
    err, ok = err_fn(got, want, tol)
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


def engine_args(engine_kw) -> dict:
    """The engine's keyword arguments: SERVE's slots and positions unless
    ``engine_kw`` sets ``max_batch`` / ``max_seq`` (phase 20)."""
    return dict(dict(max_batch=SERVE["slots"], max_seq=SERVE["max_seq"]), **engine_kw)


def run_engine(serve, model, params, reqs, **engine_kw):
    engine = serve.ContinuousBatchingEngine(model, params, **engine_args(engine_kw))
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
    engine = serve.ContinuousBatchingEngine(model, params, **engine_args(engine_kw))
    for r in reqs[:engine.max_batch]:
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
    ``cache_dtype`` cache), and one unit in the last place of the logits'
    dtype at the top logit: (margin, unit)."""
    logits, pcache = model.prefill(params, {"tokens": torch.as_tensor(
        prompt, device="cuda")[None]})
    cache = model.init_cache(1, SERVE["max_seq"], cache_dtype)
    for name in cache:
        cache[name][:, :, :len(prompt)] = pcache[name]
    for i in range(index):
        tok = torch.tensor([[tokens[i]]], dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, len(prompt) + i)
    top = logits[0, -1].float().topk(2).values
    _, e = torch.frexp(top[0].abs())  # |top| in [2^(e-1), 2^e)
    unit = torch.finfo(logits.dtype).eps * 2.0 ** (int(e) - 1)
    return float(top[0] - top[1]), unit


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


def same_streams(label, got, want, naive, params, reqs, cache_dtype=torch.float32,
                 divergences=None):
    """Phase 5's rule: streams token-identical, or diverging only where the
    plain path's top-2 logit margin (over a ``cache_dtype`` cache) is below
    LOGIT_TOL, or, where the logits are bf16 (bf16 weights, phase 20), at
    most one bf16 unit of the top logit: the logits' own resolution, which
    at |logit| >= 0.25 is above LOGIT_TOL (f32 logits resolve far below it,
    so there the rule is LOGIT_TOL alone). Appends each divergence to
    ``divergences``. Returns the number of identical streams."""
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
        margin, unit = top2_margin(naive, params, by_uid[u].prompt, b, i, cache_dtype)
        print(f"[{label}] uid {u} diverges at token {i}: {a[i]} vs {b[i]}, "
              f"plain top-2 margin {margin:.3g} (tolerance {LOGIT_TOL}, or one "
              f"unit of the logits' dtype at the top logit: {unit:.3g})")
        if divergences is not None:
            divergences.append({"uid": u, "index": i, "got": int(a[i]),
                                "plain": int(b[i]), "margin": margin, "unit": unit})
        check(margin < LOGIT_TOL or margin <= unit, f"{label}: uid {u} diverges "
              f"where the margin is {margin}")
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
    [(ms, calls, kernel name)] of the kernels with the most device time,
    {CPU op: the device ms of the kernels it launched}; an eager step's
    ops: a replay runs none)."""
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
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.self_device_time_total / 1e3, e.count, e.key)
           for e in sorted(events, key=lambda e: -e.self_device_time_total)]
    ops = {e.key: e.device_time_total / 1e3 for e in averages
           if e.device_type == DeviceType.CPU}
    return host_ms, dev_ms, top, ops


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
                host_ms, dev_ms, top, _ = profile_train_step(fn, res.state, batch_fn(steps))
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
        host_ms, dev_ms, top, _ = profile_train_step(fn, res.state, batch_fn(adaptive_steps))
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
            host_ms, dev_ms, top, _ = profile_train_step(step_fn, res.state, first)
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



# ---------------------------------------------------------------------------
# phase 18: federated learning
# ---------------------------------------------------------------------------

# benchmarks/table4_fl.py's real FedAvg cohort (run_real), at ResNet34's
# published widths
FL = dict(arch="resnet34", clients=8, rounds=6, local_steps=4, batch=16, lr=0.05,
          seed=0)
FL_AGG_TOL = 1e-6  # fedavg on the card against a float64 host mean, of each leaf's max
# launch/fleet.py's documented usage; run with and without a coordinator crash
FLEET_ARGV = ["--clients", "480", "--rounds", "6", "--per-round", "20",
              "--churn", "0.1", "--heavy-churn", "4:0.35", "--drop", "0.05",
              "--dup", "0.05", "--corrupt", "0.05", "--quiet"]
FLEET_CRASH_ROUND = 2


def fl_phase(device="cuda", cfg=None):
    """Phase 18: (a) ``fl.real.run_real`` at full width, captured then eager,
    each captured round's fedavg held to a float64 host mean; (b)
    ``launch.fleet.main`` with and without a coordinator crash. Returns the
    fl JSON object. ``device`` and ``cfg`` (a cut) are for rehearsing the
    control flow on the CPU."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.engine.chaos import FLEET_KINDS
    from repro_torch.fl.real import run_real
    from repro_torch.kernels import depthwise_conv, flash_attention, flash_backward, rmsnorm
    from repro_torch.launch import fleet
    from repro_torch.tree import tree_leaves

    on_card = torch.device(device).type == "cuda"
    cfg = cfg or get_config(FL["arch"])
    counters = (flash_attention.launches, flash_attention.mixed_launches,
                flash_backward.launches, depthwise_conv.launches, rmsnorm.launches)
    agg_err = []

    def host_mean(rnd, glob, deltas, new):
        worst = 0.0
        for g, n, *ds in zip(*(tree_leaves(t) for t in [glob, new] + deltas)):
            want = g.double().cpu().numpy() + np.mean(
                np.stack([d.double().cpu().numpy() for d in ds]), 0)
            err = np.abs(n.double().cpu().numpy() - want).max()
            worst = max(worst, float(err / max(np.abs(want).max(), 1e-30)))
        agg_err.append(worst)

    # -- (a) the real FedAvg cohort, captured then eager -----------------------
    # cuDNN's default conv backward algorithms sum with atomics, so two runs
    # of the cohort differ run to run, and 192 sgd steps amplify it (about 1%
    # by the last round). The first run keeps the default (its times are the
    # ones a caller gets); the comparison of captured with eager runs on
    # deterministic algorithms, where the same steps give the same bits.
    kw = dict(n_clients=FL["clients"], rounds=FL["rounds"], local_steps=FL["local_steps"],
              batch=FL["batch"], lr=FL["lr"], seed=FL["seed"], device=device)
    out = {"config": dict(FL, reduced=cfg != get_config(FL["arch"]))}
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for mode, jit, det in (("captured", True, False),
                               ("captured_deterministic", True, True),
                               ("eager_deterministic", False, True)):
            torch.backends.cudnn.deterministic = det
            for counts in counters:
                for k in counts:
                    counts[k] = 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = run_real(cfg, jit=jit, on_aggregate=host_mean if mode == "captured" else None,
                           **kw)
            wall = time.perf_counter() - t0
            launched = {k: n for counts in counters for k, n in counts.items() if n}
            check(all(np.isfinite(res.losses)), f"fl {mode}: losses {res.losses}")
            check(res.captures == (1 if jit and on_card else 0),  # eager on the CPU
                  f"fl {mode}: {res.captures} captures for {len(res.step_s)} local steps")
            steady = res.step_s[2:] if jit else res.step_s[1:]  # warmup, capture
            med = statistics.median(steady)
            n_params = sum(p.numel() for p in tree_leaves(res.params))
            # fedavg reads the global and each delta once and writes the new global
            agg_bound = (FL["clients"] + 2) * 4 * n_params / HBM_BYTES_PER_S * 1e3
            runs[mode] = {
                "losses": res.losses, "last_below_first": res.losses[-1] < res.losses[0],
                "captures": res.captures, "local_steps": len(res.step_s),
                "cudnn_deterministic": det,
                "median_step_ms": 1e3 * med, "images_per_s": FL["batch"] / med,
                "fedavg_ms": [1e3 * s for s in res.agg_s],
                "fedavg_median_ms": 1e3 * statistics.median(res.agg_s),
                "fedavg_bound_ms": agg_bound, "params": n_params, "wall_s": wall,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                "launches": launched}
            r = runs[mode]
            print(f"[fl] real FedAvg {mode}: {cfg.name} ({n_params} parameters), "
                  f"{FL['clients']} clients x {FL['rounds']} rounds x {FL['local_steps']} "
                  f"local steps, batch {FL['batch']}: round losses "
                  f"{[round(x, 4) for x in res.losses]} (last below first: "
                  f"{r['last_below_first']}); median local step {r['median_step_ms']:.2f} ms "
                  f"= {r['images_per_s']:.0f} images/s; fedavg {r['fedavg_median_ms']:.2f} "
                  f"ms a round (bytes bound {agg_bound:.3f} ms); captures {res.captures}; "
                  f"peak memory {r['peak_memory_gb'] or 0:.2f} GB; kernel launches "
                  f"{launched}; {wall:.1f} s", flush=True)
            del res
            if on_card:
                free_cuda()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def rel_diff(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(runs[a]["losses"], runs[b]["losses"]))

    rel = rel_diff("captured_deterministic", "eager_deterministic")
    spread = rel_diff("captured", "captured_deterministic")
    check(rel <= LOSS_RTOL, f"fl: captured vs eager round losses differ by {rel:.3g}")
    check(len(agg_err) == FL["rounds"] and max(agg_err) <= FL_AGG_TOL,
          f"fl: fedavg against the float64 host mean: {agg_err}")
    print(f"[fl] captured vs eager round losses (deterministic cuDNN): max relative "
          f"difference {rel:.3g}; the default algorithms against them {spread:.3g} "
          f"(reported); fedavg against a float64 host mean, worst leaf per round "
          f"{[f'{e:.3g}' for e in agg_err]}", flush=True)
    out.update(runs, captured_vs_eager_loss_rel_diff=rel,
               default_vs_deterministic_loss_rel_diff=spread, fedavg_host_rel_err=agg_err)

    # -- (b) the fleet CLI with and without a coordinator crash ------------------
    fl_fleet = {}
    with tempfile.TemporaryDirectory() as d:
        for label, extra in (("crash", ["--crash-round", str(FLEET_CRASH_ROUND)]),
                             ("clean", [])):
            path = f"{d}/{label}.json"
            t0 = time.perf_counter()
            res = fleet.main(FLEET_ARGV + extra + ["--json-out", path])
            wall = time.perf_counter() - t0
            with open(path) as f:
                payload = json.load(f)
            fl_fleet[label] = {"wall_s": wall, "agg_crc": [r.agg_crc for r in res.rounds],
                               "applied": payload["chaos"]["applied"],
                               "accepted": [r.accepted for r in res.rounds],
                               "slo_attainment": res.slo_attainment,
                               "goodput_samples_per_h": res.goodput_samples_per_h}
            print(f"[fl] fleet CLI ({label}): {wall:.2f} s wall, chaos applied "
                  f"{payload['chaos']['applied']}", flush=True)
    check(fl_fleet["crash"]["agg_crc"] == fl_fleet["clean"]["agg_crc"],
          f"fleet: the crash-resumed aggregates {fl_fleet['crash']['agg_crc']} differ "
          f"from the crash-free run's {fl_fleet['clean']['agg_crc']}")
    missing = set(FLEET_KINDS) - set(fl_fleet["crash"]["applied"])
    check(not missing, f"fleet: fault classes never applied: {sorted(missing)}")
    out["fleet"] = dict(fl_fleet, argv=FLEET_ARGV, crash_round=FLEET_CRASH_ROUND)
    return out


# ---------------------------------------------------------------------------
# phase 19: sampled serving
# ---------------------------------------------------------------------------

# benchmarks/spec_bench.py:123's sampling settings, seed 1
SAMPLE = dict(temperature=0.9, top_k=32, sample_seed=1)
# a sampled ModelDraft over the full vocabulary, for a target sampling the
# same way; its draft is the full width cut to DRAFT_LAYERS
MODEL_DRAFT = dict(temperature=1.0, top_k=0, sample_seed=1, requests=8, gen=16,
                   layers=2)
# the stream rule: two sampled streams of a request are equal up to their
# first difference, where the held run's decision lay this near a tie
NEAR_TIE = 1e-4


def _top2(x):
    """The margin between the two largest values of each row (inf where the
    second is -inf: no tie is possible)."""
    v = torch.topk(x, 2, dim=-1).values
    return torch.where(torch.isinf(v[..., 1]), torch.full_like(v[..., 0], float("inf")),
                       v[..., 0] - v[..., 1])


def verify_margins(prng, sampling, logits, drafts, draft_probs, keys, temperature,
                   top_k):
    """(B, S) margin of ``rejection_verify``'s decisions at each window
    position: the accept test's |u·p(d) − q(d)| (positions < S-1) and the
    resample's perturbed top-2 margin, the smaller of the two."""
    q = sampling.sample_probs(logits, temperature, top_k)
    B, S, V = q.shape
    u = prng.uniform(prng.fold_in(keys, 0))
    out = torch.full((B, S), float("inf"), device=q.device)
    fb = q
    if S > 1:
        d = drafts.long()
        qd = torch.gather(q[:, :-1], -1, d[..., None])[..., 0]
        if draft_probs is None:
            pd = torch.ones_like(qd)
            resid = torch.clamp_min(
                q[:, :-1] - torch.nn.functional.one_hot(d, V) * qd[..., None], 0)
        else:
            p = draft_probs.float()
            pd = torch.gather(p, -1, d[..., None])[..., 0]
            resid = torch.clamp_min(q[:, :-1] - p, 0)
        out[:, :-1] = (u[:, :-1] * pd - qd).abs()
        total = resid.sum(-1, keepdim=True)
        fb = torch.cat([torch.where(total > 0, resid / total.clamp_min(1e-30),
                                    q[:, :-1]), q[:, -1:]], 1)
    lg = torch.where(fb > 0, torch.log(fb), float("-inf"))
    return torch.minimum(out, _top2(lg + prng.gumbel(prng.fold_in(keys, 1), (V,))))


def recorded_margins(serve, run):
    """``run()`` with the engine's sampler and verifier wrapped so that every
    decision records its margin by stream key (an eager engine, built inside
    ``run``: a captured graph would replay without the wrappers). Returns
    (what ``run`` returned, {key: the smallest margin met under it})."""
    from repro_torch import prng
    from repro_torch.launch import sampling
    rec = []
    real_sampler, real_verify = serve.build_sampler, serve.rejection_verify

    def build_sampler(t, k):
        fn = real_sampler(t, k)

        def sample(logits, keys):
            lg = sampling.mask_logits(logits, t, k)
            rec.append((keys.clone(), _top2(lg + prng.gumbel(keys, (lg.shape[-1],)))))
            return fn(logits, keys)
        return sample

    def verify(logits, drafts, probs, keys, *, temperature, top_k=0):
        rec.append((keys.clone(), verify_margins(prng, sampling, logits, drafts, probs,
                                                 keys, temperature, top_k)))
        return real_verify(logits, drafts, probs, keys, temperature=temperature,
                           top_k=top_k)

    serve.build_sampler, serve.rejection_verify = build_sampler, verify
    try:
        out = run()
    finally:
        serve.build_sampler, serve.rejection_verify = real_sampler, real_verify
    margins = {}
    for keys, m in rec:
        for k, v in zip(keys.reshape(-1, 2).tolist(), m.reshape(-1).tolist()):
            margins[tuple(k)] = min(margins.get(tuple(k), float("inf")), v)
    return out, margins


def hold_sampled(label, got, want, seed, rerun):
    """The stream rule: ``got`` (the held run's streams) equals ``want`` but
    where, at a stream's first difference, the held run's decision lay within
    NEAR_TIE of a tie. ``rerun()`` repeats the held run eagerly with its
    margins recorded (``recorded_margins``), only where a stream differs, and
    must give ``got`` again. Returns (identical streams, flips)."""
    from repro_torch import prng
    check(sorted(got) == sorted(want), f"{label}: requests missing")
    diffs = []
    for u in sorted(want):
        a, b = got[u], want[u]
        if a != b:
            check(len(a) == len(b), f"{label}: uid {u} has {len(a)} tokens, not {len(b)}")
            diffs.append((u, next(j for j in range(len(a)) if a[j] != b[j])))
    flips = []
    if diffs:
        again, margins = rerun()
        check(again == got, f"{label}: the recorded eager rerun gave other streams")
        base = prng.PRNGKey(seed)
        for u, i in diffs:
            key = tuple(prng.fold_in(prng.fold_in(base, u), i).tolist())
            m = margins.get(key, float("inf"))
            print(f"[{label}] uid {u} flips at token {i}: {got[u][i]} vs {want[u][i]}, "
                  f"decision margin {m:.3g} (near tie below {NEAR_TIE})")
            check(m < NEAR_TIE, f"{label}: uid {u} flips where the margin is {m}")
            flips.append({"uid": u, "index": i, "margin": m})
    print(f"[{label}] {len(want) - len(diffs)}/{len(want)} streams token-identical "
          f"to the plain path's", flush=True)
    return len(want) - len(diffs), flips


def sampler_cost(serve, prng, V):
    """The sampler alone at the serve step's shape (8, V) under SAMPLE, on the
    card: its ms eagerly and as a captured graph (CUDA events, ``time_ms``;
    the eager figure holds launch gaps, the graph's is the device time a
    captured step spends on it), its kernels' device ms and launches from
    ``torch.profiler``, beside a greedy argmax of the same logits."""
    g = torch.Generator(device="cuda").manual_seed(19)
    logits = torch.randn(SERVE["slots"], V, generator=g, device="cuda") * 3
    keys = torch.as_tensor(prng.fold_in(prng.fold_in(prng.PRNGKey(1),
                                                     np.arange(SERVE["slots"])), 5),
                           device="cuda")
    sampler = serve.build_sampler(SAMPLE["temperature"], SAMPLE["top_k"])
    kern = device_kernels(lambda: sampler(logits, keys))
    graph = torch.cuda.CUDAGraph()  # as it runs inside a captured step
    with torch.cuda.graph(graph):
        sampler(logits, keys)
    out = {"shape": [SERVE["slots"], V], "sampler_ms": time_ms(lambda: sampler(logits, keys)),
           "sampler_graph_ms": time_ms(graph.replay),
           "sampler_kernel_ms": sum(ms for ms, _, _ in kern),
           "sampler_launches": sum(n for _, n, _ in kern),
           "argmax_ms": time_ms(lambda: logits.argmax(-1))}
    del graph
    print(f"[sampled] sampler at ({SERVE['slots']}, {V}): {out['sampler_ms']:.4f} ms eager, "
          f"{out['sampler_graph_ms']:.4f} ms as a graph (CUDA events), "
          f"{out['sampler_kernel_ms']:.4f} ms in {out['sampler_launches']} kernels "
          f"(profiler); greedy argmax {out['argmax_ms']:.4f} ms", flush=True)
    return out


def prng_on_the_card(prng, sampling, V):
    """Phase 19(e): (8, V) random bits, uniforms and Gumbel noise on the card
    against the CPU's from the same keys: bits and uniforms equal, Gumbel
    within 1e-6; the sampler's draws equal but at a near tie."""
    keys = torch.as_tensor(prng.fold_in(prng.fold_in(prng.PRNGKey(3), np.arange(8)),
                                        np.arange(8) * 7))
    kc = keys.cuda()
    bits_equal = torch.equal(prng.random_bits(kc, (V,)).cpu(), prng.random_bits(keys, (V,)))
    uni_equal = torch.equal(prng.uniform(kc, (V,)).cpu(), prng.uniform(keys, (V,)))
    gc_, gh = prng.gumbel(kc, (V,)).cpu(), prng.gumbel(keys, (V,))
    gerr, gok = max_err(gc_, gh, dict(rtol=1e-6, atol=1e-6))
    logits = torch.randn(8, V, generator=torch.Generator().manual_seed(5)) * 3
    lg = sampling.mask_logits(logits, SAMPLE["temperature"], SAMPLE["top_k"])
    dc = prng.categorical(kc, lg.cuda()).cpu()
    dh = prng.categorical(keys, lg)
    margin = _top2(lg + gh)
    draws_ok = bool(((dc == dh) | (margin < NEAR_TIE)).all())
    out = {"shape": [8, V], "bits_equal": bits_equal, "uniform_equal": uni_equal,
           "gumbel_max_abs_err": gerr, "draws_equal": int((dc == dh).sum())}
    print(f"[sampled] prng on the card (8, {V}): bits equal {bits_equal}, uniforms equal "
          f"{uni_equal}, Gumbel max |err| {gerr:.3g}, draws equal "
          f"{out['draws_equal']}/8", flush=True)
    check(bits_equal and uni_equal and gok and draws_ok,
          f"prng on the card differs from the CPU's: {out}")
    return out


def sampled_phase(fa, serve, build_model, cfg, reqs, greedy_streams=None):
    """Phase 19: sampled serving (``temperature > 0``) on every serving path,
    held to the plain path under the stream rule. ``greedy_streams``: phase
    4's (computed here, captured, where None). Returns (the JSON object, each
    path's launch counts)."""
    from repro_torch import prng
    from repro_torch.launch import sampling
    from repro_torch.spec.draft import ModelDraft
    seed = SAMPLE["sample_seed"]
    launches, out = {}, {}

    def count(path, run):
        fa.reset_launches()
        res = run()
        launches[path] = fa.all_launches()
        return res

    def rerun(model, params, rs, **kw):
        """The held path's eager rerun with its margins recorded."""
        def run():
            done, _, _ = run_engine(serve, model, params, rs, jit=False, **kw)
            return streams_of(done)
        return lambda: recorded_margins(serve, run)

    # -- (a) contiguous, 16 layers ----------------------------------------------
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    naive = build_model(cfg, impl="naive", device="cuda")
    print(f"[sampled] {cfg.name}: {cfg.n_layers} layers, {SAMPLE}", flush=True)
    if greedy_streams is None:
        greedy_streams = streams_of(run_engine(serve, model, params, reqs)[0])
    (done, engine, wall, counts), compiled = compiled_vs_eager(
        fa, serve, model, params, reqs, "sampled", order=(False, True, True), **SAMPLE)
    launches["sampled"] = counts
    check(counts["flash_fwd"] > 0 and counts["flash_decode"] > 0,
          f"the sampled run did not go through both kernels: {counts}")
    streams = streams_of(done)
    for u, f in done.items():
        check(len(f.tokens) == SERVE["gen"] and all(0 <= t < cfg.vocab_size for t in f.tokens),
              f"sampled request {u}: {len(f.tokens)} tokens")
    check(streams != greedy_streams, "the sampled streams are the greedy ones")
    solo = serve.ContinuousBatchingEngine(model, params, max_batch=1,
                                          max_seq=SERVE["max_seq"], **SAMPLE)
    r0 = reqs[0]
    solo_tokens = solo.run([serve.Request(uid=r0.uid, prompt=r0.prompt,
                                          max_new_tokens=r0.max_new_tokens)])[r0.uid].tokens
    check(solo_tokens == streams[r0.uid], "uid 0 alone in a 1-slot engine gave another stream")
    done_n, eng_n, wall_n = run_engine(serve, naive, params, reqs, **SAMPLE)
    ident, flips = hold_sampled("sampled", streams, streams_of(done_n), seed,
                                rerun(model, params, reqs, **SAMPLE))
    prof = profile_decode(serve, model, params, reqs, label=", sampled", **SAMPLE)
    cost = sampler_cost(serve, prng, cfg.vocab_size)
    out["contig"] = {
        "n_layers": cfg.n_layers, "tok_s": engine.tokens_out / wall, "wall_s": wall,
        "tokens": engine.tokens_out, "decode_steps": engine.decode_steps,
        "naive_tok_s": eng_n.tokens_out / wall_n, "identical_streams": ident,
        "flips": flips, "solo_equals_batched": True, "compiled": compiled,
        "decode_step_host_ms": prof[0], "decode_step_device_ms": prof[1],
        "decode_step_flash_decode_ms": prof[2], "sampler": cost,
        "launches": counts}
    print(f"[sampled] pallas, captured: {engine.tokens_out / wall:.1f} tok/s; naive "
          f"{eng_n.tokens_out / wall_n:.1f} tok/s; a captured sampled step: host "
          f"{prof[0]:.3f} ms, device {prof[1]:.3f} ms", flush=True)

    # -- (b) top-k 1 is greedy -------------------------------------------------
    done_b, eng_b, wall_b = count("sampled_topk1", lambda: run_engine(
        serve, model, params, reqs, temperature=5.0, top_k=1, sample_seed=seed))
    check(streams_of(done_b) == greedy_streams,
          "temperature 5, top-k 1 did not give phase 4's greedy streams")
    out["topk1_equals_greedy"] = True
    print(f"[sampled] temperature 5.0, top-k 1: phase 4's greedy streams exactly "
          f"({eng_b.tokens_out / wall_b:.1f} tok/s)", flush=True)
    del model, naive, params, engine, eng_n, done, done_n, solo
    free_cuda()

    # -- (c) paged, swap and speculative, 8 layers ------------------------------
    cfg8 = dataclasses.replace(cfg, n_layers=PAGED["layers"])
    model = build_model(cfg8, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    naive = build_model(cfg8, impl="naive", device="cuda")
    shared = shared_prefix_requests(serve, reqs)
    paged_kw = dict(kv_layout="paged", block_size=PAGED["block_size"])
    bs = PAGED["block_size"]
    worst = sorted(-(-min(len(r.prompt) + r.max_new_tokens, SERVE["max_seq"]) // bs)
                   for r in shared)
    paths = [("sampled_paged", shared, paged_kw, "flash_decode_paged"),
             ("sampled_swap", shared, dict(paged_kw, admission_policy="swap",
                                           num_blocks=sum(worst[-SERVE["slots"]:]) // 2 + 1),
              "flash_decode_paged"),
             ("sampled_spec_contig", reqs, dict(draft_depth=PAGED["draft_depth"]),
              "flash_decode_spec"),
             ("sampled_spec_paged", reqs, dict(paged_kw, draft_depth=PAGED["draft_depth"]),
              "flash_decode_spec_paged")]
    for path, rs, kw, kname in paths:
        kw = dict(kw, **SAMPLE)
        d, e, w = count(path, lambda: run_engine(serve, model, params, rs, **kw))
        check(launches[path][kname] > 0, f"{path} did not launch {kname}")
        dn, en, wn = run_engine(serve, naive, params, rs, **kw)
        ident, flips = hold_sampled(path, streams_of(d), streams_of(dn), seed,
                                    rerun(model, params, rs, **kw))
        st = e.stats()
        res = {"tok_s": e.tokens_out / w, "wall_s": w, "tokens": e.tokens_out,
               "steps": e.decode_steps, "naive_tok_s": en.tokens_out / wn,
               "identical_streams": ident, "flips": flips, "launches": launches[path]}
        if "spec_rounds" in st:
            res.update(spec_rounds=st["spec_rounds"], spec_drafted=st["spec_drafted"],
                       spec_accepted=st["spec_accepted"], acceptance=st["spec_acceptance"])
        if path == "sampled_swap":
            check(st["swap_outs"] > 0 and st["swap_ins"] == st["swap_outs"],
                  f"sampled swap counts: {st}")
            res.update(swap_outs=st["swap_outs"], num_blocks=kw["num_blocks"])
        if path == "sampled_paged":
            check(st["prefill_chunks_skipped"] > 0 and st["cow_copies"] >= 1,
                  f"sampled paged: no prefix hit or no copy-on-write: {st}")
        out[path] = res
        print(f"[{path}] {res['tok_s']:.1f} tok/s (naive {res['naive_tok_s']:.1f}), "
              f"{e.decode_steps} steps"
              + (f", acceptance {st['spec_accepted']}/{st['spec_drafted']} = "
                 f"{st['spec_acceptance']:.4f}" if "spec_rounds" in st else ""), flush=True)
        del d, e, dn, en

    # -- (d) a sampled ModelDraft over the full vocabulary ------------------------
    md = MODEL_DRAFT
    dcfg = dataclasses.replace(cfg, n_layers=md["layers"])
    kw = dict(temperature=md["temperature"], top_k=md["top_k"],
              sample_seed=md["sample_seed"], draft_depth=PAGED["draft_depth"])
    rs = [serve.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=md["gen"])
          for r in reqs[:md["requests"]]]

    def draft_run(impl, m, jit=True):
        dm = build_model(dcfg, impl=impl, device="cuda")
        draft = ModelDraft(dm, dm.init(dm.generator(0)), max_batch=SERVE["slots"],
                           max_seq=SERVE["max_seq"], temperature=md["temperature"],
                           top_k=md["top_k"], seed=md["sample_seed"])
        return run_engine(serve, m, params, rs, draft_source=draft, jit=jit, **kw)

    def draft_rerun():
        return recorded_margins(serve, lambda: streams_of(draft_run("pallas", model,
                                                                    jit=False)[0]))

    d, e, w = count("sampled_model_draft", lambda: draft_run("pallas", model))
    check(launches["sampled_model_draft"]["flash_decode_spec"] > 0,
          "the ModelDraft run did not launch flash_decode_spec")
    dn, en, wn = draft_run("naive", naive)
    ident, flips = hold_sampled("sampled_model_draft", streams_of(d), streams_of(dn),
                                md["sample_seed"], draft_rerun)
    st = e.stats()
    out["model_draft"] = {
        "draft_layers": md["layers"], "target_layers": cfg8.n_layers,
        "requests": len(rs), "gen": md["gen"], "tok_s": e.tokens_out / w, "wall_s": w,
        "naive_tok_s": en.tokens_out / wn, "spec_rounds": st["spec_rounds"],
        "spec_drafted": st["spec_drafted"], "spec_accepted": st["spec_accepted"],
        "acceptance": st["spec_acceptance"], "identical_streams": ident, "flips": flips,
        "launches": launches["sampled_model_draft"]}
    print(f"[sampled_model_draft] {md['layers']}-layer draft, full vocabulary: "
          f"{out['model_draft']['tok_s']:.1f} tok/s (naive "
          f"{out['model_draft']['naive_tok_s']:.1f}), acceptance "
          f"{st['spec_accepted']}/{st['spec_drafted']} = {st['spec_acceptance']:.4f}",
          flush=True)
    del model, naive, params, d, e, dn, en
    free_cuda()

    # -- (e) the PRNG on the card ------------------------------------------------
    out["prng"] = prng_on_the_card(prng, sampling, cfg.vocab_size)
    out["settings"] = dict(SAMPLE)
    return out, launches


# ---------------------------------------------------------------------------
# phase 20: the dense family at full width
# ---------------------------------------------------------------------------

DENSE_SERVE = dict(arch="nemotron-4-15b", slots=4, requests=8, prompt_lo=192,
                   prompt_hi=320, gen=16, max_seq=512, seed=0)
DENSE_TRAIN = dict(arch="granite-3-2b", batch=4, seq=512, steps=4, lr=3e-4, seed=0)
REMATS = ("none", "dots", "full")


def dense_requests(serve, vocab):
    rng = np.random.default_rng(DENSE_SERVE["seed"])
    return [serve.Request(uid=u, prompt=rng.integers(0, vocab, int(rng.integers(
        DENSE_SERVE["prompt_lo"], DENSE_SERVE["prompt_hi"] + 1))).astype(np.int32),
        max_new_tokens=DENSE_SERVE["gen"]) for u in range(DENSE_SERVE["requests"])]


def check_dense_kernels(fa, ref, gather, cfg):
    """The attention kernels at nemotron-4-15b's geometry (and, in phase 22,
    at deepseek-moe-16b's: K 16, G 1), in the serve path's mode (bf16 q and
    cache, dots in f32: no lowp) and in f32: the
    prefill forward over H = 48 heads of hd 128 (S = 320, the longest
    prompt), then the three decode kernels at B = 4 slots, K = 8, G = 6
    (a KV head's second row group of 4 half full), over 512 positions (32
    blocks of 16), at lengths 0, 193, 320 and 512; the verify at S = 5
    (draft depth 4: S*G = 30 rows, two row blocks of 24). A bf16 result is
    held to the plain version's f32 result on the same bf16 values beside
    half a bf16 unit. Returns {kernel: [checks]}."""
    import torch.nn.functional as F
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    out = {"flash_fwd": check_flash_fwd(fa, ref, cases=[
        (1, cfg.n_heads, DENSE_SERVE["prompt_hi"], hd, torch.bfloat16, False)])}
    B, bs, S = DENSE_SERVE["slots"], PAGED["block_size"], PAGED["draft_depth"] + 1
    cap = DENSE_SERVE["max_seq"]
    T = cap // bs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(20)
    for name in ("flash_decode", "flash_decode_paged", "flash_decode_spec"):
        out[name] = []
        spec, paged = "spec" in name, "paged" in name
        lens_list = [0, 193, 320, cap - S if spec else cap]
        lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            qshape = (B, K, S, G, hd) if spec else (B, K, G, hd)
            q = torch.randn(*qshape, generator=g, device="cuda").to(dtype)
            if paged:  # a shuffled table over B*T + 1 blocks, one entry past it
                kp, vp = (torch.randn(B * T + 1, bs, K, hd, generator=g,
                                      device="cuda").to(dtype) for _ in range(2))
                table = (torch.randperm(B * T, generator=g, device="cuda") + 1
                         ).reshape(B, T).to(torch.int32)
                table[1, 3] = 2 * B * T
                args = (q, kp, vp, table, lengths)
                plan = fa.decode_paged_plan(T, bs, B * K * -(-G // fa.DECODE_ROWS), sms)
            else:
                kc, vc = (torch.randn(B, cap, K, hd, generator=g, device="cuda").to(dtype)
                          for _ in range(2))
                args = (q, kc, vc, lengths)
                plan = (fa.spec_plan(B, K, S * G, cap // 64, 64, sms) if spec else
                        fa.decode_plan(cap, B * K * -(-G // fa.DECODE_ROWS), sms))
            kernel, plain = getattr(fa, name), getattr(ref, "ref_" + name)
            got = kernel(*args, lowp=False)
            want = plain(*(a.float() if a.is_floating_point() else a for a in args))
            torch.cuda.synchronize()
            rows = S if spec else 1
            qh = (q.permute(0, 1, 3, 2, 4) if spec else q[:, :, :, None]
                  ).reshape(B, K * G, rows, hd)
            limit = (lengths[:, None].long() + (torch.arange(S, device="cuda") + 1
                                                if spec else 0)).clamp(max=cap)
            mask = (torch.arange(cap, device="cuda")[None, None, :]
                    < limit.reshape(B, -1)[:, :, None])[:, None]

            def library():  # (gather, then) one SDPA call with GQA and a mask
                kh = (gather(kp, table) if paged else kc).transpose(1, 2)
                vh = (gather(vp, table) if paged else vc).transpose(1, 2)
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      enable_gqa=True)
            elt = q.element_size()
            live = sum(min(n + (S if spec else 0), cap) for n in lens_list)
            pairs = int(limit.sum()) * K * G
            nbytes = live * K * 2 * hd * elt + 2 * q.numel() * elt + B * 4 \
                + (B * T * 4 if paged else 0)
            bf16 = dtype == torch.bfloat16
            out[name].append(kernel_check(
                f"{name} ({cfg.name}, plan {plan[:2]})", got, want,
                F32_TOL, err_fn=max_err_bf16_out if bf16 else max_err,
                shape=list(qshape) + ([bs, T] if paged else [cap]), lengths=lens_list,
                plan=list(plan[:2]), dtype=str(dtype).replace("torch.", ""),
                ms=time_ms(lambda: kernel(*args, lowp=False)),
                plain_ms=time_ms(lambda: plain(*args, lowp=False)),
                library_ms=time_ms(library),
                library_calls="gather + SDPA, two calls" if paged else "SDPA, one call",
                nbytes=nbytes, flops=pairs * 4 * hd, lowp=False))
    return out


def dense_serve_phase(fa, serve, build_model, cfg):
    """Phase 20(a): nemotron-4-15b at full width in bf16 (weights and KV
    cache) through ``ContinuousBatchingEngine(attn_impl="pallas")``,
    captured: 4 slots, 8 requests of 192-320 prompt tokens and 16 greedy
    tokens, max_seq 512; contiguous, paged (blocks of 16, half the requests
    sharing a 128-token prefix) and speculative (n-gram, depth 4). Each
    path's streams held to the same requests through the plain path under
    phase 5's rule (``same_streams``), every divergence's margin recorded.
    Returns (the JSON object, each path's launch counts)."""
    bf = torch.bfloat16
    model = build_model(cfg, impl="pallas", param_dtype=bf, device="cuda")
    naive = build_model(cfg, impl="naive", param_dtype=bf, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(model.generator(DENSE_SERVE["seed"]))
    weights_gb = sum(p.numel() * p.element_size()
                     for p in _leaves(params)) / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reqs = dense_requests(serve, cfg.vocab_size)
    print(f"[dense] serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads (G {cfg.n_heads // cfg.n_kv_heads}), "
          f"hd {cfg.head_dim}, vocab {cfg.vocab_size} untied, {cfg.norm}, "
          f"{cfg.activation}; {cfg.param_count() / 1e9:.3f}B params, bf16 weights "
          f"{weights_gb:.2f} GB (init peak {init_peak_gb:.2f} GB); prompts "
          f"{[len(r.prompt) for r in reqs]}", flush=True)
    with torch.inference_mode():  # small-input agreement of the two paths
        toks = torch.as_tensor(reqs[0].prompt[:64], device="cuda")[None]
        lk, _ = model.prefill(params, {"tokens": toks})
        ln, _ = naive.prefill(params, {"tokens": toks})
    check(lk.shape == (1, 1, cfg.vocab_size) and lk.dtype == bf
          and bool(torch.isfinite(lk).all()), f"prefill logits {tuple(lk.shape)}")
    prefill_diff = float((lk.float() - ln.float()).abs().max())
    print(f"[dense] prefill of 64 tokens: pallas vs naive max |dlogit| "
          f"{prefill_diff:.3g} (bf16 logits, top {float(lk.float().max()):.3g})",
          flush=True)
    kw = dict(max_batch=DENSE_SERVE["slots"], max_seq=DENSE_SERVE["max_seq"],
              cache_dtype=bf)
    run_engine(serve, model, params, reqs[:1], **kw)  # warm-up: cuBLAS, allocator
    paged_kw = dict(kv_layout="paged", block_size=PAGED["block_size"])
    paths = [("dense_serve", {}, "flash_decode"),
             ("dense_paged", paged_kw, "flash_decode_paged"),
             ("dense_spec", dict(draft_depth=PAGED["draft_depth"]), "flash_decode_spec")]
    out, launches = {}, {}
    for path, extra, kname in paths:
        rs = shared_prefix_requests(serve, reqs) if "kv_layout" in extra else reqs
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        done, engine, wall = run_engine(serve, model, params, rs, **kw, **extra)
        counts = launches[path] = fa.all_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = [engine._decode, engine._spec_decode]
        replays = sum(getattr(f, "replays", 0) for f in steps)
        check(counts[kname] > 0 and replays > 0,
              f"{path}: {kname} launched {counts[kname]} times, {replays} replays")
        if "kv_layout" not in extra:  # paged prefill runs plain chunked attention
            check(counts["flash_fwd"] > 0, f"{path}: no flash_fwd launch")
        check(engine.cache["k"].dtype == bf, f"{path}: cache not bf16")
        check(sorted(done) == [r.uid for r in rs], f"{path}: requests missing")
        check_tokens(path, engine, cfg.vocab_size)
        fa.reset_launches()
        done_n, engine_n, wall_n = run_engine(serve, naive, params, rs, **kw, **extra)
        check(not any(fa.all_launches().values()), f"{path}: the plain path launched")
        divergences = []
        ident = same_streams(path, streams_of(done), streams_of(done_n), naive, params,
                             rs, cache_dtype=bf, divergences=divergences)
        st = engine.stats()
        out[path] = {"tok_s": engine.tokens_out / wall, "wall_s": wall,
                     "naive_tok_s": engine_n.tokens_out / wall_n,
                     "tokens": engine.tokens_out, "decode_steps": engine.decode_steps,
                     "replays": replays, "peak_memory_gb": peak_gb,
                     "identical_streams": ident, "divergences": divergences,
                     "launches": counts}
        if path == "dense_paged":
            out[path].update(prefill_chunks_skipped=st["prefill_chunks_skipped"],
                             cow_copies=st["cow_copies"])
        if path == "dense_spec":
            out[path].update(acceptance=st["spec_acceptance"],
                             verify_passes=engine.decode_steps)
        print(f"[dense] {path}: {engine.tokens_out} tokens in {wall:.3f} s "
              f"({engine.tokens_out / wall:.1f} tok/s captured; plain path "
              f"{engine_n.tokens_out / wall_n:.1f}), {engine.decode_steps} steps, "
              f"{replays} replays, peak {peak_gb:.2f} GB, {ident}/{len(rs)} streams "
              f"identical to the plain path's, launches {counts}", flush=True)
        del done, engine, done_n, engine_n
    prof = profile_decode(serve, model, params, reqs, label=", nemotron bf16", **kw)
    out["decode_step"] = {"host_ms": prof[0], "device_ms": prof[1],
                          "flash_decode_ms": prof[2]}
    out.update(arch=cfg.name, params=cfg.param_count(), weights_gb=weights_gb,
               init_peak_gb=init_peak_gb, prefill_max_abs_dlogit=prefill_diff,
               **{k: DENSE_SERVE[k] for k in ("slots", "requests", "gen", "max_seq")})
    del model, naive, params, lk, ln
    free_cuda()
    return out, launches


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def remat_grads(build_model, cfg, batch, impl, remat):
    """Loss and gradients of ``batch`` from the seeded initial f32 params
    under ``remat``, eager autograd, and the device memory above the
    parameters (GB): what the forward keeps for the backward (the policy's
    saved activations), the forward's peak, and the peak of the backward."""
    model = build_model(cfg, impl=impl, remat=remat, device="cuda")
    params = model.init(model.generator(DENSE_TRAIN["seed"]))
    leaves = [p.requires_grad_() for p in _leaves(params)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = model.loss(params, batch)
    torch.cuda.synchronize()
    mem = {"kept": torch.cuda.memory_allocated() - base,
           "forward_peak": torch.cuda.max_memory_allocated() - base}
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    mem["backward_peak"] = torch.cuda.max_memory_allocated() - base
    out = float(loss.detach())
    del model, params, leaves, loss
    free_cuda()
    return out, grads, {k: v / 1e9 for k, v in mem.items()}


def rel_err(got, want) -> float:
    num = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (num / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def dense_train_phase(fa, build_model, cfg):
    """Phase 20(b): granite-3-2b at full width trained through
    ``TrainSession`` on the f32 ``full`` rung (adam, lr 3e-4, batch 4 x 512,
    4 steps, the step captured: eager, capture, two replays) under remat
    none, dots and full in turn, each policy's graphs freed before the next;
    then the bf16 ``lean`` rung under full. Returns (the JSON object, each
    run's launch counts)."""
    from repro_torch.engine.rungs import default_rung_ladder
    from repro_torch.engine.session import TrainSession
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import adam
    B, S, steps = DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], DENSE_TRAIN["steps"]
    batch_fn = make_batch_fn(cfg, B, S, seed=DENSE_TRAIN["seed"])
    print(f"[dense] train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"hd {cfg.head_dim}, vocab {cfg.vocab_size} tied; "
          f"{cfg.param_count() / 1e9:.3f}B params f32, adam lr {DENSE_TRAIN['lr']}, "
          f"batch {B} x {S}, {steps} steps a policy", flush=True)
    first = {k: torch.as_tensor(v, device="cuda") for k, v in batch_fn(0).items()}
    # first-step gradients: each policy against none, and under full the
    # kernels against the plain path (two gradient sets held at a time)
    loss0, grad_rel, grads_equal, grad_peak = {}, {}, {}, {}
    loss0["pallas/none"], none, grad_peak["none"] = remat_grads(
        build_model, cfg, first, "pallas", "none")
    for r in ("dots", "full"):
        loss0[f"pallas/{r}"], got, grad_peak[r] = remat_grads(
            build_model, cfg, first, "pallas", r)
        grad_rel[r] = rel_err(got, none)
        grads_equal[r] = all(torch.equal(a, b) for a, b in zip(got, none))
        if r == "dots":
            del got
    del none
    loss0["naive/full"], plain, _ = remat_grads(build_model, cfg, first, "naive", "full")
    grad_rel["naive/full"] = rel_err(got, plain)
    del got, plain
    free_cuda()
    print(f"[dense] device memory above the f32 params, none/dots/full (GB): kept "
          f"for the backward {[round(grad_peak[r]['kept'], 3) for r in REMATS]}, "
          f"the forward's peak {[round(grad_peak[r]['forward_peak'], 3) for r in REMATS]}"
          f", the backward's peak {[round(grad_peak[r]['backward_peak'], 3) for r in REMATS]}"
          f" ({cfg.param_count() * 4 / 1e9:.2f} GB of gradients, stacked per leaf "
          f"at its end)", flush=True)
    for key in ("kept", "forward_peak"):
        got = [grad_peak[r][key] for r in REMATS]
        check(got[0] > got[1] > got[2], f"{key} memory not none > dots > full: {got}")
    plain_loss_rel = abs(loss0["pallas/full"] - loss0["naive/full"]) / abs(loss0["naive/full"])
    print(f"[dense] first-step gradients: dots {grad_rel['dots']:.3g}, full "
          f"{grad_rel['full']:.3g} of none's (bitwise {grads_equal}); under full, "
          f"kernels vs plain path {grad_rel['naive/full']:.3g} (limit {GRAD_RTOL}), "
          f"losses {loss0}", flush=True)
    for r in ("dots", "full"):
        check(grad_rel[r] <= GRAD_RTOL, f"remat {r}: first-step gradients differ "
              f"from none's by {grad_rel[r]}")
    check(grad_rel["naive/full"] <= GRAD_RTOL and plain_loss_rel <= LOSS_RTOL,
          f"remat full: kernels vs plain path gradients {grad_rel['naive/full']}, "
          f"loss {plain_loss_rel}")

    full, *_, lean = default_rung_ladder(batch=B, attn_impl="pallas")
    runs, launches = {}, {}
    for label, rung in [(f"f32/{r}", dataclasses.replace(full, remat=r)) for r in REMATS] \
            + [("bf16/full", dataclasses.replace(lean, remat="full"))]:
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res, wall = run_session(TrainSession, [rung], cfg, batch_fn, steps,
                                optimizer=adam(), lr=DENSE_TRAIN["lr"], adaptive=False)
        counts = launches[label] = fa.all_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step = rung.jitted_step(cfg, adam(), lr=DENSE_TRAIN["lr"], device="cuda")
        ms = step_ms(res)
        runs[label] = {"losses": res.losses, "step_ms": ms,
                       "median_step_ms": statistics.median(ms[2:]),
                       "peak_memory_gb": peak_gb, "capture_ms": 1e3 * step.capture_s,
                       "captures": step.captures, "replays": step.replays,
                       "microbatch": rung.microbatch, "launches": counts}
        print(f"[dense] {rung.name} rung ({rung.param_dtype}, microbatch "
              f"{rung.microbatch}) remat {rung.remat}: losses "
              f"{[round(x, 6) for x in res.losses]}; step ms {[round(x, 1) for x in ms]}"
              f", median (replays) {runs[label]['median_step_ms']:.1f}; peak "
              f"{peak_gb:.2f} GB; capture {1e3 * step.capture_s:.1f} ms; launches "
              f"{counts}", flush=True)
        check(step.captures == 1 and step.replays == steps - 1,
              f"{label}: {step.captures} captures, {step.replays} replays")
        check(all(map(lambda x: x == x and abs(x) < 1e9, res.losses)),
              f"{label}: losses not finite {res.losses}")
        calls = cfg.n_layers * rung.microbatch * steps
        check(counts["flash_fwd"] == calls * (1 if rung.remat == "none" else 2)
              and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == calls,
              f"{label}: launches {counts}, {calls} expected a kernel (flash_fwd "
              f"twice under remat: the recomputed forward)")
        del res, step
        rung.invalidate()
        free_cuda()
    base = runs["f32/none"]["losses"]
    loss_rel = {r: max(abs(a - b) / abs(b) for a, b in zip(runs[f"f32/{r}"]["losses"], base))
                for r in ("dots", "full")}
    losses_equal = {r: runs[f"f32/{r}"]["losses"] == base for r in ("dots", "full")}
    step_peaks = [runs[f"f32/{r}"]["peak_memory_gb"] for r in REMATS]
    print(f"[dense] losses against none: {loss_rel} (limit {LOSS_RTOL}; bitwise "
          f"{losses_equal}); a whole step's peak memory none/dots/full "
          f"{[round(p, 2) for p in step_peaks]} GB (the optimizer's update, after "
          f"the backward, sets it)", flush=True)
    for r in ("dots", "full"):
        check(loss_rel[r] <= LOSS_RTOL, f"remat {r}: losses differ by {loss_rel[r]}")
    return {"arch": cfg.name, "params": cfg.param_count(), **DENSE_TRAIN,
            "memory_gb": grad_peak, "step_peak_memory_gb": step_peaks,
            "first_step_grad_rel_err": grad_rel, "first_step_grads_bitwise": grads_equal,
            "first_step_losses": loss0, "plain_loss_rel_diff": plain_loss_rel,
            "loss_rel_diff_max": loss_rel, "losses_bitwise": losses_equal,
            "runs": runs}, launches


def release_device_memory() -> dict:
    """Free what earlier phases leave pinned on the card, and return the
    allocated and reserved GB before and after. Each stream that ran a
    cuBLAS product keeps a workspace, and one carved from a large cached
    segment keeps the whole segment reserved: before phase 20 on an H100
    80GB HBM3 at 700 W, 1.85 GB were allocated and 12.77 GB reserved with
    no tensor, graph, engine or rung reachable from Python, and
    granite-3-2b's capture then ran out of memory. No graph of an earlier
    phase is alive, so none reads a workspace freed here."""
    def gb():
        return [torch.cuda.memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9]
    free_cuda()
    before = gb()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    out = {"allocated_reserved_gb_before": before, "allocated_reserved_gb_after": gb()}
    print(f"[dense] device memory left by earlier phases (allocated, reserved GB): "
          f"{[round(x, 2) for x in before]}, after freeing cuBLAS workspaces "
          f"{[round(x, 2) for x in out['allocated_reserved_gb_after']]}", flush=True)
    return out


def dense_phase(fa, ref, serve, build_model, get_config, gather):
    """Phase 20: the kernels at nemotron-4-15b's geometry, nemotron-4-15b
    served (a), granite-3-2b trained (b). Returns (the JSON object, the
    kernels' checks, each path's launch counts)."""
    released = release_device_memory()
    serve_cfg, train_cfg = get_config(DENSE_SERVE["arch"]), get_config(DENSE_TRAIN["arch"])
    kchecks = check_dense_kernels(fa, ref, gather, serve_cfg)
    for c in (c for cs in kchecks.values() for c in cs):
        check(c["ok"], f"kernel disagrees with its plain version: {c}")
    serve_out, serve_launches = dense_serve_phase(fa, serve, build_model, serve_cfg)
    release_device_memory()
    train_out, train_launches = dense_train_phase(fa, build_model, train_cfg)
    launches = dict(serve_launches)
    launches.update({f"dense_train_{k.replace('/', '_')}": v
                     for k, v in train_launches.items()})
    return {"released": released, "serve": serve_out, "train": train_out}, kchecks, launches


# ---------------------------------------------------------------------------
# phase 21: telemetry on the card
# ---------------------------------------------------------------------------

# benchmarks/obs_bench.py's waves and gate; interleaved off/on pairs of (a)
# and repetitions a mode of (b): more than obs_bench's --full 9, because a
# whole wave's eager prefill on a shared host spreads its runs by up to 25%
# (511-682 tok/s off in one run), and the best of 9 then missed the gate
# with telemetry costing nothing measurable in (a)
OBS_BENCH = dict(seed=11, requests=8, prompt_len=8, gen=16, max_overhead=0.03,
                 pairs=40, reps_full=15)
OBS_CLI = ["--arch", "llama3.2-1b", "--attn-impl", "pallas", "--prompt-len", "64",
           "--gen", "16", "--requests", "8", "--batch", "4"]
# tests/test_obs.py::test_mixed_run_emits_complete_bundle's metric families
OBS_FAMILIES = ["serve_tokens_out", "serve_occupancy", "train_loss", "train_steps_total",
                "pool_utilization", "pool_fragmentation", "pool_total_cow",
                "prefix_hit_rate", "energy_loan_j", "battery_level", "thermal_temp_c",
                "thermal_throttled", "job_rung_idx", "job_step_latency_s",
                "runtime_migrations_total"]


def overhead_runs(obs, engine, waves, reps, control=False, decode_only=False):
    """benchmarks/obs_bench.py's method on a warmed engine: ``reps``
    repetitions of telemetry off then on, interleaved, one wave of requests
    (``waves()``) a run, tok/s of each run and the best of each mode. With
    ``decode_only`` a run's time leaves out its admissions (each prefill
    timed to a synchronise at its end) and its tokens the first one of each
    request, which the prefill emits: the rate of the decode steps alone.
    With ``control`` telemetry stays off in the "on" runs too: the method's
    own resolution (an A/A comparison). Returns each mode's tok/s, wall s
    and streams, the best of each mode and their ratio, and the last "on"
    run's tracer and decode steps."""
    out = {"tok_s": {"off": [], "on": []}, "streams": {"off": [], "on": []},
           "wall_s": {"off": [], "on": []}}
    prefill_s = [0.0]
    if decode_only:
        admit = engine._admit

        def timed_admit(slot, req):
            t = time.perf_counter()
            admit(slot, req)
            torch.cuda.synchronize()
            prefill_s[0] += time.perf_counter() - t
        engine._admit = timed_admit
    try:
        for _ in range(reps):
            for mode in ("off", "on"):
                tel = obs.Telemetry(enabled=mode == "on" and not control)
                prev = obs.set_telemetry(tel)
                reqs = waves()
                steps0, prefill_s[0] = engine.decode_steps, 0.0
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    done = engine.run(reqs)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0 - prefill_s[0]
                finally:
                    obs.set_telemetry(prev)
                streams = [done[r.uid].tokens for r in reqs]
                n = sum(map(len, streams)) - (len(reqs) if decode_only else 0)
                out["tok_s"][mode].append(n / dt)
                out["wall_s"][mode].append(dt)
                out["streams"][mode].append(streams)
                if mode == "on":
                    out["tracer"], out["steps"] = tel.tracer, engine.decode_steps - steps0
    finally:
        if decode_only:
            del engine._admit  # the class's own again
    best = {m: max(v) for m, v in out["tok_s"].items()}
    out["best_tok_s"], out["ratio"] = best, best["on"] / best["off"]
    return out


def span_counts(spans) -> dict:
    return dict(collections.Counter(s["name"] for s in spans))


def bundle_spans(outdir: Path) -> list:
    doc = json.loads((outdir / "trace.json").read_text())
    json.dumps(doc, allow_nan=False)  # strict JSON
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def report_names(obs_report, outdir: Path, label) -> dict:
    """``obs_report.main`` on a bundle with ``--chrome-trace``: its summary,
    the re-derived trace's span names checked against trace.json's."""
    chrome = outdir.parent / f"{outdir.name}_chrome.json"
    rep = obs_report.main([str(outdir), "--top", "0", "--audit-limit", "5",
                           "--chrome-trace", str(chrome)])
    names = {e["name"] for e in json.loads(chrome.read_text())["traceEvents"]
             if e["ph"] == "X"}
    want = {e["name"] for e in bundle_spans(outdir)}
    check(names == want, f"{label}: obs_report's trace has {sorted(names)}, "
          f"trace.json {sorted(want)}")
    return rep


def telemetry_phase(fa, serve, build_model, cfg, reqs, contig_streams, smi):
    """Phase 21: telemetry on the card. (a) benchmarks/obs_bench.py's gate
    at its own settings, on the decode steps, (b) its gate at full width on
    phase 4's requests, (c) the serve CLI's bundle, contiguous and paged
    speculative,
    (d) the mixed CLI's bundle under the reference's bundle assertions.
    Returns (the JSON object, each path's launch counts)."""
    import tempfile
    from repro_torch import obs
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import mixed, obs_report
    B = OBS_BENCH
    floor = 1.0 - B["max_overhead"]
    out, launches = {"card": smi}, {}
    check(not obs.get_telemetry().enabled, "telemetry on before phase 21")

    # -- (a) obs_bench's engine: host-bound, where a span's cost shows most ----
    tiny = ModelConfig(name="obs-tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                       tie_embeddings=True, source="benchmarks/obs_bench.py")
    model = build_model(tiny, impl="naive", device="cuda")
    engine = serve.ContinuousBatchingEngine(
        model, model.init(model.generator(0)), max_batch=4, max_seq=64,
        kv_layout="paged", block_size=4, prefix_cache=False)
    rng = np.random.default_rng(B["seed"])
    uid = [0]

    def tiny_wave():
        reqs_ = [serve.Request(uid=uid[0] + i, prompt=rng.integers(
            0, 64, B["prompt_len"]).astype(np.int32), max_new_tokens=B["gen"])
            for i in range(B["requests"])]
        uid[0] += B["requests"]
        return reqs_

    engine.run(tiny_wave())  # the decode step's eager call, its capture, replays
    fa.reset_launches()
    a = overhead_runs(obs, engine, tiny_wave, B["pairs"], decode_only=True)
    launches["telemetry_obs_bench"] = fa.all_launches()
    control = overhead_runs(obs, engine, tiny_wave, B["pairs"], control=True,
                            decode_only=True)
    ratio, aa = (statistics.median(on / off for off, on in
                                   zip(r["tok_s"]["off"], r["tok_s"]["on"]))
                 for r in (a, control))
    n_spans = len(a["tracer"].spans())
    out["obs_bench"] = {"decode_tok_s": a["tok_s"], "ratio": ratio,
                        "control_decode_tok_s": control["tok_s"], "control_ratio": aa,
                        "spans_per_run": n_spans, "decode_steps_per_run": a["steps"],
                        "span_mean_us": {k: v["mean_us"] for k, v in
                                         a["tracer"].by_name().items()},
                        "captures": engine._decode.captures,
                        "replays": engine._decode.replays}
    print(f"[obs] (a) obs_bench's engine, the decode steps alone, {B['pairs']} "
          f"interleaved pairs: decode tok/s off median "
          f"{statistics.median(a['tok_s']['off']):.0f}, on "
          f"{statistics.median(a['tok_s']['on']):.0f}; median on/off {ratio:.4f}, "
          f"the same with telemetry off in both (A/A) {aa:.4f} (gate >= {floor:.2f} "
          f"each); {n_spans} spans a run over {a['steps']} decode steps; {smi}",
          flush=True)
    check(n_spans > 0, "(a): the runs with telemetry on recorded no span")
    check(aa >= floor, f"(a): the method cannot resolve the gate: A/A {aa:.4f}")
    check(ratio >= floor, f"(a): telemetry on reached {ratio:.4f} of off")
    check(engine._decode.replays > 0, "(a): the decode step never replayed")
    del engine, model, a, control
    free_cuda()

    # -- (b) full width, phase 4's requests, the decode captured ---------------
    model = build_model(cfg, impl="pallas", device="cuda")
    engine = serve.ContinuousBatchingEngine(model, model.init(model.generator(0)),
                                            **engine_args({}))
    uid = [0]

    def full_wave():
        reqs_ = [serve.Request(uid=uid[0] + r.uid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens) for r in reqs]
        uid[0] += len(reqs)
        return reqs_

    engine.run(full_wave())  # warm: the capture, then replays
    captures = engine._decode.captures
    fa.reset_launches()
    b = overhead_runs(obs, engine, full_wave, B["reps_full"])
    launches["telemetry_full"] = fa.all_launches()
    by_name = b["tracer"].by_name()
    phase4 = [contig_streams[r.uid] for r in reqs]
    runs = b["streams"]["off"] + b["streams"]["on"]
    out["full_width"] = {
        "tok_s": b["tok_s"], "best_tok_s": b["best_tok_s"], "ratio": b["ratio"],
        "decode_steps_per_run": b["steps"],
        "spans_per_step": len(b["tracer"].spans()) / b["steps"],
        "span_mean_us": {k: v["mean_us"] for k, v in by_name.items()},
        "span_count": {k: v["count"] for k, v in by_name.items()},
        "identical_streams": all(s == runs[0] for s in runs),
        "identical_to_phase4": runs[0] == phase4,
        "captures": engine._decode.captures, "replays": engine._decode.replays,
        "launches": launches["telemetry_full"]}
    fw = out["full_width"]
    print(f"[obs] (b) {cfg.name} {cfg.n_layers} layers, captured, {B['reps_full']} "
          f"interleaved repetitions: tok/s off {[round(x, 1) for x in b['tok_s']['off']]}, "
          f"on {[round(x, 1) for x in b['tok_s']['on']]}; best on/off {b['ratio']:.4f} "
          f"(gate >= {floor:.2f}); {fw['spans_per_step']:.2f} spans a decode step; mean "
          f"host us { {k: round(v, 1) for k, v in fw['span_mean_us'].items()}}; streams "
          f"identical {fw['identical_streams']} (to phase 4: "
          f"{fw['identical_to_phase4']}); {smi}", flush=True)
    check(b["ratio"] >= floor, f"(b): telemetry on reached {b['ratio']:.4f} of off")
    check(fw["identical_streams"], "(b): streams with telemetry on differ from off")
    check(fw["identical_to_phase4"], "(b): streams differ from phase 4's")
    check(by_name["serve.decode"]["count"] == b["steps"],
          f"(b): {by_name['serve.decode']['count']} serve.decode spans for "
          f"{b['steps']} decode steps")
    check(engine._decode.captures == captures and engine._decode.replays > 0,
          f"(b): the timed runs captured again ({captures} -> {engine._decode.captures})")
    check(launches["telemetry_full"]["flash_decode"] > 0
          and launches["telemetry_full"]["flash_fwd"] > 0,
          f"(b): launches {launches['telemetry_full']}")
    del engine, model, b, by_name
    free_cuda()

    # -- (c) the serve CLI's bundle: contiguous, then paged speculative --------
    out["serve_cli"] = {}
    with tempfile.TemporaryDirectory(prefix="obs_") as tmp:
        for label, extra in (("contig", []),
                             ("paged_spec", ["--kv-layout", "paged",
                                             "--draft-depth", "4"])):
            tel_dir, js = Path(tmp) / label, Path(tmp) / f"{label}.json"
            prev = obs.get_telemetry()
            try:
                serve.main(OBS_CLI + extra + ["--telemetry-out", str(tel_dir),
                                              "--json-out", str(js)])
            finally:
                obs.set_telemetry(prev)
            launches[f"telemetry_cli_{label}"] = fa.all_launches()
            payload = json.loads(js.read_text())
            st = payload["stats"]
            count = span_counts(bundle_spans(tel_dir))
            rep = report_names(obs_report, tel_dir, f"(c) {label}")
            final = rep["final_metrics"]
            c = {"steps": payload["steps"], "tok_s": payload["tok_s"],
                 "span_count": count,
                 "span_mean_us": {r["name"]: r["mean_us"] for r in rep["spans"]},
                 "launches": launches[f"telemetry_cli_{label}"]}
            check(payload.get("schema_version") == obs.SCHEMA_VERSION,
                  f"(c) {label}: --json-out has no schema_version")
            check(count.get("serve.decode", 0) + count.get("serve.spec_verify", 0)
                  == payload["steps"], f"(c) {label}: spans {count} for "
                  f"{payload['steps']} steps")
            check(count.get("serve.cow_copy", 0) == st.get("cow_copies", 0),
                  f"(c) {label}: cow spans {count} against {st.get('cow_copies')}")
            if label == "contig":
                check(count["serve.prefill"] == payload["requests"] == len(payload["finished"]),
                      f"(c) contig: {count.get('serve.prefill')} serve.prefill spans "
                      f"for {payload['requests']} admissions")
                check(launches["telemetry_cli_contig"]["flash_decode"] > 0,
                      f"(c) contig: launches {launches['telemetry_cli_contig']}")
            else:
                check(count["serve.prefill_chunk"] == st["prefill_chunks"],
                      f"(c) paged: {count.get('serve.prefill_chunk')} chunk spans, "
                      f"{st['prefill_chunks']} chunks")
                check(count["serve.spec_draft"] == count["serve.spec_verify"] > 0,
                      f"(c) paged: spans {count}")
                check(final.get("spec_drafted_total") == st["spec_drafted"]
                      and final.get("spec_accepted_total") == st["spec_accepted"],
                      f"(c) paged: metrics {final} against stats "
                      f"{st['spec_drafted']}, {st['spec_accepted']}")
                check(launches["telemetry_cli_paged_spec"]["flash_decode_spec_paged"] > 0,
                      f"(c) paged: launches {launches['telemetry_cli_paged_spec']}")
                c["spec"] = [final.get("spec_drafted_total"),
                             final.get("spec_accepted_total"),
                             final.get("spec_acceptance_rate")]
            out["serve_cli"][label] = c
            print(f"[obs] (c) serve CLI {label}: {payload['steps']} steps, "
                  f"{payload['tok_s']:.1f} tok/s; spans {count}; obs_report's "
                  f"trace names equal trace.json's", flush=True)
    free_cuda()

    # -- (d) the mixed CLI's bundle: the reference's bundle assertions ---------
    C = COTENANT
    with tempfile.TemporaryDirectory(prefix="obs_mixed_") as tmp:
        tel_dir = Path(tmp) / "tel"
        prev = obs.get_telemetry()
        try:
            res, payload, d = run_mixed(fa, mixed, "telemetry", mixed_argv(
                ticks=C["ticks_b"], requests=C["requests_b"],
                prompt_len=C["prompt_len_b"], gen=C["gen_b"],
                thermal_trace=C["thermal"], kv_layout="paged", battery_j=200,
                telemetry_out=str(tel_dir)), layers=C["layers_b"])
        finally:
            obs.set_telemetry(prev)
        launches["telemetry_mixed"] = d["launches"]
        lines = [json.loads(x) for x in (tel_dir / "metrics.jsonl").read_text().splitlines()]
        body = [x for x in lines if "metrics" in x]
        fams = {k.split("{")[0] for x in body for k in x["metrics"]}
        missing = [f for f in OBS_FAMILIES if f not in fams]
        check(lines[0]["schema_version"] == obs.SCHEMA_VERSION and not missing
              and len(body) >= res.ticks, f"(d): metric families missing {missing}")
        xs = bundle_spans(tel_dir)
        names = {e["name"] for e in xs}
        check({"runtime.tick", "train.step", "serve.decode",
               "serve.prefill_chunk"} <= names, f"(d): span names {sorted(names)}")
        check(all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs), "(d): negative span times")
        ticks = [e for e in xs if e["name"] == "runtime.tick"]
        steps = [e for e in xs if e["name"] == "train.step"]
        check(len(ticks) == res.ticks and steps and
              any(e["args"].get("compile") for e in steps),
              f"(d): {len(ticks)} runtime.tick spans for {res.ticks} ticks")
        audit = obs.AuditLog.from_json(json.loads((tel_dir / "audit.json").read_text()))
        commits = audit.commits()
        migs = res.timeline.migrations
        check(migs, "(d): the thermal trace forced no migration")
        for m in migs:
            rec = [r for r in commits if r.tick == m.step and r.job == m.job
                   and r.from_rung == m.from_rung and r.to_rung == m.to_rung]
            check(rec and rec[0].rule == m.reason and rec[0].scores
                  and rec[0].thermal is not None and rec[0].energy is not None,
                  f"(d): migration {m} has no audit commit with its scores")
        check(any(r.event == "propose" for r in audit.records()), "(d): no propose")
        check(payload.get("schema_version") == obs.SCHEMA_VERSION,
              "(d): --json-out has no schema_version")
        rep = report_names(obs_report, tel_dir, "(d)")
        check(rep["spans"][0]["name"] == "runtime.tick" and rep["final_metrics"],
              f"(d): obs_report's top span is {rep['spans'][0]['name']}")
        out["mixed"] = {
            "ticks": res.ticks, "migrations": len(migs),
            "audit_records": len(audit), "commits": len(commits),
            "span_count": span_counts(xs), "metric_families": len(fams),
            "top_spans": [(r["name"], r["count"], r["mean_us"]) for r in rep["spans"][:6]],
            "wall_s": d["wall_s"], "launches": d["launches"],
            "mixed_launches": d["mixed_launches"]}
        print(f"[obs] (d) mixed CLI, {C['layers_b']} layers: {res.ticks} ticks, "
              f"{len(migs)} migrations each with its audit commit, spans "
              f"{out['mixed']['span_count']}, {len(fams)} metric families", flush=True)
        del res
    free_cuda()
    check(not obs.get_telemetry().enabled, "telemetry left on after phase 21")
    out["settings"] = dict(B, cli=OBS_CLI)
    return out, launches


# ---------------------------------------------------------------------------
# phase 22: the deepseek family at full width
# ---------------------------------------------------------------------------

# (a) the MLA latent decode at deepseek-v3's geometry: 8 sequences over 4096
# positions (256 blocks of 16 paged), ragged, with a length 0 and a retired
# slot's capacity + 1
MLA_KERNEL = dict(B=8, Smax=4096, bs=16, lengths=[0, 1, 4097, 731, 2048, 4095, 3333, 1500])
# (b), (c): served as phase 20 serves nemotron-4-15b (4 slots, 8 requests of
# 192-320 tokens, 16 greedy tokens), bf16 weights and cache; max_seq 512 is
# where --attn-impl auto picks the kernels (kernels/backend.auto_decode_impl)
DEEPSEEK = dict(slots=4, requests=8, prompt_lo=192, prompt_hi=320, gen=16,
                max_seq=512, seed=0, v3_layers=4)


def check_mla_kernels(fa, ref, gather, cfg):
    """Phase 22(a): ``flash_decode_mla`` and ``flash_decode_mla_paged`` at
    deepseek-v3's latent geometry (H = G 128, r 512, rd 64, scale
    1/sqrt(192)), f32 queries over a bf16 and an f32 cache, against their
    plain versions (2e-5). The library call: one SDPA over the 128 heads as
    128 query rows of one head, keys cat(latent, k_rope) (and the gather,
    paged), values the latent (Ev 512), a length mask, in f32 (a bf16 cache
    upcast first: the kernel computes in f32). Returns {kernel: [checks]}."""
    import torch.nn.functional as F
    c = MLA_KERNEL
    B, S, bs = c["B"], c["Smax"], c["bs"]
    H, r, rd = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = 1.0 / (cfg.qk_nope_head_dim + rd) ** 0.5
    T = S // bs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
    live = sum(min(n, S) for n in c["lengths"])
    g = torch.Generator(device="cuda").manual_seed(22)
    out = {"flash_decode_mla": [], "flash_decode_mla_paged": []}
    for name in out:
        paged = name.endswith("paged")
        for dtype in (torch.bfloat16, torch.float32):
            q_lat = torch.randn(B, H, r, generator=g, device="cuda")
            q_rope = torch.randn(B, H, rd, generator=g, device="cuda")
            if paged:  # a shuffled table over B*T + 1 blocks, row 0 idle at null block 0
                lat = (torch.randn(B * T + 1, bs, r, generator=g, device="cuda") * 0.3).to(dtype)
                kr = torch.randn(B * T + 1, bs, rd, generator=g, device="cuda").to(dtype)
                table = (torch.randperm(B * T, generator=g, device="cuda") + 1
                         ).reshape(B, T).to(torch.int32)
                table[0] = 0
                args = (q_lat, q_rope, lat, kr, table, lengths)
            else:
                lat = (torch.randn(B, S, r, generator=g, device="cuda") * 0.3).to(dtype)
                kr = torch.randn(B, S, rd, generator=g, device="cuda").to(dtype)
                args = (q_lat, q_rope, lat, kr, lengths)
            kernel, plain = getattr(fa, name), getattr(ref, "ref_" + name)
            got = kernel(*args, scale=scale, lowp=False)
            want = plain(*args, scale=scale, lowp=False)
            torch.cuda.synchronize()
            q = torch.cat([q_lat, q_rope], -1)[:, None]  # (B, 1, H, r + rd)
            mask = (torch.arange(S, device="cuda")[None] < lengths.clamp(max=S)[:, None]
                    )[:, None, None]

            def library():  # (gather,) cat, upcast, one SDPA
                la, kb = (gather(lat, table), gather(kr, table)) if paged else (lat, kr)
                keys = torch.cat([la, kb], -1).float()[:, None]
                return F.scaled_dot_product_attention(q, keys, la.float()[:, None],
                                                      attn_mask=mask, scale=scale)
            elt = lat.element_size()
            nbytes = live * (r + rd) * elt + (q_lat.numel() + q_rope.numel()) * 4 \
                + B * H * r * 4 + B * 4 + (B * T * 4 if paged else 0)
            rows = B * -(-H // fa.MLA_ROWS)
            plan = fa.decode_mla_plan(T if paged else -(-S // fa.MLA_BLOCK), rows, sms)
            out[name].append(kernel_check(
                f"{name} (deepseek-v3 latent, plan {plan})", got, want, F32_TOL,
                shape=[B, H, r, rd] + ([bs, T] if paged else [S]),
                lengths=c["lengths"], plan=list(plan),
                dtype=str(dtype).replace("torch.", ""),
                ms=time_ms(lambda: kernel(*args, scale=scale, lowp=False)),
                plain_ms=time_ms(lambda: plain(*args, scale=scale, lowp=False)),
                library_ms=time_ms(library),
                library_calls=("gather x2 + cat + upcast + SDPA" if paged
                               else "cat + upcast + SDPA"),
                nbytes=nbytes, flops=2 * H * (2 * r + rd) * live, lowp=False))
    return out


def deepseek_requests(serve, vocab):
    rng = np.random.default_rng(DEEPSEEK["seed"])
    return [serve.Request(uid=u, prompt=rng.integers(0, vocab, int(rng.integers(
        DEEPSEEK["prompt_lo"], DEEPSEEK["prompt_hi"] + 1))).astype(np.int32),
        max_new_tokens=DEEPSEEK["gen"]) for u in range(DEEPSEEK["requests"])]


def _margin_units(values, dtype, k):
    """The k-th largest value of each row less the (k+1)-th, and one unit in
    the last place of ``dtype`` at the k-th: (margins, units), lists."""
    top = values.float().topk(k + 1, dim=-1).values
    _, e = torch.frexp(top[..., k - 1].abs())
    unit = torch.finfo(dtype).eps * torch.ldexp(torch.ones_like(top[..., 0]), e - 1)
    return (top[..., k - 1] - top[..., k]).reshape(-1).tolist(), unit.reshape(-1).tolist()


def capacity_cut(gates, top_i, capacity):
    """Which of each token's routed experts (``top_i`` sorted) kept it
    within their capacity, (T, k) bool, and the token's distance in gate
    value from the nearest of those experts' capacity cuts (T,); (None,
    None) where the capacity cuts no token."""
    T = gates.shape[0]
    cap = min(capacity, T)
    if cap >= T:
        return None, None
    vals, idx = torch.topk(gates.T, cap + 1, dim=-1)  # (E, cap + 1)
    kept = torch.zeros_like(gates.T, dtype=torch.bool)
    kept.scatter_(1, idx[:, :cap], True)
    kept = kept.T  # (T, E)
    last, nxt = vals[:, cap - 1][None], vals[:, cap][None]
    dist = torch.where(kept, torch.where(nxt > 0, gates - nxt, torch.inf), last - gates)
    srt = top_i.sort(-1).values
    return torch.gather(kept, 1, srt), torch.gather(dist, 1, srt).min(-1).values


def recorded_moe_run(serve, moe_mod, model, params, reqs, **engine_kw):
    """The engine run eagerly (``jit=False``) with its steps and its moe
    layers wrapped, recording every discrete decision a stream's tokens
    meet. Returns a dict: ``streams``; ``dec[(uid, n, s, layer)]`` = (the
    experts the router chose for row s of the uid's n-th call in that moe
    layer, those of them that kept the token within their capacity, the
    k-th router logit less the (k+1)-th, one unit of the logits' dtype at
    the k-th, the token's distance in gate value from its experts' capacity
    cut); ``seq[(uid, n)]`` = the call's number in the run; ``calls[seq]`` =
    [the streams in the call, whether capacity cut any moe layer of it];
    ``margins[(uid, index)]`` = (the greedy decision's top-2 logit margin,
    one unit of the logits' dtype at the top logit, the call's number). An
    idle or retired slot's rows ride along as the stream ("slot", b, the
    uid that last held it), whose tokens and cache they still carry."""
    ctx = {"rows": None, "layer": 0, "uid": None, "seq": -1, "route": None}
    rec = {"dec": {}, "seq": {}, "calls": {}, "margins": {}}
    ordinal, occupant = {}, {}
    real_top, real_local = moe_mod._top, moe_mod._moe_local

    def top(x_flat, router_w, cfg):
        out = real_top(x_flat, router_w, cfg)
        if ctx["rows"] is not None:
            logits = x_flat @ router_w  # the product's dtype: a bf16 model's logits are bf16
            gaps, units = _margin_units(logits, logits.dtype, cfg.top_k)
            ctx["route"] = (out[2].sort(-1).values.tolist(), gaps, units)
        ctx["layer"] += 1
        return out

    def local(x_flat, gates, top_i, experts, capacity, activation):
        rows = ctx["rows"]
        if rows is not None:
            chosen, gaps, units = ctx["route"]
            kept, gap = capacity_cut(gates, top_i, capacity)
            if kept is not None:  # which tokens an expert keeps is a decision too
                rec["calls"][ctx["seq"]][1] = True
                kgaps = gap.tolist()
                kept_of = [tuple(e for e, k in zip(c, kr) if k)
                           for c, kr in zip(chosen, kept.tolist())]
            else:
                kept_of, kgaps = [tuple(c) for c in chosen], [float("inf")] * len(chosen)
            layer = ctx["layer"] - 1
            for i, key in enumerate(rows):
                if key is not None:
                    rec["dec"][key + (layer,)] = (tuple(chosen[i]), kept_of[i], gaps[i],
                                                  units[i], kgaps[i])
        return real_local(x_flat, gates, top_i, experts, capacity, activation)

    def begin(rows):  # rows: (stream, s) or None per row of the call
        ctx["seq"] += 1
        streams = list(dict.fromkeys(r[0] for r in rows if r is not None))
        for u in streams:
            ordinal[u] = ordinal.get(u, -1) + 1
            rec["seq"][(u, ordinal[u])] = ctx["seq"]
        rec["calls"][ctx["seq"]] = [streams, False]
        ctx.update(rows=[None if r is None else (r[0], ordinal[r[0]], r[1]) for r in rows],
                   layer=0)

    def end(logits, keys):  # logits (B, S, V); keys[b * S + s]: (uid, index) or None
        ctx["rows"] = None
        gaps, units = _margin_units(logits, logits.dtype, 1)
        for key, m, u in zip(keys, gaps, units):
            if key is not None:
                rec["margins"][key] = (m, u, ctx["seq"])

    engine = serve.ContinuousBatchingEngine(model, params, jit=False,
                                            **engine_args(engine_kw))

    def slot_rows(S):
        rows, keys = [], []
        for b in range(engine.max_batch):
            u = engine.slot_uid[b]
            for s in range(S):
                rows.append((("slot", b, occupant.get(b)) if u is None else u, s))
                keys.append(None if u is None else (u, len(engine.generated[b]) + s))
        return rows, keys

    real = {k: getattr(engine, k) for k in ("_admit", "_prefill", "_decode", "_spec_decode",
                                            "_prefill_chunk", "_prefill_chunk_ro")
            if getattr(engine, k, None) is not None}

    def admit(slot, req):
        ctx["uid"] = occupant[slot] = req.uid
        return real["_admit"](slot, req)

    def prefill(params, batch):
        begin([(ctx["uid"], s) for s in range(batch["tokens"].shape[1])])
        logits, pcache = real["_prefill"](params, batch)
        end(logits, [(ctx["uid"], 0)])
        return logits, pcache

    def chunk(name):
        def fn(params, cache, tokens, start, table, last_pos):
            begin([(ctx["uid"], s) for s in range(tokens.shape[1])])
            logits, cache = real[name](params, cache, tokens, start, table, last_pos)
            end(logits, [(ctx["uid"], 0)])
            return logits, cache
        return fn

    def decode(*args):
        rows, keys = slot_rows(1)
        begin(rows)
        out = real["_decode"](*args)
        end(out[1], keys)
        return out

    def verify(params, cache, window, *rest):
        rows, keys = slot_rows(window.shape[1])
        begin(rows)
        logits, cache = real["_spec_decode"](params, cache, window, *rest)
        end(logits, keys)
        return logits, cache

    engine._admit, engine._prefill, engine._decode = admit, prefill, decode
    if "_spec_decode" in real:
        engine._spec_decode = verify
    for name in ("_prefill_chunk", "_prefill_chunk_ro"):
        if name in real:
            setattr(engine, name, chunk(name))
    moe_mod._top, moe_mod._moe_local = top, local
    try:
        done = engine.run([serve.Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens) for r in reqs])
    finally:
        moe_mod._top, moe_mod._moe_local = real_top, real_local
    del engine
    rec["streams"] = streams_of(done)
    return rec


def _within(e) -> bool:
    """Phase 5's rule for one decision: the plain path's margin below
    LOGIT_TOL, or at most one unit of the deciding values' dtype."""
    return e[3] < LOGIT_TOL or e[3] <= e[4]


def first_decisions(kernel, plain, diffs):
    """For each (uid, index) of ``diffs`` (a stream and its first token that
    differs between the kernel run ``kernel`` and the plain run ``plain``,
    both from ``recorded_moe_run``), the decisions the two runs made
    differently in that token's causal past, and the causally first of them.

    A decision is (time, kind, stream, the plain path's margin, its unit,
    where): time = (the plain run's call number, the moe layer; the greedy
    pick after every layer), kind "route" (the router's top-k), "capacity"
    (the experts' capacity cut, margin in gate value, which has no unit but
    LOGIT_TOL) or "greedy" (another stream's first differing token). The
    past of a stream up to call t is its own decisions up to t, and, through
    every call up to t in which capacity cut (which couples the call's
    rows), the past of each other stream of that call up to it; an idle
    slot's past includes that of the stream that last held it. Returns
    {(uid, index): (n decisions in the past, [the causally first ones])}."""
    events = collections.defaultdict(list)
    for key, p in plain["dec"].items():
        k = kernel["dec"].get(key)
        if k is None:
            continue
        u, n, s, layer = key
        if k[0] != p[0]:
            kind, margin, unit = "route", p[2], p[3]
        elif k[1] != p[1]:
            kind, margin, unit = "capacity", p[4], 0.0
        else:
            continue
        events[u].append(((plain["seq"][(u, n)], layer), kind, u, margin, unit,
                          {"call": n, "row": s}))
    for u, i in diffs:
        gap, unit, seq = plain["margins"][(u, i)]
        events[u].append(((seq, float("inf")), "greedy", u, gap, unit, {"token": i}))
    calls_of = collections.defaultdict(list)
    for seq, (streams, _) in sorted(plain["calls"].items()):
        for u in streams:
            calls_of[u].append(seq)
    out = {}
    for u, i in diffs:
        t_u = plain["margins"][(u, i)][2]
        past, best, stack = {}, {}, [(u, t_u)]
        while stack:
            v, t = stack.pop()
            if best.get(v, -1) >= t:
                continue
            best[v] = t
            for e in events.get(v, ()):
                if (e[1] == "greedy" and v != u and e[0][0] < t) or \
                        (e[1] != "greedy" and e[0][0] <= t):
                    past[(e[0], e[1], repr(v), repr(e[5]))] = e
            if isinstance(v, tuple) and v[2] is not None:  # an idle slot's rows
                stack.append((v[2], t))
            for seq in calls_of[v]:
                if seq > t:
                    break
                streams, coupled = plain["calls"][seq]
                if coupled:
                    stack.extend((w, seq) for w in streams if w != v)
        evs = list(past.values())
        t0 = min((e[0] for e in evs), default=None)
        out[(u, i)] = (len(evs), [e for e in evs if e[0] == t0])
    return out


def moe_streams(label, got, want, rerun, divergences, held=True):
    """Phase 5's rule for a moe model, where a routing or capacity decision
    taken differently magnifies a difference of summation order: streams
    token-identical, or diverging only where (1) the plain path's top-2
    logit margin at that token, taken from its own batched run (a replay of
    the request alone would change what shares the experts' capacity), is
    within the rule (``_within``), or (2) the causally first decisions that
    the two paths took differently in that token's past
    (``first_decisions``) were each within the rule: a router top-k or a
    capacity cut at a near tie (a capacity cut may also follow from a
    router decision beside it). ``rerun(impl)`` gives the eager recorded run
    of each path (``recorded_moe_run``), whose streams must equal the
    captured runs'. Appends each divergence with its first decisions to
    ``divergences``. ``held=False`` reports the verdicts without failing on
    them (the bf16 runs: phase 22's docstring says why). Returns the number
    of identical streams."""
    check(sorted(got) == sorted(want), f"{label}: requests missing")
    diffs = []
    for u in sorted(want):
        if got[u] != want[u]:
            check(len(got[u]) == len(want[u]), f"{label}: uid {u} has {len(got[u])} "
                  f"tokens, not {len(want[u])}")
            diffs.append((u, next(j for j in range(len(got[u])) if got[u][j] != want[u][j])))
    if diffs:
        kernel, plain = rerun("pallas"), rerun("naive")
        check(kernel["streams"] == got and plain["streams"] == want,
              f"{label}: the eager recorded runs gave other streams than the captured ones")
        causes = first_decisions(kernel, plain, diffs)
        for u, i in diffs:
            margin, unit, _ = plain["margins"][(u, i)]
            n_past, first = causes[(u, i)]
            greedy_ok = margin < LOGIT_TOL or margin <= unit
            first_ok = bool(first) and all(
                _within(e) or (e[1] == "capacity" and any(x[1] == "route" for x in first))
                for e in first)
            ok = greedy_ok or first_ok
            d = {"uid": u, "index": i, "got": got[u][i], "plain": want[u][i],
                 "margin": margin, "unit": unit, "decisions_in_past": n_past,
                 "within_rule": ok,
                 "first": [{"kind": e[1], "stream": repr(e[2]), "call_seq": e[0][0],
                            "moe_layer": e[0][1] if e[1] != "greedy" else None,
                            "margin": e[3], "unit": e[4], "within": _within(e), **e[5]}
                           for e in first]}
            print(f"[{label}] uid {u} diverges at token {i}: {got[u][i]} vs {want[u][i]}, "
                  f"plain top-2 margin {margin:.3g} (unit {unit:.3g}); {n_past} decisions "
                  f"in its past differ, the first: "
                  + ("; ".join(f"{e[1]} of {e[2]!r} at call {e[0][0]}"
                               + (f" moe layer {e[0][1]}" if e[1] != "greedy" else "")
                               + f", margin {e[3]:.3g} (unit {e[4]:.3g})"
                               for e in sorted(first, key=lambda e: -e[3])[:3])
                     + (f" (the widest 3 of {len(first)})" if len(first) > 3 else "")
                     or "none")
                  + f" -> {'within' if ok else 'OUTSIDE'} phase 5's rule")
            divergences.append(d)
            if held:
                check(ok, f"{label}: uid {u} diverges at token {i} where the margin is "
                      f"{margin}, and the first decisions its past took differently are "
                      f"not near ties: {d['first'][:3]}")
    identical = len(want) - len(diffs)
    print(f"[{label}] {identical}/{len(want)} streams token-identical"
          + ("" if held else f" (reported, not held: "
             f"{sum(d['within_rule'] for d in divergences)}/{len(diffs)} divergences "
             f"within phase 5's rule)"), flush=True)
    return identical


def deepseek_serve(fa, serve, build_model, backend, cfg, paths, tag, dtype):
    """Phase 22(b) or (c): ``cfg`` at full width, weights and KV cache in
    ``dtype``, through ``ContinuousBatchingEngine`` built as the serve CLI's
    ``--attn-impl auto`` builds it (the kernels, at max_seq 512), captured,
    on each of ``paths`` (name, engine keywords, the decode kernel it must
    launch); each path's streams compared with the plain path's (``naive``)
    under ``moe_streams``: held in f32, reported in bf16, which is also
    profiled. Returns (the JSON object, each path's launch counts)."""
    import warnings
    from repro_torch.models import attention, moe
    f32 = dtype == torch.float32
    impl = backend.auto_decode_impl(DEEPSEEK["max_seq"], device="cuda")
    check(impl == "pallas", f"--attn-impl auto picked {impl} at max_seq {DEEPSEEK['max_seq']}")
    model = build_model(cfg, impl=impl, param_dtype=dtype, device="cuda")
    naive = build_model(cfg, impl="naive", param_dtype=dtype, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(model.generator(DEEPSEEK["seed"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(params))
    weights_gb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reqs = deepseek_requests(serve, cfg.vocab_size)
    mla = (f"MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} nope "
           f"{cfg.qk_nope_head_dim} rope {cfg.qk_rope_head_dim} v {cfg.v_head_dim}"
           if cfg.use_mla else f"MHA hd {cfg.head_dim}")
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} dense), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {mla}; {cfg.n_experts} routed experts top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared, d_ff {cfg.moe_d_ff}; "
          f"{n_params / 1e9:.3f}B params (mtp {'mtp' in params}), {dtype} weights "
          f"{weights_gb:.2f} GB (init {init_s:.1f} s, peak {init_peak_gb:.2f} GB); prompts "
          f"{[len(r.prompt) for r in reqs]}", flush=True)
    attention._MLA_PALLAS_WARNED = False
    with torch.inference_mode(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        toks = torch.as_tensor(reqs[0].prompt[:64], device="cuda")[None]
        lk, _ = model.prefill(params, {"tokens": toks})
        ln, _ = naive.prefill(params, {"tokens": toks})
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    check(bool(warned) == cfg.use_mla and all("chunked" in w for w in warned),
          f"{cfg.name}: prefill warnings {warned}")
    check(lk.shape == (1, 1, cfg.vocab_size) and lk.dtype == dtype
          and bool(torch.isfinite(lk).all()), f"prefill logits {tuple(lk.shape)}")
    prefill_diff = float((lk.float() - ln.float()).abs().max())
    print(f"[{tag}] prefill of 64 tokens: pallas vs naive max |dlogit| {prefill_diff:.3g} "
          f"({dtype} logits, top {float(lk.float().max()):.3g}); warned: {warned}",
          flush=True)
    kw = dict(max_batch=DEEPSEEK["slots"], max_seq=DEEPSEEK["max_seq"], cache_dtype=dtype)
    run_engine(serve, model, params, reqs[:1], **kw)  # warm-up: cuBLAS, allocator
    out, launches = {}, {}
    for path, extra, kname in paths:
        rs = shared_prefix_requests(serve, reqs) if "kv_layout" in extra else reqs
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        done, engine, wall = run_engine(serve, model, params, rs, **kw, **extra)
        counts = launches[path] = fa.all_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = [engine._decode, engine._spec_decode]
        replays = sum(getattr(f, "replays", 0) for f in steps)
        check(counts[kname] > 0 and replays > 0,
              f"{path}: {kname} launched {counts[kname]} times, {replays} replays")
        check(next(iter(engine.cache.values())).dtype == dtype, f"{path}: cache not {dtype}")
        check(sorted(done) == [r.uid for r in rs], f"{path}: requests missing")
        check_tokens(path, engine, cfg.vocab_size)
        fa.reset_launches()
        done_n, engine_n, wall_n = run_engine(serve, naive, params, rs, **kw, **extra)
        check(not any(fa.all_launches().values()), f"{path}: the plain path launched")
        divergences = []
        ident = moe_streams(
            path, streams_of(done), streams_of(done_n),
            lambda impl: recorded_moe_run(serve, moe, model if impl == "pallas" else naive,
                                          params, rs, **kw, **extra),
            divergences, held=f32)
        st = engine.stats()
        out[path] = {"tok_s": engine.tokens_out / wall, "wall_s": wall,
                     "naive_tok_s": engine_n.tokens_out / wall_n,
                     "tokens": engine.tokens_out, "decode_steps": engine.decode_steps,
                     "replays": replays, "peak_memory_gb": peak_gb,
                     "identical_streams": ident, "divergences": divergences,
                     "launches": counts}
        if "kv_layout" in extra:
            out[path].update(prefill_chunks_skipped=st["prefill_chunks_skipped"],
                             cow_copies=st["cow_copies"])
        if "draft_depth" in extra:
            out[path].update(acceptance=st.get("spec_acceptance"),
                             spec_rounds=engine.spec_rounds)
        print(f"[{tag}] {path}: {engine.tokens_out} tokens in {wall:.3f} s "
              f"({engine.tokens_out / wall:.1f} tok/s captured; plain path "
              f"{engine_n.tokens_out / wall_n:.1f}), {engine.decode_steps} steps, "
              f"{replays} replays, peak {peak_gb:.2f} GB, {ident}/{len(rs)} streams "
              f"identical to the plain path's, launches {counts}", flush=True)
        del done, engine, done_n, engine_n
    if not f32:
        prof = profile_decode(serve, model, params, reqs, label=f", {cfg.name} bf16", **kw)
        out["decode_step"] = {"host_ms": prof[0], "device_ms": prof[1],
                              "attention_ms": prof[2]}
    out.update(arch=cfg.name, dtype=str(dtype), layers=cfg.n_layers, params=n_params,
               weights_gb=weights_gb,
               init_s=init_s, init_peak_gb=init_peak_gb, prefill_warnings=warned,
               prefill_max_abs_dlogit=prefill_diff,
               **{k: DEEPSEEK[k] for k in ("slots", "requests", "gen", "max_seq")})
    del model, naive, params, lk, ln
    free_cuda()
    return out, launches


def deepseek_phase(fa, ref, serve, build_model, backend, get_config, gather):
    """Phase 22: the MLA latent decode kernel at deepseek-v3's geometry (a);
    deepseek-v3-671b at full width cut to 4 layers (its 3 dense MLA layers
    and 1 MLA + MoE layer of 256 routed experts and 1 shared, the MTP head's
    params; the whole model, 671B, does not fit one card), served contiguous
    and paged (b); deepseek-moe-16b whole (28 layers), served contiguous,
    paged and speculative, with the GQA kernels at G 1 hd 128 checked at its
    geometry (c); (b) and (c) in bf16 (measured, streams reported) and in
    f32 (streams held to ``moe_streams``). Returns (the JSON object, the
    kernels' checks, each path's launch counts)."""
    released = release_device_memory()
    v3 = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=DEEPSEEK["v3_layers"])
    checks = check_mla_kernels(fa, ref, gather, v3)
    moe16b = get_config("deepseek-moe-16b")
    dense = check_dense_kernels(fa, ref, gather, moe16b)
    for c in (c for cs in list(checks.values()) + list(dense.values()) for c in cs):
        check(c["ok"], f"kernel disagrees with its plain version: {c}")
    paged_kw = dict(kv_layout="paged", block_size=PAGED["block_size"])
    out, launches = {"released": released}, {}
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        out["v3" + sfx], counts = deepseek_serve(
            fa, serve, build_model, backend, v3,
            [("v3_serve" + sfx, {}, "flash_decode_mla"),
             ("v3_paged" + sfx, paged_kw, "flash_decode_mla_paged")], "deepseek-v3", dtype)
        launches.update(counts)
        release_device_memory()
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        out["moe16b" + sfx], counts = deepseek_serve(
            fa, serve, build_model, backend, moe16b,
            [("moe16b_serve" + sfx, {}, "flash_decode"),
             ("moe16b_paged" + sfx, paged_kw, "flash_decode_paged"),
             ("moe16b_spec" + sfx, dict(draft_depth=PAGED["draft_depth"]),
              "flash_decode_spec")], "deepseek-moe-16b", dtype)
        launches.update(counts)
        release_device_memory()
    for name, cs in dense.items():
        checks.setdefault(name, []).extend(cs)
    return out, checks, launches

# ---------------------------------------------------------------------------
# phase 23: training of the moe family
# ---------------------------------------------------------------------------

# deepseek-moe-16b at full width cut to its dense layer and 4 MoE layers
# (2.85B parameters, ~57 GB of f32 state with adam), phase 6's batch and
# steps; deepseek-v3 cut to its first dense MLA layer and the MTP head
MOE_TRAIN = dict(arch="deepseek-moe-16b", layers=5, v3_layers=1, v3_steps=4,
                 peak_limit_gb=75.0)
# deepseek-moe-16b's train step: B4, H16 (K16, G1), S512, hd 128, causal
MOE_GEOMETRY = dict(B=TRAIN["batch"], H=16, S=TRAIN["seq"], hd=128)
STATE_BYTES = 20  # a parameter, its gradient, adam's m and v and update, f32


def fake_param_count(cfg) -> int:
    """The parameters ``init_decoder`` makes for ``cfg`` (the MTP head
    included, which ``param_count`` leaves out), counted under
    ``FakeTensorMode``: nothing is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import transformer
    with FakeTensorMode():
        params = transformer.init_decoder(torch.Generator(device="cuda"), cfg)
    return sum(p.numel() for p in _leaves(params))


def activation_gb(cfg, tokens: int) -> float:
    """A reckoning of one step's activations: per token, the logits of the
    head (and of the MTP head) in three f32 copies (logits, softmax, its
    gradient), the attention's scores over the sequence in three (the
    chunked path's scores, probabilities and their gradient; more than the
    flash kernels keep), and for each layer 8 vectors of its MLP's width
    (for a MoE layer, the routed experts' top-k times the capacity factor
    1.25, plus the shared experts) and 16 of d_model."""
    heads = 2 if cfg.n_mtp_modules else 1
    moe_width = (cfg.top_k * 1.25 + cfg.n_shared_experts) * cfg.moe_d_ff
    widths = [cfg.dense_d_ff] * (cfg.first_k_dense + heads - 1) \
        + [moe_width] * (cfg.n_layers - cfg.first_k_dense)
    per_token = 3 * heads * cfg.vocab_size + 3 * cfg.n_heads * TRAIN["seq"] \
        + sum(8 * w + 16 * cfg.d_model for w in widths)
    return 4 * per_token * tokens / 1e9


class RoutingRecorder:
    """The router's and the capacity's decisions of every MoE call while
    active (``moe._top`` and ``moe._moe_local`` wrapped): for each call, the
    experts each token chose (sorted), those that kept it within their
    capacity, the k-th router logit less the (k+1)-th, one unit of the
    logits' dtype there, and the token's distance in gate value from the
    capacity cut of its experts (as ``recorded_moe_run`` records them)."""

    def __init__(self, moe_mod):
        self.moe, self.calls = moe_mod, []

    def __enter__(self):
        real_top, real_local = self.moe._top, self.moe._moe_local
        self._real = real_top, real_local

        def top(x_flat, router_w, cfg):
            out = real_top(x_flat, router_w, cfg)
            with torch.no_grad():
                logits = x_flat @ router_w
                gaps, units = _margin_units(logits, logits.dtype, cfg.top_k)
            self.calls.append({"chosen": out[2].sort(-1).values.cpu(),
                               "gap": gaps, "unit": units})
            return out

        def local(x_flat, gates, top_i, experts, capacity, activation):
            with torch.no_grad():
                kept, gap = capacity_cut(gates, top_i, capacity)
                if kept is None:
                    kept = torch.ones_like(top_i, dtype=torch.bool)
                    gap = torch.full(top_i.shape[:1], torch.inf)
                self.calls[-1].update(kept=kept.cpu(), cut_gap=gap.tolist())
            return real_local(x_flat, gates, top_i, experts, capacity, activation)

        self.moe._top, self.moe._moe_local = top, local
        return self

    def __exit__(self, *exc):
        self.moe._top, self.moe._moe_local = self._real


def routing_differences(got, want):
    """The decisions two runs of the same calls took differently, ordered
    causally as ``moe_streams`` orders them (by call: in one forward, its
    moe layer; a layer's decisions feed every later layer): [(call, token,
    kind, the second run's margin, its unit)], kind "route" (the router's
    top-k, margin in router-logit units) or "capacity" (the capacity cut,
    margin in gate value, which has no unit but LOGIT_TOL)."""
    out = []
    for c, (a, b) in enumerate(zip(got, want)):
        route = (a["chosen"] != b["chosen"]).any(-1)
        cut = (a["kept"] != b["kept"]).any(-1) & ~route
        for t in route.nonzero().flatten().tolist():
            out.append((c, t, "route", b["gap"][t], b["unit"][t]))
        for t in cut.nonzero().flatten().tolist():
            out.append((c, t, "capacity", b["cut_gap"][t], 0.0))
    return out


def report_routing(label, got, want, held=False) -> dict:
    """Print the decisions two runs took differently, the causally first
    ones (the earliest call) with their margins; return them."""
    check(len(got) == len(want), f"{label}: {len(got)} and {len(want)} moe calls")
    diffs = routing_differences(got, want)
    first = [d for d in diffs if d[0] == diffs[0][0]] if diffs else []
    within = all(_within((None, d[2], None, d[3], d[4])) for d in first)
    print(f"[moe-train] {label}: {len(diffs)} of "
          f"{sum(len(c['gap']) for c in want)} token-call decisions differ"
          + (f"; the first in moe call {first[0][0]}: " + "; ".join(
              f"{k} of token {t}, margin {m:.3g} (unit {u:.3g})"
              for _, t, k, m, u in sorted(first, key=lambda d: -d[3])[:4])
             + f" -> {'within' if within else 'OUTSIDE'} phase 5's rule" if diffs else ""),
          flush=True)
    if held:
        check(within, f"{label}: the first routing decisions taken differently are "
              f"not near ties: {first[:4]}")
    return {"n_differ": len(diffs), "first": [
        {"call": c, "token": t, "kind": k, "margin": m, "unit": u} for c, t, k, m, u in first[:8]],
        "first_within_rule": within}


def moe_backward_bits(moe_mod, cfg) -> dict:
    """One MoE layer at ``cfg``'s full width (E 64, top-6, d 2048, ff 1408,
    two shared experts) on T = 2048 tokens (B4 x S512), its backward called
    twice on the same inputs and cotangent: every gradient (the input's,
    the router's, each expert's) the same bits, or not. The dispatch gather
    sends each token's rows back through an accumulating ``index_put_``."""
    from repro_torch.tree import tree_leaves
    g = torch.Generator(device="cuda").manual_seed(23)
    p = moe_mod.moe_params(g, cfg)
    x = torch.randn(TRAIN["batch"], TRAIN["seq"], cfg.d_model, generator=g, device="cuda")
    dy = torch.randn(x.shape, generator=g, device="cuda")
    leaves = [x.requires_grad_()] + [w.requires_grad_() for w in tree_leaves(p)]

    def run():
        y, aux = moe_mod.apply_moe(p, x, cfg)
        return torch.autograd.grad((y * dy).sum() + aux, leaves)

    first, second = run(), run()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    diff = max(float((a - b).abs().max()) for a, b in zip(first, second))
    ms = cuda_ms(run, iters=3)
    out = {"tokens": x.shape[0] * x.shape[1], "experts": cfg.n_experts, "top_k": cfg.top_k,
           "d_model": cfg.d_model, "moe_d_ff": cfg.moe_d_ff, "same_bits": all(same),
           "leaves_same": same, "max_abs_diff": diff, "fwd_bwd_ms": ms}
    print(f"[moe-train] MoE layer backward at T {out['tokens']}, E {cfg.n_experts}, "
          f"k {cfg.top_k}, d {cfg.d_model}, ff {cfg.moe_d_ff}: two calls give the same "
          f"bits: {all(same)} (per leaf {same}; max |diff| {diff:.3g}); forward and "
          f"backward {ms:.2f} ms", flush=True)
    del p, x, dy, leaves, first, second
    free_cuda()
    return out


def moe_train_run(fa, TrainSession, rung, cfg, batch_fn, steps, jit):
    """``steps`` adam steps through ``TrainSession`` on ``rung``; returns
    (the run's record, its result, its launch counts)."""
    from repro_torch.optim.optimizers import adam
    fa.reset_launches()
    before_gb = [torch.cuda.memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9]
    torch.cuda.reset_peak_memory_stats()
    res, wall = run_session(TrainSession, [rung], cfg, batch_fn, steps, optimizer=adam(),
                            adaptive=False, jit=jit)
    counts = fa.all_launches()
    ms = step_ms(res)
    med = statistics.median(ms[2:] if jit else ms[1:])
    B, S = TRAIN["batch"], TRAIN["seq"]
    run = dict(losses=res.losses, step_ms=ms, median_step_ms=med,
               tokens_per_s=B * S / (med / 1e3), wall_s=wall,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts,
               microbatch=rung.microbatch, param_dtype=rung.param_dtype,
               allocated_reserved_gb_before=before_gb)
    if jit:
        step = rung.jitted_step(cfg, adam(), lr=TRAIN["lr"], device="cuda")
        run.update(capture_ms=1e3 * step.capture_s, captures=step.captures,
                   replays=step.replays)
        check(step.captures == 1 and step.replays == steps - 1,
              f"{cfg.name} {rung.name}: {step.captures} captures, {step.replays} replays")
    check(all(map(lambda x: x == x and abs(x) < 1e9, res.losses)),
          f"{cfg.name} {rung.name}: losses not finite {res.losses}")
    print(f"[moe-train] {cfg.name} {rung.name} ({rung.param_dtype}, microbatch "
          f"{rung.microbatch}, {rung.attn_impl}) {'captured' if jit else 'eager'}: losses "
          f"{[round(x, 5) for x in res.losses]}; step ms {[round(x, 1) for x in ms]}; "
          f"median {med:.1f} ms = {run['tokens_per_s']:.0f} tokens/s; peak "
          f"{run['peak_memory_gb']:.2f} GB ({before_gb[0]:.2f} allocated, "
          f"{before_gb[1]:.2f} reserved before); capture {run.get('capture_ms', 0):.1f} ms; "
          f"launches {counts}", flush=True)
    return run, res, counts


def rel_diff_max(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def moe_train_phase(fa, fb, ref, build_model, get_config):
    """Phase 23: the flash kernels at deepseek-moe-16b's train geometry
    (B4 H16 S512 hd128, causal; f32 and bf16) against their plain versions;
    the MoE layer's backward twice at its full-width shape; (a)
    deepseek-moe-16b at full width cut to 5 layers trained through
    ``TrainSession`` on a static f32 rung, eager, captured and on the plain
    path, held to phase 6's rules; (b) the bf16 ``lean`` rung; (c)
    deepseek-v3 cut to its dense MLA layer and the MTP head, eager and
    captured. Returns (the JSON object, the kernels' checks, each run's
    launch counts)."""
    from repro_torch.engine.rungs import Rung, default_rung_ladder
    from repro_torch.engine.session import TrainSession
    from repro_torch.launch.steps import cast_params
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import moe
    from repro_torch.optim.optimizers import adam
    from repro_torch.tree import tree_leaves
    released = release_device_memory()
    B, H, S, hd = (MOE_GEOMETRY[k] for k in ("B", "H", "S", "hd"))
    checks = {"flash_fwd": check_flash_fwd(fa, ref, cases=[
        (B, H, S, hd, torch.float32, False), (B, H, S, hd, torch.bfloat16, False)])}
    checks["flash_bwd_dq"], checks["flash_bwd_dkv"] = check_flash_bwd(fb, ref, cases=[
        (B, H, S, S, hd, True, torch.float32, False),
        (B, H, S, S, hd, True, torch.bfloat16, False)])
    for c in (c for cs in checks.values() for c in cs):
        check(c["ok"], f"kernel disagrees with its plain version: {c}")
    cfg = dataclasses.replace(get_config(MOE_TRAIN["arch"]), n_layers=MOE_TRAIN["layers"])
    bits = moe_backward_bits(moe, cfg)
    check(bits["same_bits"], f"the MoE layer's backward gave other bits on a second "
          f"call: {bits}")

    # -- (a) deepseek-moe-16b, f32, full rung ----------------------------------
    steps = TRAIN["steps"]
    batch_fn = make_batch_fn(cfg, B, S, seed=TRAIN["seed"])
    n_params = fake_param_count(cfg)
    act = activation_gb(cfg, B * S)
    print(f"[moe-train] {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} dense, "
          f"d_ff {cfg.dense_d_ff}), d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.n_experts} routed experts top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared of {cfg.moe_d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f}B params; reckoned state {STATE_BYTES * n_params / 1e9:.1f} "
          f"GB (f32 params, gradients, adam m, v and update) + activations "
          f"~{act:.1f} GB a step; batch {B} x {S}, {steps} steps, adam lr {TRAIN['lr']}",
          flush=True)
    first = {k: torch.as_tensor(v, device="cuda") for k, v in batch_fn(0).items()}
    with RoutingRecorder(moe) as rec:
        first_losses, grad_rel = grad_agreement(build_model, cfg, first, tree_leaves)
    n_moe = cfg.n_layers - cfg.first_k_dense
    check(len(rec.calls) == 2 * n_moe, f"{len(rec.calls)} moe calls in two forwards")
    routing = {"pallas_vs_naive_step0": report_routing(
        "pallas vs naive, step 0", rec.calls[:n_moe], rec.calls[n_moe:])}
    print(f"[moe-train] step-0 gradients, pallas vs naive: norm-wise {grad_rel:.3g} "
          f"(limit {GRAD_RTOL}); losses {first_losses}", flush=True)
    check(grad_rel <= GRAD_RTOL, f"{cfg.name}: first-step gradients differ by {grad_rel}")
    del rec
    runs, launches = {}, {}
    for impl, jit in (("pallas", False), ("pallas", True), ("naive", True)):
        key = impl if jit else f"{impl}_eager"
        rung = Rung(name="static", attn_impl=impl)
        runs[key], res, counts = moe_train_run(fa, TrainSession, rung, cfg, batch_fn,
                                               steps, jit)
        launches[f"moe_train_{key}"] = counts
        if impl == "pallas":
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                check(counts[kname] == cfg.n_layers * steps,
                      f"{key}: {kname} launched {counts[kname]} times, not "
                      f"{cfg.n_layers} x {steps}")
        else:
            check(not any(counts.values()), f"the plain path launched: {counts}")
        if key == "pallas":
            step_fn = rung.jitted_step(cfg, adam(), lr=TRAIN["lr"], device="cuda")
            host_ms, dev_ms, top, _ = profile_train_step(step_fn, res.state,
                                                         batch_fn(steps))
            del step_fn
            rung.invalidate()  # the graph's pool: the state and it leave no room
            free_cuda()
            # an eager step, whose CPU ops name the kernels' callers
            eager_fn = rung.train_step_fn(rung.build_model(cfg, "cuda"), adam(),
                                          lr=TRAIN["lr"])
            _, eager_ms, eager_top, ops = profile_train_step(eager_fn, res.state,
                                                            batch_fn(steps))
            parts = {"device_ms": eager_ms, "expert_bmm_ms": ops.get("aten::bmm", 0.0),
                     "flash_ms": sum(t for t, _, k in eager_top if "flash_" in k)}
            parts["rest_ms"] = eager_ms - parts["expert_bmm_ms"] - parts["flash_ms"]
            flash_ms = sum(t for t, _, k in top if "flash_" in k)
            runs[key]["profile"] = {"host_ms": host_ms, "device_ms": dev_ms,
                                    "flash_ms": flash_ms,
                                    "top": [[t, n, k[:120]] for t, n, k in top[:12]]}
            runs[key]["profile_eager_parts"] = parts
            print(f"[profile] {cfg.name} train step, captured: host {host_ms:.1f} ms, "
                  f"device busy {dev_ms:.1f} ms, the flash kernels {flash_ms:.2f} ms; "
                  f"eager, by part (device ms): expert bmm {parts['expert_bmm_ms']:.1f}, "
                  f"flash {parts['flash_ms']:.2f}, the rest {parts['rest_ms']:.1f} of "
                  f"{parts['device_ms']:.1f}", flush=True)
            for t, n, k in top[:10]:
                print(f"[profile]   {t:8.3f} ms {n:5d} calls  {k[:90]}")
            del eager_fn
        del res
        rung.invalidate()
        free_cuda()
    rel_c = rel_diff_max(runs["pallas"]["losses"], runs["pallas_eager"]["losses"])
    rel_n = rel_diff_max(runs["pallas"]["losses"], runs["naive"]["losses"])
    grad_rel_c = captured_grad_agreement(
        build_model, cfg, {k: v[:1] for k, v in batch_fn(0).items()}, tree_leaves)
    print(f"[moe-train] captured vs eager: losses {rel_c:.3g} (limit {LOSS_RTOL}), a "
          f"replayed step's gradients {grad_rel_c:.3g} (limit {GRAD_RTOL}); pallas vs "
          f"naive losses {rel_n:.3g} (limit {LOSS_RTOL})", flush=True)
    check(rel_c <= LOSS_RTOL, f"{cfg.name}: captured and eager losses differ by {rel_c}")
    check(grad_rel_c <= GRAD_RTOL, f"{cfg.name}: captured gradients differ by {grad_rel_c}")
    check(rel_n <= LOSS_RTOL, f"{cfg.name}: pallas and naive losses differ by {rel_n}")

    # -- (b) the lean rung: bf16 parameters, microbatch 4 ----------------------
    lean = default_rung_ladder(batch=B, attn_impl="pallas")[-1]
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(TRAIN["seed"]))
    mb = {k: v[:B // lean.microbatch] for k, v in first.items()}
    with torch.no_grad(), RoutingRecorder(moe) as rec:
        model.loss(params, mb)
        model.loss(cast_params(params, torch.bfloat16), mb)
    routing["bf16_vs_f32_step0"] = report_routing(
        "bf16 vs f32 parameters, step 0's first microbatch", rec.calls[n_moe:],
        rec.calls[:n_moe])
    del model, params, rec
    free_cuda()
    runs["lean"], res, counts = moe_train_run(fa, TrainSession, lean, cfg, batch_fn,
                                              steps, True)
    launches["moe_train_lean"] = counts
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts[kname] == cfg.n_layers * lean.microbatch * steps,
              f"lean: {kname} launched {counts[kname]} times, not {cfg.n_layers} x "
              f"{lean.microbatch} x {steps}")
    runs["lean"]["loss_rel_diff_vs_f32"] = rel_diff_max(res.losses, runs["pallas"]["losses"])
    del res
    lean.invalidate()
    free_cuda()

    # -- (c) deepseek-v3 cut to its dense MLA layer and the MTP head ------------
    release_device_memory()
    v3 = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=MOE_TRAIN["v3_layers"],
                             first_k_dense=MOE_TRAIN["v3_layers"])
    v3_params = fake_param_count(v3)
    # a step's peak: the state with the update tree (STATE_BYTES a
    # parameter) and the activations; the capture draws on its own pool
    # after the eager first call's cache is released (launch/steps.py)
    reckoned = {b: STATE_BYTES * v3_params / 1e9 + activation_gb(v3, b * S)
                for b in (B, B // 2)}
    v3_batch = B if reckoned[B] <= MOE_TRAIN["peak_limit_gb"] else B // 2
    print(f"[moe-train] {v3.name} cut to {v3.n_layers} dense MLA layer + the MTP head: "
          f"d_model {v3.d_model}, {v3.n_heads} heads, vocab {v3.vocab_size}; "
          f"{v3_params / 1e9:.3f}B params; reckoned peak (the state with adam's "
          f"update, and one step's activations) {reckoned[B]:.1f} GB at batch {B}, "
          f"{reckoned[B // 2]:.1f} GB at {B // 2}: batch {v3_batch} x {S} used", flush=True)
    v3_fn = make_batch_fn(v3, v3_batch, S, seed=TRAIN["seed"])
    v3_runs = {}
    for jit in (False, True):
        rung = Rung(name="static", attn_impl="pallas")
        key = "captured" if jit else "eager"
        v3_runs[key], res, counts = moe_train_run(fa, TrainSession, rung, v3, v3_fn,
                                                  MOE_TRAIN["v3_steps"], jit)
        launches[f"moe_train_v3_{key}"] = counts
        del res
        rung.invalidate()
        free_cuda()
    v3_rel = rel_diff_max(v3_runs["captured"]["losses"], v3_runs["eager"]["losses"])
    print(f"[moe-train] {v3.name}: captured vs eager losses {v3_rel:.3g} (limit "
          f"{LOSS_RTOL})", flush=True)
    check(v3_rel <= LOSS_RTOL, f"{v3.name}: captured and eager losses differ by {v3_rel}")
    release_device_memory()
    out = {"released": released, "moe_backward": bits,
           "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
                      "reckoned_state_gb": STATE_BYTES * n_params / 1e9,
                      "reckoned_activation_gb": act, **TRAIN},
           "runs": runs, "routing": routing, "first_step_losses": first_losses,
           "first_step_grad_rel_err": grad_rel,
           "captured_vs_eager": {"loss_rel_diff_max": rel_c,
                                 "replayed_grad_rel_err": grad_rel_c},
           "pallas_vs_naive_loss_rel_diff_max": rel_n,
           "v3": {"n_layers": v3.n_layers, "params": v3_params, "batch": v3_batch,
                  "reckoned_peak_gb": reckoned, "steps": MOE_TRAIN["v3_steps"],
                  "runs": v3_runs, "loss_rel_diff_max": v3_rel}}
    return out, checks, launches


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
    free_cuda()
    fl_out = fl_phase()
    lap("phase 18")
    sampled_out, sampled_launches = sampled_phase(fa, serve, build_model, cfg, reqs,
                                                  contig_streams)
    lap("phase 19")
    free_cuda()
    dense_out, dense_checks, dense_launches = dense_phase(
        fa, ref, serve, build_model, get_config, gather_paged_kv)
    lap("phase 20")
    free_cuda()
    obs_out, obs_launches = telemetry_phase(fa, serve, build_model, cfg, reqs,
                                            contig_streams, smi)
    lap("phase 21")
    free_cuda()
    deepseek_out, deepseek_checks, deepseek_launches = deepseek_phase(
        fa, ref, serve, build_model, backend, get_config, gather_paged_kv)
    lap("phase 22")
    free_cuda()
    moe_train_out, moe_train_checks, moe_train_launches = moe_train_phase(
        fa, fb, ref, build_model, get_config)
    lap("phase 23")

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
        for p, counts in sampled_launches.items():  # phase 19
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        for p, counts in dense_launches.items():  # phase 20
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        for p, counts in obs_launches.items():  # phase 21
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        for p, counts in deepseek_launches.items():  # phase 22
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        for p, counts in moe_train_launches.items():  # phase 23
            if counts.get(e["name"], 0):
                e["launches_by_path"][p] = counts[e["name"]]
        e["checks"] += dense_checks.get(e["name"], [])  # nemotron's geometry
        e["checks"] += deepseek_checks.get(e["name"], [])  # deepseek-moe-16b's
        e["checks"] += moe_train_checks.get(e["name"], [])  # its train step's
        e["launches"] = sum(e["launches_by_path"].values())
    # the decode kernels' mixed-dtype instantiations (phase 3's checks,
    # phase 17's and 21(d)'s launches): a KV cache in another dtype than
    # the queries'
    cotenancy_mixed["telemetry_mixed"] = obs_out["mixed"]["mixed_launches"]
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
    # the MLA latent decode (phase 22(a)'s checks, 22(b)'s launches), its
    # bf16-cache check first: the serve path's dtype
    for kname, ref_line in (("flash_decode_mla", ":438 (_decode_kernel, pallas_call at :536)"),
                            ("flash_decode_mla_paged",
                             ":551 (_decode_paged_kernel, pallas_call at :616)")):
        by_path = {p: n[kname] for p, n in deepseek_launches.items() if n.get(kname)}
        check(by_path, f"phase 22 launched no {kname}")
        kernels.append(entry(
            kname, "src/repro_torch/csrc/flash_decode_mla.cu",
            f"src/repro/kernels/flash_attention.py{ref_line}, in the MLA latent geometry "
            f"of src/repro/kernels/ops.py:" + ("77" if kname == "flash_decode_mla" else "147"),
            deepseek_checks[kname], by_path))
    print(json.dumps({"serve": serve_out}))
    print(json.dumps({"train": dict(train_out, build_s=build_s, seconds=seconds,
                                    seconds_total=time.perf_counter() - t_start)}))
    print(json.dumps({"serve_paged": paged_out}))
    print(json.dumps({"serve_spec": spec_out}))
    print(json.dumps({"cnn": cnn_out}))
    print(json.dumps({"rmsnorm": rms_out}))
    print(json.dumps({"planner": planner_out}))
    print(json.dumps({"cotenancy": cotenancy_out}, default=str))
    print(json.dumps({"fl": fl_out}))
    print(json.dumps({"serve_sampled": sampled_out}))
    print(json.dumps({"dense": dense_out}))
    print(json.dumps({"obs": obs_out}))
    print(json.dumps({"deepseek": deepseek_out}))
    print(json.dumps({"moe_train": moe_train_out}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
