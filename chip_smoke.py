#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: exits non-zero, printing no result, unless
   ``torch.cuda.is_available()``. TF32 is switched off for matmuls and
   cuDNN, so every f32 product on the card runs in full f32.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` for sm_90a with nvcc (one
   process per source, started together) into ``build/kernels/``.
3. Kernels: calls each kernel's wrapper on the card at the shapes of the
   serve and train paths and holds it against its plain PyTorch version
   (``kernels/ref.py``) on the same inputs: 2e-5 in f32, 5e-2 with bf16 dot
   inputs. Times the kernel, the plain version and one PyTorch library call
   for the same function (``scaled_dot_product_attention``, its backward
   through ``torch.autograd.grad`` for the backward kernels; used here only
   as a yardstick), and computes the least time the card could take (bytes
   over 3.35 TB/s or operations over the type's peak, the larger).
4. Serve: llama3.2-1b at full width (16 layers, d_model 2048), f32 params
   drawn by the port from a seeded generator, through
   ``ContinuousBatchingEngine(attn_impl="pallas")``: 8 slots, 16 requests,
   ragged prompts of 192-320 tokens, 32 greedy tokens each, max_seq 1024.
   The kernels' launch counts are set to 0 just before this run and read
   just after; both must be > 0.
5. Reference: the same requests through the plain attention path
   (``attn_impl="naive"``) on the card. Streams must be token-identical; a
   divergence is tolerated (and printed) only where the plain path's top-2
   logit margin at that step is below LOGIT_TOL.

6. Train: llama3.2-1b at full width and depth, f32 params from a seeded
   generator, adam lr 3e-4, batch 4 x 512 tokens, 6 steps through
   ``TrainSession.run`` on a static rung with ``attn_impl="pallas"``. The
   launch counts are set to 0 just before and read just after: flash_fwd,
   flash_bwd_dq and flash_bwd_dkv must each read 16 x 6. The same steps with
   ``attn_impl="naive"``: per-step losses agree to 1e-3 relative, and the
   first step's gradients (taken apart from both runs) to 1e-4 norm-wise.
   Prints the median step time of steps 2-6, tokens/s, the peak memory and a
   ``torch.profiler`` breakdown of one step.
7. Checkpoint and resume: full width cut to 2 layers (the state of the full
   depth is 15 GB, too slow to write and read back here); 3 steps with a
   checkpoint every 3, then a resumed session to step 6. Losses of steps
   3-5 equal an uninterrupted run's to 1e-5 relative.
8. Adaptive: full width and depth, the default rung ladder (microbatch 1,
   2, then 4 in bf16) under the interference trace ``2:6:3.0``, 10 steps,
   wall-clock latencies. At least one interference downgrade, every
   migration in place, every loss finite, and each step on the bf16 rung
   launches the backward kernels 16 times each.

Output: progress lines, then JSON lines ``{"serve": ...}``, ``{"train":
...}`` and ``{"kernels": [...]}``, the card's name and power limit as
``nvidia-smi`` gives them, and as the last line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
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
LOGIT_TOL = 1e-3  # pallas vs naive logits differ by f32 summation order only

SERVE = dict(slots=8, requests=16, prompt_lo=192, prompt_hi=320, gen=32,
             max_seq=1024, seed=0)
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


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_flash_fwd(fa, ref):
    """Prefill attention: B=1, H=32, hd=64, causal, at S=512, a prime S near
    it and S=256 (inside the serve run's prompt range); then the train
    step's B=4, S=512."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for B, S, dtype, lowp in [(1, 512, torch.float32, False),
                              (1, 509, torch.float32, False),
                              (1, 256, torch.float32, False),
                              (1, 512, torch.bfloat16, True),
                              (1, 509, torch.bfloat16, True),
                              (4, 512, torch.float32, False),   # the train step's
                              (4, 512, torch.bfloat16, True)]:
        H, hd = 32, 64
        q, k, v = (torch.randn(B, H, S, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True, lowp=lowp)
        ro, rl = ref.ref_flash_attention_fwd(q, k, v, causal=True, lowp=lowp)
        torch.cuda.synchronize()
        tol = BF16_TOL if lowp else F32_TOL
        err_o, ok_o = max_err(o, ro, tol)
        err_l, ok_l = max_err(lse, rl, tol)
        elt = q.element_size()
        nbytes = 4 * B * H * S * hd * elt + B * H * S * 4  # q,k,v read; o, lse written
        flops = 4 * hd * B * H * S * (S + 1) // 2           # QK^T and PV, causal pairs
        peak = BF16_FLOPS if lowp else F32_FLOPS
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
        }
        print(f"[kernels] flash_fwd {c['shape']} {c['dtype']} lowp={lowp}: "
              f"max_abs_err={c['max_abs_err']:.3g} (tol {c['tol']}) "
              f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"sdpa {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']})", flush=True)
        checks.append(c)
    return checks


def check_flash_decode(fa, ref):
    """Decode attention: B=8, K=8, G=4, hd=64, Smax=1024, ragged lengths
    including 0 and Smax + 1."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    B, K, G, hd, Smax = 8, 8, 4, 64, 1024
    lens_list = [0, 1, 193, 300, 511, 700, 1024, 1025]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    checks = []
    for dtype, lowp in [(torch.float32, False), (torch.bfloat16, True)]:
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
            "shape": [B, K, G, hd, Smax], "lengths": lens_list,
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
        print(f"[kernels] flash_decode {c['shape']} {c['dtype']} lowp={lowp}: "
              f"max_abs_err={err:.3g} (tol {c['tol']}) kernel {c['ms']:.4f} ms, "
              f"plain {c['plain_ms']:.4f} ms, sdpa {c['library_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
        checks.append(c)
    return checks


def check_flash_bwd(fb, ref):
    """The two backward kernels at the train step's shape, B=4, H=32, S=512,
    hd=64, causal, in f32 and in bf16 with lowp; then a ragged case, Sq=300
    against Sk=373, full attention. Both kernels get the same o, lse and
    delta as their plain versions. The library yardstick is one
    ``torch.autograd.grad`` through SDPA (dq, dk and dv together; its
    forward runs before the timing)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(3)
    dq_checks, dkv_checks = [], []
    for B, Sq, Sk, causal, dtype, lowp in [(4, 512, 512, True, torch.float32, False),
                                           (4, 512, 512, True, torch.bfloat16, True),
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
        tol = BF16_TOL if lowp else F32_TOL
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
        peak = BF16_FLOPS if lowp else F32_FLOPS
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
        # dq: q.k, do.v and ds.k; dkv: k.q, v.do, p^T do and ds^T q
        b_q, by_q = bound(inputs + B * H * Sq * hd * 4, 3 * 2 * hd * pairs)
        b_kv, by_kv = bound(inputs + 2 * B * H * Sk * hd * 4, 4 * 2 * hd * pairs)
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


def run_engine(serve, model, params, reqs):
    engine = serve.ContinuousBatchingEngine(model, params,
                                            max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    return done, engine, time.perf_counter() - t0


def profile_decode(serve, model, params, reqs, steps: int = 4):
    """Where a batched decode step's time goes: admit one request per slot,
    then trace ``steps`` decode steps with torch.profiler. Prints the host
    time per step, the device time per step (sum of kernel times) and the
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = serve.ContinuousBatchingEngine(model, params,
                                            max_batch=SERVE["slots"],
                                            max_seq=SERVE["max_seq"])
    for r in reqs[:SERVE["slots"]]:
        engine.submit(serve.Request(uid=r.uid, prompt=r.prompt,
                                    max_new_tokens=steps + 2))
    engine.step()  # admits every slot and runs the first decode
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
    print(f"[profile] decode step ({model.build_kwargs['impl']}): host "
          f"{host_ms:.3f} ms/step, device busy {dev_ms:.3f} ms/step "
          f"({100 * dev_ms / host_ms:.1f}% of the step)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    return host_ms, dev_ms


@torch.inference_mode()
def top2_margin(model, params, prompt, tokens, index):
    """The plain path's top-2 logit margin where it chose ``tokens[index]``,
    replaying the request alone (prefill, then greedy decode)."""
    logits, pcache = model.prefill(params, {"tokens": torch.as_tensor(
        prompt, device="cuda")[None]})
    cache = model.init_cache(1, SERVE["max_seq"], torch.float32)
    for name in cache:
        cache[name][:, :, :len(prompt)] = pcache[name]
    for i in range(index):
        tok = torch.tensor([[tokens[i]]], dtype=torch.int32, device="cuda")
        logits, cache = model.decode_step(params, cache, tok, len(prompt) + i)
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


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


def run_session(TrainSession, rungs, cfg, batch_fn, steps, *, start=0,
                state=None, device="cuda", **kw):
    sess = TrainSession(cfg, rungs, optimizer=kw.pop("optimizer"),
                        lr=TRAIN["lr"], batch_fn=batch_fn, verbose=True,
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
    (after the run warmed everything up). Returns (host ms, device busy ms,
    [(ms, calls, kernel name)] of the kernels with the most device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    from repro_torch.engine.events import InterferenceTrace
    from repro_torch.engine.rungs import Rung, default_rung_ladder
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

    runs = {}
    for impl in ("pallas", "naive"):
        rung = Rung(name="static", attn_impl=impl)
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res, wall_t = run_session(TrainSession, [rung], cfg, batch_fn, steps,
                                  optimizer=adam(), adaptive=False, device=device)
        counts = fa.all_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = step_ms(res)
        med = statistics.median(ms[1:])
        runs[impl] = dict(losses=res.losses, step_ms=ms, median_step_ms=med,
                          tokens_per_s=B * S / (med / 1e3), wall_s=wall_t,
                          peak_memory_gb=peak_gb, launches=counts)
        print(f"[train] {impl}: losses {[round(x, 5) for x in res.losses]}; step ms "
              f"{[round(x, 1) for x in ms]}; median (steps 2-{steps}) {med:.1f} ms = "
              f"{B * S / (med / 1e3):.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
              f"launches {counts}", flush=True)
        check(all(map(lambda x: x == x and abs(x) < 1e9, res.losses)),
              f"{impl} losses not finite: {res.losses}")
        if impl == "pallas":
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                check(counts[kname] == cfg.n_layers * steps,
                      f"{kname} launched {counts[kname]} times in the train run, "
                      f"not {cfg.n_layers} x {steps}")
            train_launches = counts
            host_ms, dev_ms, top = profile_train_step(
                rung.cached_step(cfg, adam(), lr=TRAIN["lr"], device=device),
                res.state, batch_fn(steps))
            attn_ms = sum(t for t, _, k in top if "flash_" in k)
            print(f"[profile] train step (pallas): host {host_ms:.1f} ms, device busy "
                  f"{dev_ms:.1f} ms ({100 * dev_ms / host_ms:.1f}% of the step); the "
                  f"three attention kernels {attn_ms:.2f} ms", flush=True)
            for t, n, k in top[:12]:
                print(f"[profile]   {t:8.3f} ms {n:5d} calls  {k[:90]}")
            runs[impl]["profile"] = {"host_ms": host_ms, "device_ms": dev_ms,
                                     "attention_kernels_ms": attn_ms,
                                     "top": [[t, n, k[:120]] for t, n, k in top[:12]]}
        del res
        free_cuda()
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["pallas"]["losses"],
                                               runs["naive"]["losses"])]
    print(f"[train] pallas vs naive per-step loss relative difference: max "
          f"{max(rel):.3g} (limit {LOSS_RTOL})", flush=True)
    check(max(rel) <= LOSS_RTOL, f"pallas and naive losses differ: {rel}")

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
    ladder = default_rung_ladder(batch=B, microbatch=1, attn_impl="pallas")
    snaps = []

    def counted_batches(step):  # launches so far, at the start of every step
        snaps.append(fa.all_launches())
        return batch_fn(step)

    fa.reset_launches()
    adaptive_steps = 10
    res, _ = run_session(TrainSession, ladder, cfg, counted_batches, adaptive_steps,
                         optimizer=adam(), adaptive=True, device=device,
                         trace=InterferenceTrace.parse("2:6:3.0"))
    snaps.append(fa.all_launches())
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
    adaptive_out = {"migrations": migrations, "rungs": rungs_by_step,
                    "losses": res.losses, "step_ms": step_ms(res),
                    "reached_bf16": "lean" in rungs_by_step}
    del res
    free_cuda()
    return {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "params": cfg.param_count(), "dtype": "float32", **TRAIN},
        "pallas": runs["pallas"], "naive": runs["naive"],
        "first_step_grad_rel_err": grad_rel, "loss_rel_diff_max": max(rel),
        "resume": {"n_layers": cut.n_layers, "start": start, "losses": resumed,
                   "uninterrupted": ref_tail, "rel_diff_max": rel_resume,
                   "ckpt_gb": ckpt_gb, "restore_s": restore_s},
        "adaptive": adaptive_out}, train_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.launch import serve
    from repro_torch.models import build_model

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
    libs = ["flash_fwd", "flash_bwd", "flash_decode"]
    backend.build_libraries(libs)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(libs)} for sm_90a in {build_s:.1f} s", flush=True)
    for lib in libs:
        log = backend.library_path(lib).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")

    # -- phase 3: kernels against their plain versions -------------------------
    fwd = check_flash_fwd(fa, ref)
    dec = check_flash_decode(fa, ref)
    bwd_dq, bwd_dkv = check_flash_bwd(fb, ref)
    for c in fwd + dec + bwd_dq + bwd_dkv:
        check(c["ok"], f"kernel disagrees with its plain version: {c}")

    # -- phase 4: serve with the kernels ---------------------------------------
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, impl="pallas", device="cuda")
    params = model.init(model.generator(0))
    naive = build_model(cfg, impl="naive", device="cuda")
    reqs = make_requests(serve, cfg.vocab_size)
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
    fa.reset_launches()
    done, engine, wall = run_engine(serve, model, params, reqs)
    launches = fa.all_launches()
    serve_launches = dict(launches)
    tok_s = engine.tokens_out / wall
    print(f"[serve] pallas: {engine.tokens_out} tokens in {wall:.3f} s "
          f"({tok_s:.1f} tok/s), {engine.decode_steps} decode steps, occupancy "
          f"{engine.occupancy:.3f}, launches {launches}", flush=True)
    check(launches["flash_fwd"] > 0 and launches["flash_decode"] > 0,
          f"the serve run did not go through both kernels: {launches}")
    check(sorted(done) == list(range(SERVE["requests"])), "requests missing")
    for u, f in done.items():
        check(len(f.tokens) == SERVE["gen"] and f.reason == "length"
              and all(0 <= t < cfg.vocab_size for t in f.tokens),
              f"request {u}: {len(f.tokens)} tokens, reason {f.reason}")

    prof = {impl: profile_decode(serve, m, params, reqs)
            for impl, m in (("pallas", model), ("naive", naive))}

    # -- phase 5: the same requests through the plain path ---------------------
    done_n, engine_n, wall_n = run_engine(serve, naive, params, reqs)
    print(f"[serve] naive: {engine_n.tokens_out} tokens in {wall_n:.3f} s "
          f"({engine_n.tokens_out / wall_n:.1f} tok/s)", flush=True)
    identical = 0
    for u in sorted(done):
        a, b = done[u].tokens, done_n[u].tokens
        if a == b:
            identical += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(naive, params, reqs[u].prompt, b, i)
        print(f"[serve] uid {u} diverges at token {i}: pallas {a[i]} vs naive "
              f"{b[i]}, plain top-2 margin {margin:.3g} (tolerance {LOGIT_TOL})")
        check(margin < LOGIT_TOL, f"uid {u} diverges where the margin is {margin}")
    print(f"[serve] {identical}/{len(done)} streams token-identical to the "
          f"plain path", flush=True)

    serve_out = {
        "tok_s": tok_s, "wall_s": wall, "tokens": engine.tokens_out,
        "decode_steps": engine.decode_steps, "occupancy": engine.occupancy,
        "naive_tok_s": engine_n.tokens_out / wall_n,
        "identical_streams": identical,
        "decode_step_host_ms": {k: v[0] for k, v in prof.items()},
        "decode_step_device_ms": {k: v[1] for k, v in prof.items()}}
    del model, naive, params, engine, engine_n, done, done_n, lk, ln, ck, cn
    free_cuda()

    train_out, train_launches = train_phases(fa, build_model, cfg)

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

    kernels = [
        entry("flash_fwd", "src/repro_torch/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention.py:111 (_fwd_kernel, "
              "pallas_call at :173)", fwd,
              {"serve": serve_launches["flash_fwd"],
               "train": train_launches["flash_fwd"]}),
        entry("flash_bwd_dq", "src/repro_torch/csrc/flash_bwd.cu",
              "src/repro/kernels/flash_attention.py:205 (_dq_kernel, "
              "pallas_call at :309)", bwd_dq,
              {"train": train_launches["flash_bwd_dq"]}),
        entry("flash_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
              "src/repro/kernels/flash_attention.py:251 (_dkv_kernel, "
              "pallas_call at :338)", bwd_dkv,
              {"train": train_launches["flash_bwd_dkv"]}),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
              "src/repro/kernels/flash_attention.py:438 (_decode_kernel, "
              "pallas_call at :536)", dec,
              {"serve": serve_launches["flash_decode"]}),
    ]
    print(json.dumps({"serve": serve_out}))
    print(json.dumps({"train": dict(train_out, build_s=build_s,
                                    seconds_total=time.perf_counter() - t_start)}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
