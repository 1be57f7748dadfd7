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
3. Kernels: calls each kernel's wrapper on the card at the serve path's
   shapes and holds it against its plain PyTorch version
   (``kernels/ref.py``) on the same inputs: 2e-5 in f32, 5e-2 with bf16 dot
   inputs. Times the kernel, the plain version and one PyTorch library call
   for the same function (``scaled_dot_product_attention``, used here only
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

Output: progress lines, then one JSON line ``{"kernels": [...]}``, the
card's name and power limit as ``nvidia-smi`` gives them, and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
    it and S=256 (inside the serve run's prompt range)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for S, dtype, lowp in [(512, torch.float32, False), (509, torch.float32, False),
                           (256, torch.float32, False), (512, torch.bfloat16, True),
                           (509, torch.bfloat16, True)]:
        B, H, hd = 1, 32, 64
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ref
    from repro_torch.kernels import flash_attention as fa
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
    backend.build_libraries(["flash_fwd", "flash_decode"])
    print(f"[build] flash_fwd, flash_decode for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in ("flash_fwd", "flash_decode"):
        log = backend.library_path(lib).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}: {line.strip()}")

    # -- phase 3: kernels against their plain versions -------------------------
    fwd = check_flash_fwd(fa, ref)
    dec = check_flash_decode(fa, ref)
    for c in fwd + dec:
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
    launches = dict(fa.launches)
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

    def entry(kname, source, replaces, checks):
        main_c = checks[0]  # f32, the serve path's dtype
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": main_c["max_abs_err"], "max_err": main_c["max_abs_err"],
            "ms": main_c["ms"], "kernel_ms": main_c["ms"],
            "plain_ms": main_c["plain_ms"], "bound_ms": main_c["bound_ms"],
            "bound_by": main_c["bound_by"], "library_ms": main_c["library_ms"],
            "checks": checks,
        }

    kernels = [
        entry("flash_fwd", "src/repro_torch/csrc/flash_fwd.cu",
              "src/repro/kernels/flash_attention.py:111 (_fwd_kernel, "
              "pallas_call at :173)", fwd),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
              "src/repro/kernels/flash_attention.py:438 (_decode_kernel, "
              "pallas_call at :536)", dec),
    ]
    print(json.dumps({"serve": {
        "tok_s": tok_s, "wall_s": wall, "tokens": engine.tokens_out,
        "decode_steps": engine.decode_steps, "occupancy": engine.occupancy,
        "naive_tok_s": engine_n.tokens_out / wall_n,
        "identical_streams": identical,
        "decode_step_host_ms": {k: v[0] for k, v in prof.items()},
        "decode_step_device_ms": {k: v[1] for k, v in prof.items()},
        "seconds_total": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
