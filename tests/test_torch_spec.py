"""The port's speculative decoding against the JAX package's.

``flash_decode_spec`` and ``flash_decode_spec_paged`` (their plain versions
on the CPU) against the reference's Pallas kernels in interpret mode, at the
tolerances of ``tests/test_kernels.py`` (2e-5 at f32, 5e-2 with bf16 dot
inputs); ``naive_attention`` with a per-row ``q_offset``; the verify step on
carried-over params (logits and caches to 1e-4, f32 summation order);
``greedy_verify`` and ``NGramDraft`` on the same inputs; and the serve
engine, token for token and counter for counter, on the scenarios of
``tests/test_spec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.spec import draft as jdraft
from repro.spec.verify import greedy_verify as jax_greedy_verify
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_tree
from repro_torch.spec import draft as tdraft
from repro_torch.spec.verify import greedy_verify

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
TINY = ModelConfig(name="spec-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   tie_embeddings=True, source="tests/test_spec.py")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _convert(jparams):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_build_model(TINY, impl="naive").init(jax.random.PRNGKey(0))
    return jparams, _convert(jparams)


# ---------------------------------------------------------------------------
# the verify kernels and their layout wrappers
# ---------------------------------------------------------------------------

SPEC_CASES = [  # B, K, S, G, hd, hdv, Smax, lengths, scale
    (3, 2, 1, 4, 16, 16, 32, [0, 9, 31], None),     # S=1: plain decode + 1
    (4, 2, 2, 4, 16, 16, 32, [0, 13, 30, 32], None),  # window past Smax
    (3, 1, 4, 1, 32, 16, 40, [5, 36, 40], 0.3),     # G=1, hdv != hd
    (2, 2, 4, 4, 16, 32, 24, [20, 0], None),        # hdv > hd
]


def _spec_inputs(seed, B, K, S, G, hd, hdv, Smax):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, S, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, K, hdv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,K,S,G,hd,hdv,Smax,lengths,scale", SPEC_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_flash_decode_spec_matches_jax(B, K, S, G, hd, hdv, Smax, lengths,
                                       scale, lowp):
    q, k, v = _spec_inputs(Smax + S, B, K, S, G, hd, hdv, Smax)
    lens = np.asarray(lengths, np.int32)
    want = jfa.flash_decode_spec(*map(jnp.asarray, (q, k, v, lens)),
                                 scale=scale, block_k=8, lowp=lowp)
    got = tfa.flash_decode_spec(*map(torch.from_numpy, (q, k, v, lens)),
                                scale=scale, lowp=lowp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **(BF16 if lowp else F32))


@pytest.mark.parametrize("B,K,S,G,hd,hdv,Smax,lengths,scale", SPEC_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_flash_decode_spec_paged_matches_jax(B, K, S, G, hd, hdv, Smax, lengths,
                                             scale, lowp):
    """Pools with a shuffled table holding out-of-range entries (clamped by
    both), T*bs = Smax so the window-past-capacity cases carry over."""
    bs = 8
    T, NB = Smax // bs, B * (Smax // bs) + 3
    rng = np.random.default_rng(S * G)
    q = rng.standard_normal((B, K, S, G, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, hdv)).astype(np.float32)
    table = rng.integers(-2, NB + 2, (B, T)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    want = jfa.flash_decode_spec_paged(*map(jnp.asarray, (q, kp, vp, table, lens)),
                                       scale=scale, lowp=lowp)
    got = tfa.flash_decode_spec_paged(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                                      scale=scale, lowp=lowp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **(BF16 if lowp else F32))


@pytest.mark.parametrize("paged", [False, True])
def test_ops_decode_attention_spec_matches_jax(paged):
    B, S, H, K, hd, bs, T = 3, 3, 8, 2, 16, 4, 6
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    lens = np.asarray([2, 17, 9], np.int32)
    if paged:
        NB = B * T + 1
        kp, vp = (rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
                  for _ in range(2))
        table = rng.permutation(np.arange(1, NB)).reshape(B, T).astype(np.int32)
        want = jops.decode_attention_spec_paged(*map(jnp.asarray,
                                                     (q, kp, vp, table, lens)))
        got = ops.decode_attention_spec_paged(*map(torch.from_numpy,
                                                   (q, kp, vp, table, lens)))
    else:
        k, v = (rng.standard_normal((B, T * bs, K, hd)).astype(np.float32)
                for _ in range(2))
        want = jops.decode_attention_spec(*map(jnp.asarray, (q, k, v, lens)))
        got = ops.decode_attention_spec(*map(torch.from_numpy, (q, k, v, lens)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("q_offset", ["vector", 5, 0])
def test_naive_attention_q_offset_matches_jax(q_offset):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    if q_offset == "vector":
        jo, to = jnp.asarray([0, 3, 8]), torch.tensor([0, 3, 8])
    else:
        jo = to = q_offset
    want = jattn.naive_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 q_offset=jo)
    got = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                                q_offset=to)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the verify step on carried-over params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contig", "paged"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_spec_decode_step_matches_jax(tiny, layout, impl):
    """A window of S=3 on ragged cache lengths; in the contiguous case the
    last row's window runs past the cache, which keeps only its first
    position."""
    jparams, tparams = tiny
    B, S, L = 3, 3, TINY.n_layers
    K, hd = TINY.n_kv_heads, TINY.head_dim
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, TINY.vocab_size, (B, S)).astype(np.int32)
    jm = jax_build_model(TINY, impl="naive")
    tm = build_model(TINY, impl=impl, device="cpu")
    if layout == "contig":
        Smax = 16
        cache_len = np.asarray([4, 10, 15], np.int32)
        cache = {n: rng.standard_normal((L, B, Smax, K, hd)).astype(np.float32)
                 for n in ("k", "v")}
        jc = {n: jnp.asarray(a) for n, a in cache.items()}
        tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
        jl, jc = jm.spec_decode_step(jparams, jc, jnp.asarray(tokens),
                                     jnp.asarray(cache_len))
        tl, tc = tm.spec_decode_step(tparams, tc, torch.from_numpy(tokens),
                                     torch.from_numpy(cache_len))
        blocks = slice(None)
    else:
        bs, T, NB = 4, 4, 14
        cache_len = np.asarray([2, 7, 12], np.int32)
        table = rng.permutation(np.arange(1, NB))[:B * T].reshape(B, T).astype(np.int32)
        cache = {n: rng.standard_normal((L, NB, bs, K, hd)).astype(np.float32)
                 for n in ("k", "v")}
        jc = {n: jnp.asarray(a) for n, a in cache.items()}
        tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
        jl, jc = jm.paged_spec_decode_step(jparams, jc, jnp.asarray(tokens),
                                           jnp.asarray(cache_len),
                                           jnp.asarray(table))
        tl, tc = tm.paged_spec_decode_step(tparams, tc, torch.from_numpy(tokens),
                                           torch.from_numpy(cache_len),
                                           torch.from_numpy(table))
        blocks = slice(1, None)  # all live: the null block is not written
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy()[:, blocks],
                                   np.asarray(jc[n])[:, blocks], **TOL)


def test_contig_window_scatter_clamps_like_the_reference():
    """Per-row windows write only in-range positions (an idle row past the
    cache writes nothing); a scalar start clamps to [0, Smax-S]."""
    buf = torch.zeros(3, 6, 1)
    new = torch.arange(1.0, 10.0).reshape(3, 3, 1)
    tattn._scatter_tokens(buf, new, torch.tensor([0, 4, 6]))
    want = torch.zeros(3, 6, 1)
    want[0, 0:3] = new[0]
    want[1, 4:6] = new[1, :2]
    assert torch.equal(buf, want)
    jbuf = jattn._scatter_tokens(jnp.zeros((3, 6, 1)), jnp.asarray(new.numpy()),
                                 jnp.asarray([0, 4, 6]))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    tattn._scatter_tokens(buf, new, 5)
    jbuf = jattn._scatter_tokens(jbuf, jnp.asarray(new.numpy()), jnp.int32(5))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


# ---------------------------------------------------------------------------
# verifier and draft sources
# ---------------------------------------------------------------------------


def test_greedy_verify_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(30):
        S, V = int(rng.integers(1, 6)), 8
        # few distinct values, so ties (first maximum wins) are common
        logits = rng.integers(0, 3, (4, S, V)).astype(np.float32)
        best = logits.argmax(-1)
        drafts = np.where(rng.random((4, S - 1)) < 0.7, best[:, :S - 1],
                          rng.integers(0, V, (4, S - 1))).astype(np.int32)
        jt, jn = jax.device_get(jax_greedy_verify(jnp.asarray(logits),
                                                  jnp.asarray(drafts)))
        tt, tn = greedy_verify(torch.from_numpy(logits), torch.from_numpy(drafts))
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_array_equal(tn.numpy(), jn)


def _drive_ngram(mod, seed: int):
    rng = np.random.default_rng(seed)
    d = mod.NGramDraft(max_n=3)
    out = []
    for _ in range(200):
        op, slot = int(rng.integers(0, 5)), int(rng.integers(0, 3))
        if op == 0:
            d.admit(slot, rng.integers(0, 4, int(rng.integers(0, 9))).tolist())
        elif op == 1:
            d.release(slot)
        elif op <= 3 and slot in d._hist:
            d.commit(slot, rng.integers(0, 4, int(rng.integers(0, 3))).tolist(),
                     int(rng.integers(0, 4)))
        else:
            drafts, probs = d.propose([0, 1, 2], int(rng.integers(1, 5)))
            out.append((drafts.tolist(), probs))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_matches_jax(seed):
    assert _drive_ngram(tdraft, seed) == _drive_ngram(jdraft, seed)


def test_model_draft_rollback_matches_jax(tiny):
    jparams, tparams = tiny
    jd = jdraft.ModelDraft(jax_build_model(TINY, impl="naive"), jparams,
                           max_batch=2, max_seq=32)
    td = tdraft.ModelDraft(build_model(TINY, impl="naive", device="cpu"),
                           tparams, max_batch=2, max_seq=32)
    for d in (jd, td):
        d.admit(0, [3, 4, 5])
        d.admit(1, [9])
    for _ in range(3):
        jdr, _ = jd.propose([0, 1], 3)
        tdr, probs = td.propose([0, 1], 3)
        assert probs is None and tdr.tolist() == jdr.tolist()
        for d in (jd, td):
            d.commit(0, [int(jdr[0, 0])], 99)
            d.commit(1, [], 7)
        assert td.cache_len.tolist() == jd.cache_len.tolist()
    # sampled proposals are ported (tests/test_torch_sampling.py holds them
    # to the reference's): each comes with its draft distribution p
    sd = tdraft.ModelDraft(td.model, tparams, max_batch=1, max_seq=8,
                           temperature=0.5)
    sd.admit(0, [3, 4])
    sdr, sp = sd.propose([0], 2)
    assert sdr.shape == (1, 2) and sp.shape == (1, 2, TINY.vocab_size)
    np.testing.assert_allclose(sp.sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown draft source"):
        tdraft.build_draft_source("no-such-arch", device="cpu")


# ---------------------------------------------------------------------------
# the serve engine: greedy speculative decode against the JAX engine
# ---------------------------------------------------------------------------


def _requests(mod, n=8, seed=0, gen=12):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i,
                        prompt=rng.integers(0, TINY.vocab_size,
                                            int(rng.integers(3, 14))
                                            ).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, gen + 1)))
            for i in range(n)]


def _run(mod, model, params, reqs, **kw):
    engine = mod.ContinuousBatchingEngine(model, params, max_batch=3,
                                          max_seq=64, **kw)
    fin = engine.run(reqs)
    return {u: f.tokens for u, f in fin.items()}, engine


@pytest.fixture(scope="module")
def baseline(tiny):
    jparams, _ = tiny
    return _run(jserve, jax_build_model(TINY, impl="naive"), jparams,
                _requests(jserve))[0]


SPEC_COUNTERS = ("decode_steps", "tokens_out", "spec_rounds", "spec_drafted",
                 "spec_accepted", "prefill_chunks", "cow_copies",
                 "table_rows_shipped")


@pytest.mark.parametrize("layout", ["contig", "paged"])
@pytest.mark.parametrize("depth", [1, 3])
def test_engine_speculative_matches_jax(tiny, baseline, layout, depth):
    jparams, tparams = tiny
    want, jeng = _run(jserve, jax_build_model(TINY, impl="naive"), jparams,
                      _requests(jserve), kv_layout=layout, draft_depth=depth)
    assert want == baseline
    jst = jeng.stats()
    for impl in ("naive", "pallas"):
        got, teng = _run(tserve, build_model(TINY, impl=impl, device="cpu"),
                         tparams, _requests(tserve), kv_layout=layout,
                         draft_depth=depth)
        assert got == want, impl
        tst = teng.stats()
        for key in SPEC_COUNTERS:
            assert tst.get(key) == jst.get(key), (impl, key)
        assert tst["spec_rounds"] > 0


def test_engine_model_draft_matches_jax(tiny, baseline):
    jparams, tparams = tiny
    dcfg = dataclasses.replace(TINY, name="spec-draft", n_layers=1, d_ff=64)
    jdm = jax_build_model(dcfg, impl="naive")
    jdp = jdm.init(jax.random.PRNGKey(5))
    jd = jdraft.ModelDraft(jdm, jdp, max_batch=3, max_seq=64)
    td = tdraft.ModelDraft(build_model(dcfg, impl="naive", device="cpu"),
                           _convert(jdp), max_batch=3, max_seq=64)
    want, jeng = _run(jserve, jax_build_model(TINY, impl="naive"), jparams,
                      _requests(jserve), draft_depth=2, draft_source=jd)
    got, teng = _run(tserve, build_model(TINY, impl="pallas", device="cpu"),
                     tparams, _requests(tserve), draft_depth=2, draft_source=td)
    assert got == want == baseline
    assert teng.spec_accepted == jeng.spec_accepted
    assert teng.spec_drafted == jeng.spec_drafted


@pytest.mark.parametrize("layout", ["contig", "paged"])
def test_set_draft_depth_mid_stream_matches_jax(tiny, baseline, layout):
    """Walking the draft-depth rung every step changes how many verify
    rounds the tokens take, never which tokens."""
    jparams, tparams = tiny
    runs = []
    for mod, model, params in (
            (jserve, jax_build_model(TINY, impl="naive"), jparams),
            (tserve, build_model(TINY, impl="pallas", device="cpu"), tparams)):
        engine = mod.ContinuousBatchingEngine(model, params, max_batch=3,
                                              max_seq=64, kv_layout=layout,
                                              draft_depth=4)
        for r in _requests(mod):
            engine.submit(r)
        depths, i = [4, 2, 0, 3, 1], 0
        while engine.has_work:
            engine.set_draft_depth(depths[i % len(depths)])
            engine.step()
            i += 1
        engine.set_draft_depth(None)
        runs.append(({u: f.tokens for u, f in engine.finished.items()},
                     engine.draft_depth, engine.spec_accepted,
                     engine.decode_steps))
    assert runs[0] == runs[1]
    assert runs[1][0] == baseline and runs[1][1] == 4


def test_late_enable_draft_depth_matches_jax(tiny):
    jparams, tparams = tiny
    runs = []
    for mod, model, params in (
            (jserve, jax_build_model(TINY, impl="naive"), jparams),
            (tserve, build_model(TINY, impl="naive", device="cpu"), tparams)):
        engine = mod.ContinuousBatchingEngine(model, params, max_batch=2,
                                              max_seq=64)
        assert engine.draft is None
        for r in _requests(mod, 4, seed=3):
            engine.submit(r)
        for _ in range(3):
            engine.step()
        engine.set_draft_depth(3)
        assert engine.draft is not None
        while engine.has_work:
            engine.step()
        runs.append(({u: f.tokens for u, f in engine.finished.items()},
                     engine.spec_rounds, engine.spec_accepted))
    assert runs[0] == runs[1] and runs[1][1] > 0


def test_cli_serves_speculative_on_the_cpu(tmp_path):
    import json
    out = tmp_path / "serve.json"
    done = tserve.main(["--reduced", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen", "4", "--attn-impl",
                        "pallas", "--kv-layout", "paged", "--draft-depth", "3",
                        "--device", "cpu", "--json-out", str(out)])
    assert sorted(done) == [0, 1, 2]
    st = json.loads(out.read_text())["stats"]
    assert st["draft_depth"] == 3 and st["spec_rounds"] > 0
