"""The port's paged KV cache against the JAX package's.

Host side: the port's copies of ``BlockPool``, ``PrefixIndex`` and
``PagedKVCache`` are driven by the same seeded random operation sequence as
the reference's, and every table, event, refcount and ``stats()`` must be
identical. Device side: ``flash_decode_paged`` (its plain version on the
CPU) against the reference's Pallas kernel in interpret mode, at the
tolerances of ``tests/test_kernels.py`` (2e-5 at f32, 5e-2 with bf16 dot
inputs); the paged decode and chunked paged prefill steps on carried-over
params (logits and pools to 1e-4, f32 summation order); and the serve
engine, token for token and counter for counter, on the scenarios of
``tests/test_paging.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import paging as jpaging
from repro.configs import ASSIGNED
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro_torch import paging as tpaging
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.attention import _scatter_tokens_paged
from repro_torch.models.convert import from_numpy_tree

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = ASSIGNED["llama3.2-1b"].reduced()


@pytest.fixture(scope="module")
def params():
    jparams = jax_build_model(CFG).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# host modules: one random operation sequence through both copies
# ---------------------------------------------------------------------------


def _drive_paged_cache(mod, seed: int, steps: int = 150):
    """Random admit (with prefix matching and indexing) / append (alloc,
    COW, in place) / release over a small pool, so the cached-free tier
    fills and evicts. Returns everything observable after each operation."""
    rng = np.random.default_rng(seed)
    kv = mod.PagedKVCache(num_blocks=12, block_size=4, max_batch=3,
                          max_blocks_per_seq=5, prefix_cache=True)
    # few distinct prompts over a 3-token vocabulary: prefix hits, partial
    # tails and identical prompts are common
    prompts = [rng.integers(0, 3, int(rng.integers(1, 15))).astype(np.int32)
               for _ in range(5)]
    live, seq, trace = {}, 0, []
    for _ in range(steps):
        op, slot = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        try:
            if op <= 1 and slot not in live:
                toks = prompts[int(rng.integers(len(prompts)))]
                shared, covered = kv.match_prefix(toks)
                blocks = kv.admit(slot, ("s", seq), len(toks), shared=shared)
                trace.append(("admit", slot, shared, covered, blocks,
                              kv.index_prompt(slot, toks)))
                live[slot] = len(toks)
                seq += 1
            elif op <= 4 and slot in live:
                ev = kv.append(slot, live[slot])
                trace.append(("append", slot, None if ev is None else
                              (ev.kind, ev.block, ev.src)))
                live[slot] += 1
            elif slot in live:
                trace.append(("release", slot, kv.release(slot)))
                del live[slot]
        except (mod.BlockPoolExhausted, ValueError) as e:
            trace.append(("refused", type(e).__name__, str(e)))
        kv.pool.check_invariants()
        live_tokens = {kv._slot_seq[s]: n for s, n in live.items()}
        trace.append((kv.tables.tolist(), kv.take_dirty(),
                      kv.stats(live_tokens),
                      [kv.pool.refcount(b) for b in range(kv.pool.num_blocks)]))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_paged_cache_host_modules_match_jax(seed):
    got = _drive_paged_cache(tpaging, seed)
    want = _drive_paged_cache(jpaging, seed)
    assert got == want
    kinds = {t[2][0] for t in got if t[0] == "append" and t[2] is not None}
    if seed == 0:  # the sequence exercises both boundary allocs and COW
        assert kinds == {"alloc", "cow"}


def test_block_pool_and_prefix_index_semantics_match_jax():
    for mod in (tpaging, jpaging):
        pool = mod.BlockPool(num_blocks=6, block_size=4)
        evicted, indexed = [], set()
        pool.cache_filter = lambda blk: blk in indexed
        pool.on_evict = lambda blk: (indexed.discard(blk), evicted.append(blk))
        a = pool.allocate("a", 12)
        indexed.update(a)
        pool.free("a")
        pool.allocate("b", 12, shared=a[:2])
        pool.allocate("c", 8)  # overflows the free list: evicts cached LRU
        with pytest.raises(mod.BlockPoolExhausted):
            pool.allocate("d", 4)
        idx = mod.PrefixIndex(block_size=4)
        toks = np.arange(10, dtype=np.int32)
        idx.insert(toks, [5, 6, 7])
        out = (evicted, pool.stats(), idx.match(toks),
               idx.match(np.concatenate([toks[:8], [1, 2, 3]]).astype(np.int32)),
               idx.stats())
        if mod is tpaging:
            got = out
    assert got == out


def test_gather_paged_kv_matches_jax():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    table = np.asarray([[3, 1, -2], [6, 9, 0]], np.int32)  # out of range clips
    want = jpaging.gather_paged_kv(jnp.asarray(pool), jnp.asarray(table))
    got = tpaging.gather_paged_kv(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flash_decode_paged and ops.decode_attention_paged
# ---------------------------------------------------------------------------

PAGED_CASES = [  # B, K, G, hd, hdv, bs, T, NB, lengths, scale
    (4, 2, 4, 16, 16, 4, 6, 20, [0, 7, 24, 31], None),   # idle row, > T*bs
    (3, 1, 1, 32, 16, 8, 3, 9, [9, 0, 24], 0.3),          # G=1, hdv != hd
    (2, 2, 4, 16, 32, 4, 5, 11, [20, 13], None),          # hdv > hd
]


def _paged_inputs(seed, B, K, G, hd, hdv, bs, T, NB):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, hdv)).astype(np.float32)
    # a shuffled table with entries outside [0, NB-1] (clamped by both)
    table = rng.integers(-3, NB + 3, (B, T)).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("B,K,G,hd,hdv,bs,T,NB,lengths,scale", PAGED_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_flash_decode_paged_matches_jax(B, K, G, hd, hdv, bs, T, NB, lengths,
                                        scale, lowp):
    q, kp, vp, table = _paged_inputs(B * T, B, K, G, hd, hdv, bs, T, NB)
    lens = np.asarray(lengths, np.int32)
    want = jfa.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(table),
                                  jnp.asarray(lens), scale=scale, lowp=lowp)
    got = tfa.flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                                 scale=scale, lowp=lowp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **(BF16 if lowp else F32))
    assert not np.any(_np(got)[lens == 0]), "a length-0 row must return zeros"


@pytest.mark.parametrize("lengths", [[3, 9, 16], 7])
def test_ops_decode_attention_paged_matches_jax(lengths):
    B, H, K, hd, bs, T, NB = 3, 8, 2, 16, 4, 4, 13
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, NB))[:B * T].reshape(B, T).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    want = jops.decode_attention_paged(*map(jnp.asarray, (q, kp, vp, table, lens)))
    got = ops.decode_attention_paged(*map(torch.as_tensor, (q, kp, vp, table, lens)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_paged_wrapper_refuses_bad_tables():
    q, kp = torch.zeros(2, 1, 2, 8), torch.zeros(5, 4, 1, 8)
    with pytest.raises(ValueError, match="block_table"):
        tfa.flash_decode_paged(q, kp, kp, torch.zeros(3, 2, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="does not match pools"):
        tfa.flash_decode_paged(q, kp, torch.zeros(5, 4, 2, 8),
                               torch.zeros(2, 2, dtype=torch.int32), 1)
    with pytest.raises(NotImplementedError, match="forward only"):
        tfa.flash_decode_paged(q.requires_grad_(), kp, kp,
                               torch.zeros(2, 2, dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# model steps on carried-over params
# ---------------------------------------------------------------------------


def _pools(seed, NB, bs):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, NB, bs, CFG.n_kv_heads, CFG.head_dim)
    return {n: rng.standard_normal(shape).astype(np.float32) * 0.5
            for n in ("k", "v")}


def _both_pools(np_pools):
    return ({n: jnp.asarray(a) for n, a in np_pools.items()},
            {n: torch.from_numpy(a.copy()) for n, a in np_pools.items()})


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_paged_decode_step_matches_jax(params, impl):
    """Three live rows with private, shuffled blocks and ragged lengths (one
    crossing into a fresh block), plus an idle row on the null block."""
    jparams, tparams = params
    bs, T, NB = 4, 5, 16
    table = np.zeros((4, T), np.int32)
    table[:3] = np.random.default_rng(2).permutation(np.arange(1, NB))[:3 * T] \
        .reshape(3, T)
    cache_len = np.asarray([3, 8, 17, 11], np.int32)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, (4, 1)).astype(np.int32)
    jc, tc = _both_pools(_pools(5, NB, bs))
    jm = jax_build_model(CFG, impl="naive")
    tm = build_model(CFG, impl=impl, device="cpu")
    jl, jc = jm.paged_decode_step(jparams, jc, jnp.asarray(tokens),
                                  jnp.asarray(cache_len), jnp.asarray(table))
    tl, tc = tm.paged_decode_step(tparams, tc, torch.from_numpy(tokens),
                                  torch.from_numpy(cache_len),
                                  torch.from_numpy(table))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    # every block but the null block, which the idle row wrote (a duplicate
    # index there keeps an arbitrary value)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n][:, 1:].numpy(), np.asarray(jc[n])[:, 1:],
                                   **TOL)


@pytest.mark.parametrize("write", [True, False])
def test_paged_prefill_chunk_matches_jax(params, write):
    """One chunk of paged prefill at a block-aligned start, writing and
    read-only; logits of a chosen last position and the pools after."""
    jparams, tparams = params
    bs, T, NB = 4, 4, 9
    table = np.asarray([[6, 2, 8, 3]], np.int32)
    tokens = np.random.default_rng(7).integers(0, CFG.vocab_size, (1, bs)).astype(np.int32)
    jc, tc = _both_pools(_pools(8, NB, bs))
    jm = jax_build_model(CFG, impl="naive")
    tm = build_model(CFG, impl="pallas", device="cpu")
    jl, jc2 = jm.paged_prefill_step(jparams, jc, jnp.asarray(tokens), jnp.int32(8),
                                    jnp.asarray(table), jnp.int32(2), write)
    before = {n: t.clone() for n, t in tc.items()}
    tl, tc2 = tm.paged_prefill_step(tparams, tc, torch.from_numpy(tokens), 8,
                                    torch.from_numpy(table), 2, write)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc2[n].numpy(), np.asarray(jc2[n]), **TOL)
        if not write:
            assert torch.equal(tc2[n], before[n])


def test_paged_scatter_leaves_live_blocks_alone_under_duplicate_null_writes():
    """Idle rows all pointing at null block 0 write the same null positions:
    only block 0 changes, and every live row's own block gets its value."""
    pool = torch.zeros(6, 4, 1, 2)
    table = torch.tensor([[0, 0], [3, 5], [0, 0], [0, 0]])
    new = torch.arange(1, 4 * 2 * 2 + 1, dtype=torch.float32).reshape(4, 2, 1, 2)
    before = pool.clone()
    _scatter_tokens_paged(pool, new, torch.tensor([2, 3, 2, 6]), table)
    assert torch.equal(pool[[1, 2, 4]], before[[1, 2, 4]])
    assert torch.equal(pool[3, 3], new[1, 0]) and torch.equal(pool[5, 0], new[1, 1])


# ---------------------------------------------------------------------------
# the serve engine, token for token against the JAX engine
# ---------------------------------------------------------------------------


def _reqs(mod, specs):
    return [mod.Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for u, (p, n) in enumerate(specs)]


def _serve(params, specs, impl="naive", torch_side=True, **kw):
    jparams, tparams = params
    kw = {"max_batch": 2, "max_seq": 32, **kw}
    if torch_side:
        engine = tserve.ContinuousBatchingEngine(
            build_model(CFG, impl=impl, device="cpu"), tparams, **kw)
        done = engine.run(_reqs(tserve, specs))
    else:
        engine = jserve.ContinuousBatchingEngine(
            jax_build_model(CFG, impl="naive"), jparams, **kw)
        done = engine.run(_reqs(jserve, specs))
    return {u: (f.tokens, f.reason) for u, f in done.items()}, engine


COUNTERS = ("decode_steps", "tokens_out", "prefill_chunks",
            "prefill_chunks_skipped", "cow_copies", "table_rows_shipped",
            "table_uploads", "swap_outs", "swap_ins", "swapped",
            "prefill_buckets", "peak_kv_bytes", "kv_bytes")


def _parity(params, specs, impls=("naive", "pallas"), **kw):
    """Both ports' impls against the JAX engine: streams, every engine
    counter and the pool's stats. Returns the port's (streams, engine)."""
    want, jeng = _serve(params, specs, torch_side=False, **kw)
    jst = jeng.stats()
    for impl in impls:
        got, teng = _serve(params, specs, impl=impl, **kw)
        assert got == want, impl
        tst = teng.stats()
        for key in COUNTERS:
            assert tst.get(key) == jst.get(key), (impl, key)
        assert tst["pool"] == jst["pool"]
        assert teng.occupancy == pytest.approx(jeng.occupancy)
    return got, teng


def _ragged(seed=1, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, 4 + 3 * i), 3 + i) for i in range(n)]


def test_engine_paged_token_identical_to_contig(params):
    """Queueing, mid-stream retirement, freed-slot admission and ragged
    lengths through the paged cache == the contiguous slabs; block_size 4
    forces mid-decode boundary allocations."""
    specs = _ragged()
    contig, _ = _serve(params, specs, kv_layout="contig")
    got, eng = _parity(params, specs, kv_layout="paged", block_size=4)
    assert got == contig
    st = eng.stats()
    assert st["pool"]["blocks_in_use"] == 0 and st["pool"]["peak_blocks_in_use"] > 0
    assert st["peak_kv_bytes"] < st["kv_bytes"] or st["kv_bytes"] == 0


def test_engine_paged_admission_waits_for_pool_capacity(params):
    specs = [(np.arange(2, 10), 4)] * 2
    roomy, _ = _serve(params, specs, kv_layout="paged", block_size=4)
    tight, eng = _parity(params, specs, kv_layout="paged", block_size=4,
                         num_blocks=6)
    assert tight == roomy
    assert eng.stats()["pool"]["peak_blocks_in_use"] <= 5
    assert eng.occupancy <= 0.5  # the two requests were serialized


def test_engine_paged_rejects_impossible_prompt(params):
    engine = tserve.ContinuousBatchingEngine(
        build_model(CFG, impl="naive", device="cpu"), params[1], max_batch=1,
        max_seq=32, kv_layout="paged", block_size=4, num_blocks=3)
    with pytest.raises(ValueError, match="never be resident"):
        engine.submit(tserve.Request(uid=0, prompt=np.arange(12, dtype=np.int32),
                                     max_new_tokens=2))


def test_engine_prefix_sharing_skips_chunks(params):
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 64, 12)  # 3 full blocks of 4
    specs = [(np.concatenate([prefix, rng.integers(0, 64, 2 + i)]), 3)
             for i in range(4)]
    off, eng_off = _serve(params, specs, kv_layout="paged", block_size=4,
                          prefix_cache=False)
    on, eng_on = _parity(params, specs, kv_layout="paged", block_size=4)
    assert on == off
    st = eng_on.stats()
    assert st["prefill_chunks_skipped"] > 0
    assert st["prefill_chunks"] < eng_off.stats()["prefill_chunks"]
    assert st["pool"]["prefix"]["hit_rate"] > 0


def test_engine_prefix_cow_on_identical_prompts(params):
    """Identical prompts share every block incl. the partial tail (a
    read-only recompute of the last chunk); two divergences pay a copy."""
    specs = [(np.arange(3, 13), 4)] * 3
    off, _ = _serve(params, specs, kv_layout="paged", block_size=4,
                    max_batch=3, prefix_cache=False)
    on, eng = _parity(params, specs, kv_layout="paged", block_size=4,
                      max_batch=3)
    assert on == off and all(on[0] == on[u] for u in on)
    st = eng.stats()
    assert st["cow_copies"] == 2 == st["pool"]["total_cow"]
    assert st["pool"]["blocks_in_use"] == 0


def test_engine_swap_over_committed_pool(params):
    specs = [(np.arange(2, 10), 4)] * 3
    roomy, _ = _serve(params, specs, kv_layout="paged", block_size=4)
    tight, eng = _parity(params, specs, kv_layout="paged", block_size=4,
                         num_blocks=6, admission_policy="swap",
                         prefix_cache=False)
    assert tight == roomy
    st = eng.stats()
    assert st["swap_outs"] >= 1 and st["swap_outs"] == st["swap_ins"]
    assert st["swapped"] == 0 and st["pool"]["blocks_in_use"] == 0


def test_engine_swap_in_restores_the_blocks_bitwise(params):
    """The blocks a swapped-out sequence held come back value for value,
    into whatever fresh blocks swap-in allocates."""
    engine = tserve.ContinuousBatchingEngine(
        build_model(CFG, impl="pallas", device="cpu"), params[1], max_batch=2,
        max_seq=32, kv_layout="paged", block_size=4, num_blocks=6,
        admission_policy="swap", prefix_cache=False)
    seen = {}
    swap_out, swap_in = engine._swap_out, engine._swap_in

    def spy_out(slot):
        blocks = torch.tensor(engine.kv.slot_blocks(slot))
        seen[engine.slot_uid[slot]] = {n: p[:, blocks].clone()
                                       for n, p in engine.cache.items()}
        swap_out(slot)

    def spy_in(slot, sw):
        swap_in(slot, sw)
        blocks = torch.tensor(engine.kv.slot_blocks(slot))
        for n, p in engine.cache.items():
            assert torch.equal(p[:, blocks], seen[sw.uid][n])
        seen[sw.uid] = "restored"

    engine._swap_out, engine._swap_in = spy_out, spy_in
    engine.run(_reqs(tserve, [(np.arange(2, 10), 4)] * 3))
    assert seen and all(v == "restored" for v in seen.values())


def test_engine_swap_needs_paged_and_shed_rejects(params):
    model = build_model(CFG, impl="naive", device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tserve.ContinuousBatchingEngine(model, params[1], max_batch=2,
                                        max_seq=32, admission_policy="swap")
    specs = [(np.arange(2, 10), 4)] * 3
    got, eng = _parity(params, specs, impls=("naive",), kv_layout="paged",
                       block_size=4, num_blocks=6, admission_policy="shed")
    want, jeng = _serve(params, specs, torch_side=False, kv_layout="paged",
                        block_size=4, num_blocks=6, admission_policy="shed")
    assert eng.rejected == {u: tserve.Rejected(**vars(r))
                            for u, r in jeng.rejected.items()}
    assert eng.stats()["shed"] == jeng.stats()["shed"] > 0


def test_engine_dirty_rows_ship_only_changes(params):
    _, engine = _parity(params, _ragged(), impls=("pallas",),
                        kv_layout="paged", block_size=4)
    st = engine.stats()
    assert 0 < st["table_rows_shipped"] < engine.decode_steps * engine.max_batch
    pending = set(engine.kv.take_dirty())  # releases after the last decode
    for row in range(engine.max_batch):
        if row not in pending:
            np.testing.assert_array_equal(engine._dev_tables[row].numpy(),
                                          engine.kv.tables[row])


def test_engine_refuses_what_is_not_ported(params):
    model = build_model(CFG, impl="naive", device="cpu")
    # sampling is ported now (tests/test_torch_sampling.py holds its streams
    # to the reference's): a sampled engine builds and serves, paged too
    sampled = tserve.ContinuousBatchingEngine(model, params[1], max_batch=1,
                                              max_seq=16, temperature=0.7,
                                              kv_layout="paged")
    done = sampled.run([tserve.Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                                       max_new_tokens=3)])
    assert len(done[0].tokens) == 3 and sampled._sampler is not None
    # deadlines, drain, hold_blocks and the rung knobs are ported too
    # (tests/test_torch_robustness.py and tests/test_torch_arbitration.py
    # hold them to the reference)
    engine = tserve.ContinuousBatchingEngine(model, params[1], max_batch=1,
                                             max_seq=16, kv_layout="paged")
    assert engine.submit(tserve.Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                                        max_new_tokens=2, deadline_steps=4))
    assert engine.hold_blocks(2) == 1 == engine.stats()["held_blocks"]  # all it has
    engine.release_held()
    engine.set_slot_cap(1)
    engine.set_kv_dtype("bfloat16")
    engine.set_attn_impl("pallas")
    engine.run([])
    assert engine.finished[0].reason == "length"
    engine.set_kv_dtype(None)
    assert engine.cache["k"].dtype == torch.float32
    engine.drain()
    assert not engine.submit(tserve.Request(uid=1, prompt=np.arange(3, dtype=np.int32),
                                            max_new_tokens=2))
    assert engine.rejected[1].reason == "draining"


def test_cli_serves_paged_on_the_cpu(tmp_path):
    import json
    out = tmp_path / "serve.json"
    done = tserve.main(["--reduced", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen", "3", "--attn-impl",
                        "pallas", "--kv-layout", "paged", "--block-size", "4",
                        "--device", "cpu", "--json-out", str(out)])
    assert sorted(done) == [0, 1, 2]
    st = json.loads(out.read_text())["stats"]
    assert st["kv_layout"] == "paged" and st["prefill_chunks"] > 0
    assert st["kernel_launches"]["flash_decode_paged"] == 0  # CPU: plain version
