"""The port's sampled serving against the JAX package's.

``repro_torch.prng`` against ``jax.random`` at the same keys: ``PRNGKey``,
nested ``fold_in``, raw bits and ``uniform`` bit for bit, ``gumbel`` within
1e-6 (relative above 1: ``log`` differs by an ulp), ``categorical`` under
the stream rule; ``mask_logits`` and ``sample_probs`` within 1e-6, ties at
the k-th logit kept; ``rejection_verify`` on the same logits, drafts, probs
and keys; the reference's own sampling tests run on the port; and the serve
engine's sampled streams against the JAX engine's from converted
parameters, on every serving path.

The stream rule: two sampled streams of a request are equal up to their
first difference, and at that position the port's decision lies within
``NEAR_TIE`` of a tie — the top-2 margin of the Gumbel-perturbed logits it
drew from, or ``|u·p(d) − q(d)|`` of the accept test. Logits differ from
JAX's by ~1e-6 (f32 summation order), so only such a decision can flip.
The port's margins are recorded while it serves (``_Margins``) and every
flip is printed with its margin.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ModelConfig
from repro.launch import sampling as jsampling
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro.spec import draft as jdraft
from repro.spec.verify import rejection_verify as jax_rejection_verify
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.launch import sampling
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_tree
from repro_torch.spec import draft as tdraft
from repro_torch.spec.verify import rejection_verify

NEAR_TIE = 1e-4
GUMBEL = dict(rtol=1e-6, atol=1e-6)
TINY = ModelConfig(name="sample-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   tie_embeddings=True, source="tests/test_spec.py")
KW = dict(temperature=0.9, top_k=32, sample_seed=1)  # spec_bench's kw


def _jkeys(seed, uids, idxs):
    """JAX's fold_in(fold_in(PRNGKey(seed), uid), index) over arrays."""
    base = jax.random.PRNGKey(seed)
    f = jax.vmap(lambda u, i: jax.random.fold_in(jax.random.fold_in(base, u), i))
    shape = np.shape(uids)
    out = f(jnp.asarray(np.ravel(uids), jnp.int32),
            jnp.asarray(np.ravel(idxs), jnp.int32))
    return np.asarray(out).reshape(shape + (2,))


_jax_categorical = jax.jit(jax.vmap(jax.random.categorical))


def _tkeys(seed, uids, idxs):
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), np.asarray(uids)),
                        np.asarray(idxs))


def _top2(x: torch.Tensor) -> torch.Tensor:
    """The margin between the two largest values of each row (inf where the
    second is -inf: no tie is possible)."""
    if x.shape[-1] < 2:
        return torch.full(x.shape[:-1], math.inf)
    v = torch.topk(x, 2, dim=-1).values
    return torch.where(torch.isinf(v[..., 1]), torch.full_like(v[..., 0], math.inf),
                       v[..., 0] - v[..., 1])


# ---------------------------------------------------------------------------
# prng against jax.random
# ---------------------------------------------------------------------------

SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (1000,)]


@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 2 ** 31 - 1),
       st.integers(0, 2 ** 31 - 1), st.sampled_from(SHAPES))
@settings(max_examples=30, deadline=None)
def test_prng_matches_jax_bit_for_bit(seed, uid, index, shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), uid),
                            index)
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), uid), index)
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(k, np.asarray(jk))
    t = torch.from_numpy(k)
    np.testing.assert_array_equal(prng.random_bits(t, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        prng.uniform(t, shape).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.int32))
    np.testing.assert_allclose(prng.gumbel(t, shape).numpy(),
                               np.asarray(jax.random.gumbel(jk, shape)),
                               **GUMBEL)


def test_prng_batched_keys_match_jax_at_the_full_vocabulary():
    """(2, 128256): the engine's vmapped draws at llama3.2-1b's vocabulary,
    from torch keys (2, 2) derived on the host."""
    V = 128256
    uids, idxs = np.asarray([0, 2 ** 31 - 1]), np.asarray([5, 0])
    jk = _jkeys(7, uids, idxs)
    k = _tkeys(7, uids, idxs)
    np.testing.assert_array_equal(k, jk)
    t = torch.from_numpy(k)
    bits = jax.vmap(lambda kk: jax.random.bits(kk, (V,)))(jnp.asarray(jk))
    np.testing.assert_array_equal(prng.random_bits(t, (V,)).numpy(),
                                  np.asarray(bits))
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (V,)))(jnp.asarray(jk))
    np.testing.assert_array_equal(prng.uniform(t, (V,)).numpy(), np.asarray(u))
    g = jax.vmap(lambda kk: jax.random.gumbel(kk, (V,)))(jnp.asarray(jk))
    np.testing.assert_allclose(prng.gumbel(t, (V,)).numpy(), np.asarray(g),
                               **GUMBEL)
    logits = np.random.default_rng(0).standard_normal((2, V)).astype(np.float32)
    want = np.asarray(_jax_categorical(jnp.asarray(jk), jnp.asarray(logits)))
    got = prng.categorical(t, torch.from_numpy(logits)).numpy()
    _same_draws(got, want, t, torch.from_numpy(logits))


def _same_draws(got, want, keys, logits):
    """Categorical draws equal but where the port's perturbed top-2 margin
    is a near tie."""
    margin = _top2(logits + prng.gumbel(keys, (logits.shape[-1],))).numpy()
    for r in np.flatnonzero(got != want):
        print(f"categorical row {r}: {got[r]} vs {want[r]}, margin {margin[r]:.3g}")
        assert margin[r] < NEAR_TIE


@given(st.integers(0, 2 ** 16), st.sampled_from([1, 2, 50, 1000]))
@settings(max_examples=15, deadline=None)
def test_categorical_matches_jax_under_the_stream_rule(seed, V):
    rng = np.random.default_rng(seed)
    B = 16
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    uids, idxs = rng.integers(0, 2 ** 31, B), rng.integers(0, 4096, B)
    jk, k = _jkeys(seed, uids, idxs), _tkeys(seed, uids, idxs)
    want = np.asarray(_jax_categorical(jnp.asarray(jk), jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(k), torch.from_numpy(logits))
    _same_draws(got.numpy(), want, torch.from_numpy(k), torch.from_numpy(logits))


# ---------------------------------------------------------------------------
# logits shaping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.3, 0.9, 1.0, 5.0])
@pytest.mark.parametrize("top_k", [0, 1, 4, 9])
def test_mask_logits_and_sample_probs_match_jax(temperature, top_k):
    """(2, 3, 20) windows with ties at the k-th logit: every tied logit
    survives the mask in both."""
    rng = np.random.default_rng(top_k)
    lg = np.round(rng.standard_normal((2, 3, 20)), 1).astype(np.float32)
    lg[0, 0, :6] = 9.0  # a six-way tie at the top: k of 1..5 keeps all six
    lg[1, 2, 3:9] = -0.25
    want = np.asarray(jsampling.mask_logits(jnp.asarray(lg), temperature, top_k))
    got = sampling.mask_logits(torch.from_numpy(lg), temperature, top_k).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert (np.isfinite(got).sum(-1) >= min(top_k or 20, 20)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        sampling.sample_probs(torch.from_numpy(lg), temperature, top_k).numpy(),
        np.asarray(jsampling.sample_probs(jnp.asarray(lg), temperature, top_k)),
        rtol=1e-6, atol=1e-6)
    if top_k == 4:
        assert np.isfinite(got[0, 0]).sum() == 6
    with pytest.raises(ValueError, match="temperature > 0"):
        sampling.mask_logits(torch.from_numpy(lg), 0.0)


# ---------------------------------------------------------------------------
# rejection_verify
# ---------------------------------------------------------------------------


def _verify_margins(logits, drafts, draft_probs, keys, temperature, top_k):
    """(B, S) margin of the port's decisions at each window position: the
    accept test's |u·p(d) − q(d)| (positions < S-1) and the resample's
    perturbed top-2 margin, the smaller of the two."""
    q = sampling.sample_probs(logits, temperature, top_k)
    B, S, V = q.shape
    u = prng.uniform(prng.fold_in(keys, 0))
    out = torch.full((B, S), math.inf)
    fb = q
    if S > 1:
        d = torch.as_tensor(drafts).long()
        qd = torch.gather(q[:, :-1], -1, d[..., None])[..., 0]
        if draft_probs is None:
            pd = torch.ones_like(qd)
            resid = torch.clamp_min(
                q[:, :-1] - torch.nn.functional.one_hot(d, V) * qd[..., None], 0)
        else:
            p = torch.as_tensor(draft_probs).float()
            pd = torch.gather(p, -1, d[..., None])[..., 0]
            resid = torch.clamp_min(q[:, :-1] - p, 0)
        out[:, :-1] = (u[:, :-1] * pd - qd).abs()
        total = resid.sum(-1, keepdim=True)
        fb = torch.cat([torch.where(total > 0, resid / total.clamp_min(1e-30),
                                    q[:, :-1]), q[:, -1:]], 1)
    lg = torch.where(fb > 0, torch.log(fb), float("-inf"))
    pert = lg + prng.gumbel(prng.fold_in(keys, 1), (V,))
    return torch.minimum(out, _top2(pert))


def _same_verdicts(got, want, margins):
    (tg, ng), (tw, nw) = got, want
    for b in range(tw.shape[0]):
        a, w = list(tg[b, :ng[b]]), list(tw[b, :nw[b]])
        if a == w:
            continue
        i = next((j for j in range(min(len(a), len(w))) if a[j] != w[j]),
                 min(len(a), len(w)))
        print(f"verify row {b}: {a} vs {w} at {i}, margin {margins[b, i]:.3g}")
        assert margins[b, i] < NEAR_TIE


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("with_probs", [False, True])
@pytest.mark.parametrize("top_k", [0, 7])
def test_rejection_verify_matches_jax(S, with_probs, top_k):
    B, V, T = 24, 50, 0.8
    rng = np.random.default_rng(S * 10 + top_k + with_probs)
    logits = (rng.standard_normal((B, S, V)) * 2).astype(np.float32)
    p = rng.dirichlet(np.full(V, 0.5), size=(B, S - 1)).astype(np.float32)
    # half the drafts from p, half the target's argmax (often accepted)
    drafts = np.where(rng.random((B, S - 1)) < 0.5,
                      logits[:, :-1].argmax(-1),
                      [[rng.choice(V, p=pp / pp.sum()) for pp in row] for row in p]
                      ).astype(np.int32).reshape(B, S - 1)
    probs = p if with_probs else None
    uids = np.broadcast_to(rng.integers(0, 1000, B)[:, None], (B, S))
    idxs = rng.integers(0, 50, B)[:, None] + np.arange(S)[None]
    jk, k = _jkeys(3, uids, idxs), _tkeys(3, uids, idxs)
    np.testing.assert_array_equal(k, jk)
    want = jax_rejection_verify(
        jnp.asarray(logits), jnp.asarray(drafts),
        None if probs is None else jnp.asarray(probs), jnp.asarray(jk),
        temperature=T, top_k=top_k)
    got = rejection_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        None if probs is None else torch.from_numpy(probs),
        torch.from_numpy(k), temperature=T, top_k=top_k)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[0].shape == (B, S) and got[1].shape == (B,)
    margins = _verify_margins(torch.from_numpy(logits), drafts, probs,
                              torch.from_numpy(k), T, top_k).numpy()
    _same_verdicts((got[0].numpy(), got[1].numpy()),
                   (np.asarray(want[0]), np.asarray(want[1])), margins)
    if S > 1:  # both branches ran: some accepted, some resampled
        n = got[1].numpy()
        assert n.min() < S and n.max() > 1


def _fold_keys(seed, n):
    """Keys fold_in(PRNGKey(seed), i), i < n, as the reference's tests make."""
    return prng.fold_in(prng.PRNGKey(seed), np.arange(n))


def test_rejection_verify_accepts_certain_drafts():
    """One-hot proposals whose tokens carry ~all target mass: every draft
    accepted, bonus appended, emission count is the full window
    (tests/test_spec.py's, on the port)."""
    V, S = 8, 4
    logits = np.full((1, S, V), -20.0, np.float32)
    want = [1, 5, 3, 6]
    for i, t in enumerate(want):
        logits[0, i, t] = 20.0
    toks, n = rejection_verify(
        torch.from_numpy(logits), torch.tensor([want[:-1]], dtype=torch.int32),
        None, torch.from_numpy(_fold_keys(9, S))[None], temperature=0.7)
    assert int(n[0]) == S and toks[0].tolist() == want


def test_rejection_verify_rejects_impossible_drafts():
    """A draft with zero target mass must be rejected and resampled from
    the (renormalized) residual = target distribution."""
    V = 8
    logits = np.full((1, 2, V), -np.inf, np.float32)
    logits[0, :, 3] = 0.0  # target mass entirely on token 3
    toks, n = rejection_verify(
        torch.from_numpy(logits), torch.tensor([[5]], dtype=torch.int32), None,
        torch.from_numpy(_fold_keys(4, 2))[None], temperature=1.0)
    assert int(n[0]) == 1 and int(toks[0, 0]) == 3


def _spec_keys(seed, n, s):
    """(n, s) grid of fold_in(fold_in(base, row), index) keys."""
    return torch.from_numpy(_tkeys(seed, np.broadcast_to(np.arange(n)[:, None], (n, s)),
                                   np.broadcast_to(np.arange(s)[None], (n, s))))


@given(st.integers(0, 2 ** 16), st.integers(2, 3),
       st.sampled_from([0.7, 1.0, 1.4]))
@settings(max_examples=8, deadline=None)
def test_speculative_sampling_matches_target_distribution(seed, S, temp):
    """tests/test_property.py's property on the port: drafts sampled from
    p, the emitted token's marginal is the target q (TV < 0.07)."""
    V, N = 12, 4000
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((S, V)) * 1.5).astype(np.float32)
    p = rng.dirichlet(np.full(V, 0.6), size=S - 1).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    q0 = sampling.sample_probs(torch.from_numpy(logits)[None], temp, 0)[0, 0].numpy()
    drafts = np.stack([rng.choice(V, size=N, p=p[i].astype(np.float64)
                                  / p[i].sum(dtype=np.float64))
                       for i in range(S - 1)], axis=1).astype(np.int32)
    toks, _ = rejection_verify(
        torch.from_numpy(logits).expand(N, S, V), torch.from_numpy(drafts),
        torch.from_numpy(p).expand(N, S - 1, V), _spec_keys(seed, N, S),
        temperature=temp)
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / N
    assert 0.5 * np.abs(emp - q0).sum() < 0.07


@given(st.integers(0, 2 ** 16))
@settings(max_examples=6, deadline=None)
def test_speculative_sampling_one_hot_proposals_faithful(seed):
    """Deterministic proposals (draft_probs=None): the emitted marginal is
    still exactly q (TV < 0.07)."""
    V, N, S = 10, 4000, 2
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((S, V)).astype(np.float32)
    d = int(rng.integers(V))
    q0 = sampling.sample_probs(torch.from_numpy(logits)[None], 1.0, 0)[0, 0].numpy()
    toks, _ = rejection_verify(
        torch.from_numpy(logits).expand(N, S, V),
        torch.full((N, S - 1), d, dtype=torch.int32), None,
        _spec_keys(seed + 1, N, S), temperature=1.0)
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / N
    assert 0.5 * np.abs(emp - q0).sum() < 0.07


# ---------------------------------------------------------------------------
# the sampled decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contig", "paged"])
def test_sampled_decode_step_draws_inside_it(monkeypatch, layout):
    """A decode step built with the sampler takes the (B, 2) keys as its
    last input and returns the sampler's draw from its last logits row; a
    sampled engine brings no (B, V) logits to the host (``Tensor.cpu``
    watched: the draws and the verdicts come back, the rows stay)."""
    from repro_torch.launch import steps
    model = build_model(TINY, impl="pallas", device="cpu")
    params = model.init(model.generator(0))
    sampler = steps.build_sampler(0.9, 32)
    with pytest.raises(ValueError, match="temperature > 0"):
        steps.build_sampler(0.0)
    build = steps.build_decode_step if layout == "contig" else \
        steps.build_paged_decode_step
    B = 3
    if layout == "contig":
        cache, extra = model.init_cache(B, 16, torch.float32), ()
    else:
        cache = model.init_paged_cache(13, 4, torch.float32)
        extra = (torch.arange(1, 13, dtype=torch.int32).reshape(B, 4),)
    tokens = torch.tensor([[3], [7], [11]], dtype=torch.int32)
    cache_len = torch.tensor([0, 4, 9], dtype=torch.int32)
    keys = torch.from_numpy(_tkeys(1, np.arange(B), np.asarray([2, 0, 5])))
    tok, logits, _ = build(model, sampler=sampler)(params, cache, tokens,
                                                   cache_len, *extra, keys)
    assert tok.shape == (B, 1) and tok.dtype == torch.int32
    assert torch.equal(tok[:, 0], sampler(logits[:, -1], keys))

    moved, real_cpu = [], torch.Tensor.cpu

    def cpu(self, *a, **k):
        moved.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    engine = tserve.ContinuousBatchingEngine(model, params, max_batch=3,
                                             max_seq=64, kv_layout=layout,
                                             draft_depth=2, **KW)
    engine.run(_tiny_requests(tserve, n=4))
    assert engine.spec_rounds and moved
    assert not [m for m in moved if m and m[-1] == TINY.vocab_size], moved


# ---------------------------------------------------------------------------
# the reference's engine sampling tests, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced():
    model = build_model(get_config("llama3.2-1b").reduced(), impl="naive",
                        device="cpu")
    return model, model.init(model.generator(0))


def _stream(model, params, reqs, max_batch=2, max_seq=32, **kw):
    engine = tserve.ContinuousBatchingEngine(model, params, max_batch=max_batch,
                                             max_seq=max_seq, **kw)
    done = engine.run([tserve.Request(r.uid, r.prompt.copy(), r.max_new_tokens)
                       for r in reqs])
    return engine, {u: f.tokens for u, f in done.items()}


def test_engine_sampling_deterministic_and_batch_independent(reduced):
    """Seeded sampling: identical streams across runs, and a request's
    stream does not depend on what it was batched with."""
    model, params = reduced
    reqs = [tserve.Request(uid=i, prompt=np.arange(4 + i, dtype=np.int32),
                           max_new_tokens=4) for i in range(3)]
    kw = dict(temperature=1.0, top_k=8, sample_seed=7)
    _, a = _stream(model, params, reqs, **kw)
    _, b = _stream(model, params, reqs, **kw)
    assert a == b
    _, solo = _stream(model, params, reqs[:1], max_batch=1, **kw)
    assert solo[0] == a[0]
    _, c = _stream(model, params, reqs, temperature=1.0, top_k=8, sample_seed=8)
    assert c != a


def _ragged_reqs(seed=1, n=3):
    rng = np.random.default_rng(seed)
    return [tserve.Request(uid=i, prompt=rng.integers(0, 64, 4 + 3 * i).astype(np.int32),
                           max_new_tokens=3 + i) for i in range(n)]


@pytest.mark.parametrize("layout", ["contig", "paged"])
def test_engine_sampling_respects_top_k(reduced, layout):
    """top_k=1 must reduce to greedy regardless of temperature."""
    model, params = reduced
    kw = dict(kv_layout=layout, block_size=4)
    _, greedy = _stream(model, params, _ragged_reqs(9), **kw)
    _, topk1 = _stream(model, params, _ragged_reqs(9), temperature=5.0, top_k=1,
                       sample_seed=3, **kw)
    assert topk1 == greedy


def _tiny_requests(mod, n=6, seed=2, gen=12):
    """Ragged budgets over two prompt lengths (each length the JAX engine
    meets is a compile of its prefill)."""
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i,
                        prompt=rng.integers(0, TINY.vocab_size,
                                            (5, 11)[i % 2]).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, gen + 1)))
            for i in range(n)]


def test_engine_spec_sampled_respects_budgets(tiny):
    """Sampled speculative serving: right token counts per request and a
    live acceptance counter."""
    _, tparams = tiny
    reqs = _tiny_requests(tserve)
    engine = tserve.ContinuousBatchingEngine(
        build_model(TINY, impl="naive", device="cpu"), tparams, max_batch=3,
        max_seq=64, draft_depth=3, temperature=0.8, top_k=32)
    got = {u: f.tokens for u, f in engine.run(reqs).items()}
    assert {u: len(t) for u, t in got.items()} == \
        {r.uid: r.max_new_tokens for r in reqs}
    assert engine.spec_drafted > 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_build_model(TINY, impl="naive").init(jax.random.PRNGKey(0))
    return jparams, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")


class _Margins:
    """The port's decision margins by stream key while it serves: the
    sampler's perturbed top-2 margin and ``_verify_margins``' of every
    verify window, the smallest met under each key."""

    def __init__(self, monkeypatch, temperature, top_k):
        self.by_key = {}
        real_sampler, real_verify = tserve.build_sampler, tserve.rejection_verify

        def build_sampler(t, k):
            fn = real_sampler(t, k)

            def sample(logits, keys):
                lg = sampling.mask_logits(logits, t, k)
                self.note(keys, _top2(lg + prng.gumbel(keys, (lg.shape[-1],))))
                return fn(logits, keys)
            return sample

        def verify(logits, drafts, probs, keys, **kw):
            self.note(keys, _verify_margins(logits, drafts, probs, keys,
                                            temperature, top_k))
            return real_verify(logits, drafts, probs, keys, **kw)

        monkeypatch.setattr(tserve, "build_sampler", build_sampler)
        monkeypatch.setattr(tserve, "rejection_verify", verify)

    def note(self, keys, margins):
        for k, m in zip(keys.reshape(-1, 2).tolist(), margins.reshape(-1).tolist()):
            self.by_key[tuple(k)] = min(self.by_key.get(tuple(k), math.inf), m)

    def hold(self, got, want, seed, label):
        """The stream rule; returns the flips (uid, index, margin)."""
        assert sorted(got) == sorted(want), label
        flips = []
        for u in sorted(want):
            a, w = got[u], want[u]
            if a == w:
                continue
            i = next((j for j in range(min(len(a), len(w))) if a[j] != w[j]),
                     min(len(a), len(w)))
            key = tuple(_tkeys(seed, u, i).tolist())
            m = self.by_key.get(key, math.inf)
            print(f"[{label}] uid {u} flips at {i}: {a[i:i + 1]} vs {w[i:i + 1]}, "
                  f"margin {m:.3g} (near tie below {NEAR_TIE})")
            assert m < NEAR_TIE, (label, u, i, m)
            flips.append((u, i, m))
        return flips


def _both(monkeypatch, tiny, reqs_of, *, impl="naive", jax_draft=None,
          torch_draft=None, depths=None, max_batch=3, max_seq=64, **kw):
    """The JAX engine and the port's (``impl``) on the same requests and
    sampling settings; ``depths``: set_draft_depth walked each step. Returns
    (port streams, JAX streams, margins, port engine, JAX engine)."""
    jparams, tparams = tiny
    kw = {**KW, **kw}
    margins = _Margins(monkeypatch, kw["temperature"], kw.get("top_k", 0))
    out = []
    for mod, model, params, draft in (
            (jserve, jax_build_model(TINY, impl="naive"), jparams, jax_draft),
            (tserve, build_model(TINY, impl=impl, device="cpu"), tparams,
             torch_draft)):
        engine = mod.ContinuousBatchingEngine(
            model, params, max_batch=max_batch, max_seq=max_seq,
            draft_source=draft, **kw)
        for r in reqs_of(mod):
            engine.submit(r)
        i = 0
        while engine.has_work:
            if depths:
                engine.set_draft_depth(depths[i % len(depths)])
            engine.step()
            i += 1
        out.append(({u: f.tokens for u, f in engine.finished.items()}, engine))
    (want, jeng), (got, teng) = out
    return got, want, margins, teng, jeng


def _shared_prefix(mod):
    """Prompts over a 4-block shared prefix, two of them identical: prefix
    hits, a read-only recompute and copy-on-write."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, TINY.vocab_size, 16)
    prompts = [np.concatenate([prefix, rng.integers(0, TINY.vocab_size, n)])
               for n in (3, 5, 0, 6)] + [prefix[:10]]
    prompts[2] = prompts[0].copy()
    return [mod.Request(uid=i, prompt=p.astype(np.int32), max_new_tokens=6 + i)
            for i, p in enumerate(prompts)]


SCENARIOS = {
    "contig": dict(reqs=_tiny_requests),
    "contig_pallas_bucketed": dict(reqs=_tiny_requests, impl="pallas",
                                   bucket_prompts=True),
    "paged_prefix": dict(reqs=_shared_prefix, kv_layout="paged", block_size=4,
                         impl="pallas"),
    "swap": dict(reqs=_shared_prefix, kv_layout="paged", block_size=4,
                 num_blocks=12, admission_policy="swap", max_batch=3),
    "spec_contig": dict(reqs=_tiny_requests, draft_depth=3, impl="pallas"),
    "spec_paged": dict(reqs=_tiny_requests, draft_depth=3, kv_layout="paged",
                       block_size=4),
    "depth_walk_paged": dict(reqs=_tiny_requests, draft_depth=4,
                             kv_layout="paged", block_size=4,
                             depths=[4, 2, 0, 3, 1]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_sampled_streams_match_jax(monkeypatch, tiny, name):
    sc = dict(SCENARIOS[name])
    got, want, margins, teng, jeng = _both(monkeypatch, tiny, sc.pop("reqs"), **sc)
    margins.hold(got, want, KW["sample_seed"], name)
    assert teng.tokens_out == jeng.tokens_out
    assert any(len(set(t)) > 1 for t in got.values())  # sampled, not stuck
    st, jst = teng.stats(), jeng.stats()
    if name in ("paged_prefix", "swap"):
        assert st["prefill_chunks_skipped"] > 0
    if name == "paged_prefix":
        assert st["cow_copies"] >= 1
    if name == "swap":
        assert st["swap_outs"] > 0 and st["swap_ins"] == st["swap_outs"]
    if name == "contig_pallas_bucketed":
        assert st["prefill_buckets"] == jst["prefill_buckets"]
    if name.startswith(("spec", "depth")):
        assert st["spec_rounds"] > 0 and st["spec_drafted"] > 0
    if name == "depth_walk_paged":
        teng.set_draft_depth(None)
        assert teng.draft_depth == 4


def test_engine_sampled_model_draft_matches_jax(monkeypatch, tiny):
    """A sampled ModelDraft (its own temperature/top-k, numpy draws on its
    float32 probs) proposing for the sampled target, depth 2."""
    jparams, _ = tiny
    dcfg = dataclasses.replace(TINY, name="sample-draft", n_layers=1, d_ff=64)
    jdm = jax_build_model(dcfg, impl="naive")
    jdp = jdm.init(jax.random.PRNGKey(5))
    dkw = dict(max_batch=3, max_seq=64, temperature=1.0, top_k=0, seed=3)
    jd = jdraft.ModelDraft(jdm, jdp, **dkw)
    td = tdraft.ModelDraft(
        build_model(dcfg, impl="naive", device="cpu"),
        from_numpy_tree(jax.tree_util.tree_map(np.asarray, jdp), device="cpu"),
        **dkw)
    got, want, margins, teng, jeng = _both(
        monkeypatch, tiny, _tiny_requests, impl="pallas", jax_draft=jd,
        torch_draft=td, draft_depth=2)
    flips = margins.hold(got, want, KW["sample_seed"], "model_draft")
    if not flips:
        assert teng.spec_accepted == jeng.spec_accepted
        assert teng.spec_drafted == jeng.spec_drafted > 0


def test_model_draft_sampled_proposals_match_jax(tiny):
    """The sampled draft alone: the same proposals and probs (1e-6) from the
    same prompts, through two rounds of commits."""
    dcfg = dataclasses.replace(TINY, name="sample-draft", n_layers=1, d_ff=64)
    jdm = jax_build_model(dcfg, impl="naive")
    jdp = jdm.init(jax.random.PRNGKey(5))
    dkw = dict(max_batch=2, max_seq=32, temperature=0.8, top_k=16, seed=11)
    jd = jdraft.ModelDraft(jdm, jdp, **dkw)
    td = tdraft.ModelDraft(
        build_model(dcfg, impl="naive", device="cpu"),
        from_numpy_tree(jax.tree_util.tree_map(np.asarray, jdp), device="cpu"),
        **dkw)
    for d in (jd, td):
        d.admit(0, [3, 4, 5])
        d.admit(1, [9])
    for _ in range(2):
        jdr, jp = jd.propose([0, 1], 3)
        tdr, tp = td.propose([0, 1], 3)
        assert tdr.tolist() == jdr.tolist()
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
        assert (np.count_nonzero(tp, -1) <= 16).all()
        for d in (jd, td):
            d.commit(0, [int(jdr[0, 0])], 99)
            d.commit(1, [], 7)
        assert td.cache_len.tolist() == jd.cache_len.tolist()


def test_cli_serves_sampled_on_the_cpu(tmp_path):
    """The same streams on two runs; --sample-seed moves them."""
    argv = ["--reduced", "--batch", "2", "--requests", "3", "--prompt-len", "8",
            "--gen", "5", "--device", "cpu", "--temperature", "0.9",
            "--top-k", "32"]
    runs = [{u: f.tokens for u, f in tserve.main(argv + extra).items()}
            for extra in (["--sample-seed", "1"], ["--sample-seed", "1"],
                          ["--sample-seed", "2", "--kv-layout", "paged",
                           "--draft-depth", "2"])]
    assert sorted(runs[0]) == [0, 1, 2]
    assert runs[0] == runs[1]
    assert runs[2] != runs[0]
