"""The port's MoE layer and the deepseek-moe-16b decoder against the JAX
package's.

Inputs are drawn with numpy from a seed; parameters are initialised by JAX
and carried over through numpy (``repro_torch.models.convert``). Tolerances
are those of ``tests/test_kernels.py``: 2e-5 at f32 (the two sides differ in
the order of f32 sums only), 5e-2 at bf16.

- The configs of both deepseek models equal the reference's, full and
  reduced, and their parameter trees carry over leaf for leaf (the first
  dense layers, the stacked expert leaves (L, E, d, ff), the MTP head).
- ``_route`` (gates and aux) and ``apply_moe`` at a capacity factor of 1.25
  where the test shows tokens dropped, and at 100 (none dropped), in f32
  and bf16; a mesh raises.
- deepseek-moe-16b at ``reduced()`` size (2 layers: one dense, one MoE of 8
  experts, top-2, one shared; MHA cut to 4/2 heads): logits and the router
  aux of the whole-model forward, decode against the teacher-forced
  forward (``tests/test_decode_consistency.py:17``), and greedy streams of
  the engine token-identical to the JAX engine's, contiguous, paged and
  speculative, with slots that retire and ride along idle (capacity counts
  every token of a call, so streams match only under one schedule).
- ``init_decoder`` builds its stacked leaves in place with the draws of the
  per-layer list it replaced, bit for bit; the moe family trains through
  ``Model.loss``, ``Rung`` and the train CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.convert import from_numpy_tree

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
ARCH = "deepseek-moe-16b"
CFG = ASSIGNED[ARCH].reduced()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _tokens(seed, B, S, cfg=CFG):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def model_params():
    jparams = jax.jit(jax_build_model(CFG).init)(jax.random.PRNGKey(0))
    return jparams, from_numpy_tree(_np_tree(jparams), device="cpu")


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_config_copy_matches_reference(name):
    full = get_config(name)
    assert full.__dict__ == ASSIGNED[name].__dict__
    assert full.reduced().__dict__ == ASSIGNED[name].reduced().__dict__
    assert full.param_count() == ASSIGNED[name].param_count()
    assert full.active_param_count() == ASSIGNED[name].active_param_count()


def assert_carried_leaf_for_leaf(cfg, jparams):
    """``from_numpy_tree`` carries a moe tree over unchanged: the first dense
    layers, the stacked expert leaves (L, E, d, ff), the MTP head; and the
    port's own init makes the same tree."""
    want = _flat(_np_tree(jparams))
    got = _flat(from_numpy_tree(_np_tree(jparams), device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    L = cfg.n_layers - cfg.first_k_dense
    assert got["layers/moe/experts/w_gate"].shape == (L, E, d, ff)
    assert got["layers/moe/experts/w_down"].shape == (L, E, ff, d)
    assert got["dense_layers/mlp/w_up"].shape == (cfg.first_k_dense, d, cfg.dense_d_ff)
    assert ("mtp/proj" in got) == bool(cfg.n_mtp_modules)
    model = build_model(cfg, device="cpu")
    own = _flat(model.init(model.generator(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}


def test_converted_params_carry_every_leaf(model_params):
    assert_carried_leaf_for_leaf(CFG, model_params[0])


def test_init_builds_the_stack_in_place_with_the_same_draws():
    """The stacked leaves are built in place (``_init_stacked``) from the
    same draws, in the same order, as the per-layer list and ``torch.stack``
    that came before: every dense config's weights stay bit-identical."""
    def old_init(gen, cfg):
        params = {"embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen)
                            * 0.02).to(torch.float32),
                  "ln_f": transformer.norm_params(cfg, torch.float32, gen.device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = transformer.dense_init(gen, cfg.d_model, cfg.vocab_size)
        layers = [transformer.init_dense_layer(gen, cfg) for _ in range(cfg.n_layers)]

        def stack(trees):
            return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                    else torch.stack([t[k] for t in trees]) for k in trees[0]}
        params["layers"] = stack(layers)
        return params

    for name in ("llama3.2-1b", "granite-3-2b", "nemotron-4-15b"):
        cfg = get_config(name).reduced()
        new = _flat(transformer.init_decoder(torch.Generator().manual_seed(3), cfg))
        old = _flat(old_init(torch.Generator().manual_seed(3), cfg))
        assert new.keys() == old.keys()
        for k in old:
            assert torch.equal(new[k], old[k]), (name, k)
    # one layer: a view of the layer, no copy
    one = transformer._init_stacked(1, lambda: {"w": torch.ones(2, 3)})
    assert one["w"].shape == (1, 2, 3) and one["w"]._base is not None


def test_moe_family_trains_through_every_entry_point():
    """``Model.loss`` (router aux included), ``Rung.build_model`` and its
    compiled step, and ``train.main`` each train deepseek-moe-16b
    (``tests/test_torch_moe_train.py`` holds them to the JAX package)."""
    from repro_torch.engine.rungs import Rung
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import init_train_state
    from repro_torch.optim.optimizers import adam
    from repro_torch.tree import tree_leaves
    model = build_model(CFG, device="cpu")
    params = model.init(model.generator(0))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(params, {"tokens": torch.from_numpy(_tokens(0, 2, 16))})
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)
    router = dict(zip(_flat(params), grads))["layers/moe/router"]
    assert float(router.abs().max()) > 0
    rung = Rung(name="full", attn_impl="pallas")
    assert rung.build_model(CFG, "cpu").cfg is CFG
    state = init_train_state(rung.build_model(CFG, "cpu"), adam(), model.generator(0))
    state, metrics = rung.jitted_step(CFG, adam(), lr=3e-4, device="cpu")(
        state, {"tokens": _tokens(1, 2, 16)})
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
    losses = ttrain.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--attn-impl", "pallas",
                          "--optimizer", "adam", "--lr", "3e-4", "--log-every", "0"])
    assert len(losses) == 3 and all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _layer(seed, dtype=jnp.float32, skew=1.0):
    """A reduced MoE layer's params (JAX's init; the router's expert 0
    column scaled by ``skew``) and inputs (B 2, S 16)."""
    p = jax.tree_util.tree_map(np.asarray, jmoe.moe_params(jax.random.PRNGKey(seed), CFG))
    p["router"] = p["router"].copy()
    p["router"][:, 0] *= skew
    x = np.random.default_rng(seed).standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p)
    tp = from_numpy_tree(_np_tree(jp), device="cpu")
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jp, tp, jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)


def _dropped(gates, cap):
    """Routed (gate > 0) token-expert pairs beyond each expert's capacity."""
    return int(np.maximum((np.asarray(gates) > 0).sum(0) - cap, 0).sum())


@pytest.mark.parametrize("skew", [1.0, 6.0])
def test_route_matches_jax(skew):
    jp, tp, jx, tx = _layer(2, skew=skew)
    T = 2 * 16
    want_g, want_aux = jmoe._route(jx.reshape(T, -1), jp["router"], CFG)
    got_g, got_aux = moe._route(tx.reshape(T, -1), tp["router"], CFG)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **F32)
    assert ((got_g > 0).sum(1) == CFG.top_k).all()


@pytest.mark.parametrize("cf", [1.25, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_jax(cf, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, tp, jx, tx = _layer(4, jdt, skew=6.0)
    T = 2 * 16
    cap = jmoe._capacity(T, CFG, cf, 4)
    assert cap == moe._capacity(T, CFG, cf, 4)
    gates, _ = jmoe._route(jx.reshape(T, -1), jp["router"], CFG)
    dropped = _dropped(gates, cap)
    if cf == 1.25:
        assert dropped > 0  # the skewed router overfills expert 0
    else:
        assert dropped == 0 and cap == T
    want_y, want_aux = jmoe.apply_moe(jp, jx, CFG, capacity_factor=cf)
    got_y, got_aux = moe.apply_moe(tp, tx, CFG, capacity_factor=cf)
    assert got_y.dtype == tx.dtype and got_y.shape == tx.shape
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **tol)


def test_apply_moe_combines_in_a_fixed_order():
    _, tp, _, tx = _layer(5, skew=6.0)
    first, _ = moe.apply_moe(tp, tx, CFG)
    again, _ = moe.apply_moe(tp, tx, CFG)
    assert torch.equal(first, again)
    with pytest.raises(NotImplementedError, match="one card"):
        moe.apply_moe(tp, tx, CFG, mesh=object())


# ---------------------------------------------------------------------------
# deepseek-moe-16b, reduced: forward, decode, engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_logits_and_aux_match_jax(model_params, impl):
    jparams, tparams = model_params
    toks = _tokens(1, 2, 12)
    want_logits, want_aux, _ = jtr.forward_decoder(jparams, CFG, jnp.asarray(toks),
                                                   impl=impl)
    with torch.no_grad():
        logits, aux, _ = transformer.forward_decoder(tparams, CFG, torch.from_numpy(toks),
                                                     impl=impl, with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    assert float(aux) > 0


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_decode_matches_forward(model_params, impl):
    """``tests/test_decode_consistency.py::test_decode_matches_forward`` (its
    capacity factor 100 and 2e-3), through both decode paths."""
    _, tparams = model_params
    model = build_model(CFG, impl=impl, moe_cf=100.0, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(3, B, S))
    with torch.no_grad():
        full = model.forward(tparams, {"tokens": toks})
        cache = model.init_cache(B, S, torch.float32)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(tparams, cache, toks[:, t:t + 1], t)
            outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


SPECS = ((5, 6), (9, 3), (3, 5), (7, 4))  # (prompt length, budget): slots retire


def _requests(mod, cfg):
    rng = np.random.default_rng(5)
    return [mod.Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, p).astype(np.int32),
                        max_new_tokens=n) for u, (p, n) in enumerate(SPECS)]


def engine_streams_match_jax(cfg, jparams, tparams, layout, draft_depth=0):
    """The JAX engine's greedy streams against the port's (plain attention
    and the kernels' path): three slots, four ragged requests, so slots
    retire mid-stream and ride along idle in later steps; paged with blocks
    of 4. Returns the JAX engine."""
    kw = dict(max_batch=3, max_seq=32, kv_layout=layout, draft_depth=draft_depth)
    if layout == "paged":
        kw["block_size"] = 4
    jeng = jserve.ContinuousBatchingEngine(jax_build_model(cfg, impl="naive"),
                                           jparams, **kw)
    want = {u: (f.tokens, f.reason) for u, f in jeng.run(_requests(jserve, cfg)).items()}
    for impl in ("naive", "pallas"):
        teng = tserve.ContinuousBatchingEngine(build_model(cfg, impl=impl, device="cpu"),
                                               tparams, **kw)
        got = {u: (f.tokens, f.reason)
               for u, f in teng.run(_requests(tserve, cfg)).items()}
        assert got == want, impl
        assert teng.decode_steps == jeng.decode_steps, impl
        assert teng.spec_accepted == getattr(jeng, "spec_accepted", 0), impl
    return jeng


@pytest.mark.parametrize("layout", ["contig", "paged"])
@pytest.mark.parametrize("draft_depth", [0, 3])
def test_engine_streams_match_jax(model_params, layout, draft_depth):
    jeng = engine_streams_match_jax(CFG, *model_params, layout, draft_depth)
    if draft_depth:
        assert jeng.spec_rounds > 0
