"""The port's dense decoder against the JAX package's, on carried-over params.

The JAX model is built at ``ModelConfig.reduced()`` size (2 layers, d 64,
4 heads, 2 KV heads, head_dim 16, vocab 256) and initialised by JAX; its
params go through numpy into ``repro_torch.models.convert``. Tokens are
drawn with numpy from a seed and fed to both.

Tolerance: 1e-4 absolute and relative on logits and caches. Both sides run
in f32; they differ only in summation order (XLA's CPU dots and reductions
against PyTorch's), which moves logits of magnitude ~0.2 by ~1e-6 per layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.launch.steps import greedy_decode_tokens as jax_greedy
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.launch.steps import greedy_decode_tokens
from repro.models import common as jcommon
from repro_torch.models import build_model, common, transformer
from repro_torch.models.convert import from_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = ASSIGNED["llama3.2-1b"].reduced()


@pytest.fixture(scope="module")
def params():
    jparams = jax_build_model(CFG).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_config_copy_matches_reference():
    full = get_config("llama3.2-1b")
    assert full.__dict__ == ASSIGNED["llama3.2-1b"].__dict__
    assert full.reduced().__dict__ == CFG.__dict__
    assert full.param_count() == ASSIGNED["llama3.2-1b"].param_count()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("rwkv6-7b")


def test_converted_params_round_trip(params):
    jparams, tparams = params
    back = _to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_convert_carries_bf16_bits():
    leaf = np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16))
    got = from_numpy_tree({"w": leaf}, device="cpu", dtype=None)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), leaf.astype(np.float32))
    assert from_numpy_tree({"w": leaf}, device="cpu",
                           dtype=torch.float32)["w"].dtype == torch.float32


def test_port_init_draws_reference_distributions():
    model = build_model(CFG, device="cpu")
    p = model.init(model.generator(0))
    assert p["layers"]["attn"]["wq"].shape == (CFG.n_layers, CFG.d_model,
                                               CFG.n_heads * CFG.head_dim)
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    w_down = p["layers"]["mlp"]["w_down"]
    assert abs(w_down.std().item() * CFG.d_ff ** 0.5 - 1.0) < 0.05
    assert torch.equal(p["ln_f"]["scale"], torch.ones(CFG.d_model))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_common_primitives_match_jax(kind, activation):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = jcommon.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = common.apply_norm(tp, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(common.activate(torch.from_numpy(x), activation).numpy(),
                               np.asarray(jcommon.activate(jnp.asarray(x), activation)),
                               rtol=2e-5, atol=2e-5)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    xr = x.reshape(2, 5, 2, 8)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 5e5).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 5e5)),
        rtol=2e-5, atol=2e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1  # ignored positions
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_forward_logits_match_jax(params, impl):
    jparams, tparams = params
    toks = _tokens(1, 2, 19)
    want, _, _ = jtr.forward_decoder(jparams, CFG, jnp.asarray(toks), impl=impl,
                                     chunk=8)
    model = build_model(CFG, impl=impl, chunk=8, device="cpu")
    got = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("last_pos", [None, 6])
def test_prefill_logits_and_cache_match_jax(params, impl, last_pos):
    jparams, tparams = params
    toks = _tokens(2, 1, 11)
    want_l, want_c = jtr.prefill_decoder(jparams, CFG, jnp.asarray(toks),
                                         impl=impl, last_pos=last_pos)
    got_l, got_c = transformer.prefill_decoder(tparams, CFG, torch.from_numpy(toks),
                                               impl=impl, last_pos=last_pos)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    for name in ("k", "v"):
        assert got_c[name].shape == want_c[name].shape  # (L, B, S, K, hd)
        np.testing.assert_allclose(got_c[name].numpy(), np.asarray(want_c[name]),
                                   **TOL)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_ragged_decode_chain_matches_jax(params, impl):
    """Four batched steps with a ragged (B,) cache_len. Row 2 starts at
    max_seq - 2, so its last two steps decode at cache_len >= max_seq, as an
    idle serving slot does: its write must land nowhere and its length is
    clamped to the cache."""
    jparams, tparams = params
    B, max_seq = 3, 16
    cl = np.asarray([0, 5, max_seq - 2], np.int32)
    jcache = jtr.init_cache_decoder(CFG, B, max_seq, jnp.float32)
    tcache = transformer.init_cache_decoder(CFG, B, max_seq, torch.float32)
    toks = _tokens(3, B, 4)
    for step in range(4):
        t = toks[:, step:step + 1]
        jl, jcache = jtr.decode_step_decoder(jparams, CFG, jcache, jnp.asarray(t),
                                             jnp.asarray(cl), impl=impl)
        tl, tcache = transformer.decode_step_decoder(
            tparams, CFG, tcache, torch.from_numpy(t), torch.from_numpy(cl),
            impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cl = cl + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   **TOL)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_greedy_decode_tokens_identical(params, impl):
    jparams, tparams = params
    toks = _tokens(4, 2, 1)
    want = jax_greedy(jax_build_model(CFG, impl=impl), jparams, jnp.asarray(toks),
                      steps=8, max_len=12)
    got = greedy_decode_tokens(build_model(CFG, impl=impl, device="cpu"), tparams,
                               torch.from_numpy(toks), steps=8, max_len=12)
    np.testing.assert_array_equal(got, want)


def test_unported_family_raises():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(ASSIGNED["rwkv6-7b"].reduced(), device="cpu")
