"""The port's deepseek-v3 decoder against the JAX package's.

deepseek-v3-671b at ``reduced()`` size (2 layers: one dense MLA layer, one
MLA + MoE layer, the MTP head's params; H 4, r 16, rd 8, nope 16, v 16).
Parameters are initialised by JAX from a seed and carried over through
numpy; inputs are drawn with numpy from a seed. Tolerance 2e-5 at f32, as in
``tests/test_decode_consistency.py``.

- The parameter tree carries over leaf for leaf.
- Logits and router aux of the whole-model forward; decode against the
  teacher-forced forward through both decode paths.
- Greedy engine streams token-identical to the JAX engine's, contiguous
  and paged (a draft depth decodes one token a step: MLA has no verify).

The MLA attention functions are held in ``tests/test_torch_mla.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_numpy_tree

F32 = dict(rtol=2e-5, atol=2e-5)
CFG = ASSIGNED["deepseek-v3-671b"].reduced()
KEY = jax.random.PRNGKey(0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.fixture(scope="module")
def model_params():
    jparams = jax.jit(jax_build_model(CFG).init)(KEY)
    return jparams, from_numpy_tree(_np_tree(jparams), device="cpu")


def test_converted_params_carry_every_leaf(model_params):
    """As ``tests/test_torch_moe.py``'s, on deepseek-v3's tree (MLA leaves,
    three dense layers cut to one, the MTP head)."""
    jparams, tparams = model_params
    want = _flat(_np_tree(jparams))
    got = _flat(tparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["layers/moe/experts/w_gate"].shape == (
        CFG.n_layers - CFG.first_k_dense, CFG.n_experts, CFG.d_model, CFG.moe_d_ff)
    assert got["dense_layers/attn/wkv_b"].shape == (
        CFG.first_k_dense, CFG.kv_lora_rank,
        CFG.n_heads * (CFG.qk_nope_head_dim + CFG.v_head_dim))
    assert {"mtp/proj", "mtp/block/attn/wq_a", "mtp/ln/scale"} <= got.keys()
    model = build_model(CFG, device="cpu")
    own = _flat(model.init(model.generator(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}


def test_forward_logits_and_aux_match_jax(model_params):
    jparams, tparams = model_params
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    want_logits, want_aux, _ = jtr.forward_decoder(jparams, CFG, jnp.asarray(toks),
                                                   impl="naive")
    with torch.no_grad():
        logits, aux, _ = transformer.forward_decoder(tparams, CFG, torch.from_numpy(toks),
                                                     impl="naive", with_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_decode_matches_forward(model_params, impl):
    """``tests/test_decode_consistency.py::test_decode_matches_forward`` (its
    capacity factor 100 and 2e-3), through both decode paths."""
    _, tparams = model_params
    model = build_model(CFG, impl=impl, moe_cf=100.0, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, CFG.vocab_size, (B, S)))
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # pallas prefill: chunked
        full = model.forward(tparams, {"tokens": toks})
        cache = model.init_cache(B, S, torch.float32)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(tparams, cache, toks[:, t:t + 1], t)
            outs.append(lg)
    assert set(cache) == {"latent", "k_rope"}
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_mla_model_has_no_speculative_steps(model_params):
    model = build_model(CFG, impl="pallas", device="cpu")
    assert model.spec_decode_step is None and model.paged_spec_decode_step is None


SPECS = ((5, 6), (9, 3), (3, 5), (7, 4))  # (prompt length, budget): slots retire


def _requests(mod):
    rng = np.random.default_rng(5)
    return [mod.Request(uid=u, prompt=rng.integers(0, CFG.vocab_size, p).astype(np.int32),
                        max_new_tokens=n) for u, (p, n) in enumerate(SPECS)]


@pytest.mark.parametrize("layout,draft_depth", [("contig", 0), ("paged", 0),
                                                ("contig", 3)])
def test_engine_streams_match_jax(model_params, layout, draft_depth):
    """Three slots, four ragged requests: slots retire mid-stream and ride
    along idle; paged with blocks of 4. A draft depth decodes one token a
    step in both engines (MLA has no verify step)."""
    jparams, tparams = model_params
    kw = dict(max_batch=3, max_seq=32, kv_layout=layout, draft_depth=draft_depth)
    if layout == "paged":
        kw["block_size"] = 4
    jeng = jserve.ContinuousBatchingEngine(jax_build_model(CFG, impl="naive"),
                                           jparams, **kw)
    want = {u: (f.tokens, f.reason) for u, f in jeng.run(_requests(jserve)).items()}
    for impl in ("naive", "pallas"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            teng = tserve.ContinuousBatchingEngine(build_model(CFG, impl=impl, device="cpu"),
                                                   tparams, **kw)
            got = {u: (f.tokens, f.reason) for u, f in teng.run(_requests(tserve)).items()}
        assert got == want, impl
        assert teng.decode_steps == jeng.decode_steps, impl
        assert teng.spec_rounds == 0 and set(teng.cache) == {"latent", "k_rope"}
