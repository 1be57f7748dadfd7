"""The rest of the dense family on the port against the JAX package.

granite-3-2b (RMSNorm, SwiGLU, tied head), nemotron-4-15b (LayerNorm with a
bias, a non-gated squared-ReLU MLP, an untied head) and command-r-35b
(LayerNorm, tied head) at ``ModelConfig.reduced()`` size (2 layers, d 64,
4 heads, 2 KV heads, head_dim 16, vocab 256), initialised by JAX and carried
over through numpy (``repro_torch.models.convert``); tokens drawn with numpy
from a seed and fed to both.

- The configs equal the reference's, full and reduced, and so do their
  parameter counts and parameter trees (``lm_head``, the LayerNorm biases:
  the reference adds a bias to every LayerNorm, ``use_bias`` or not, and so
  does the port).
- Logits, loss and gradients at 2e-5 (f32 on both sides; they differ in
  the order of f32 sums only), under ``naive`` and ``pallas`` (the port's
  kernels run their plain versions on the CPU, JAX's Pallas kernels
  interpret mode).
- The reference's smoke and decode-consistency checks
  (``tests/test_models_smoke.py``, ``tests/test_decode_consistency.py``)
  on the port.
- Greedy streams of the port's engine token-identical to the JAX engine's,
  contiguous and paged.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_tree
from repro_torch.tree import tree_leaves

ARCHS = ["granite-3-2b", "nemotron-4-15b", "command-r-35b"]
F32 = dict(rtol=2e-5, atol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    cfg = ASSIGNED[request.param].reduced()
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, jparams, from_numpy_tree(_np_tree(jparams), device="cpu")


def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_config_copy_matches_reference(name):
    full = get_config(name)
    assert full.__dict__ == ASSIGNED[name].__dict__
    assert full.reduced().__dict__ == ASSIGNED[name].reduced().__dict__
    assert full.param_count() == ASSIGNED[name].param_count()
    assert full.reduced().param_count() == ASSIGNED[name].reduced().param_count()


def test_registry_holds_the_dense_family_and_the_cnns_only():
    """The dense family and the CNNs, and since the deepseek slice the moe
    family (``tests/test_torch_moe.py``); the rest still raises."""
    assert sorted(REGISTRY) == sorted(["llama3.2-1b", *ARCHS, "resnet34",
                                       "mobilenet-v2", "shufflenet-v2",
                                       "deepseek-moe-16b", "deepseek-v3-671b"])
    for name in sorted(set(ASSIGNED) - set(REGISTRY)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_config(name)


def test_converted_params_carry_every_leaf(arch):
    cfg, jparams, tparams = arch
    want, got = _flat(_np_tree(jparams)), _flat(tparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    has_bias = {k for k in got if k.endswith("/bias")}
    assert has_bias == ({"ln_f/bias", "layers/ln1/bias", "layers/ln2/bias"}
                        if cfg.norm == "layernorm" else set())
    assert ("layers/mlp/w_gate" in got) == (cfg.activation != "relu2")
    # the port's own init makes the same tree
    model = build_model(cfg, device="cpu")
    own = _flat(model.init(model.generator(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# logits, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_logits_loss_and_grads_match_jax(arch, impl):
    cfg, jparams, tparams = arch
    toks = _tokens(cfg, 1, 2, 19)
    jmodel = jax_build_model(cfg, impl=impl)
    batch = {"tokens": jnp.asarray(toks)}
    want_logits = jax.jit(jmodel.forward)(jparams, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, batch)

    model = build_model(cfg, impl=impl, device="cpu")
    params = from_numpy_tree(_np_tree(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    tbatch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        logits = model.forward(params, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **F32)
    loss = model.loss(params, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    grads = torch.autograd.grad(loss, leaves)
    want = _flat(_np_tree(jgrads))
    got = dict(zip(_flat(params).keys(), grads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32, err_msg=k)


# ---------------------------------------------------------------------------
# the reference's smoke and decode-consistency checks, on the port
# ---------------------------------------------------------------------------


def test_smoke_forward_and_train_step(arch):
    """``tests/test_models_smoke.py::test_smoke_forward_and_train_step``."""
    cfg, jparams, tparams = arch
    model = build_model(cfg, impl="naive", device="cpu")
    B, S = 2, 16
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, B, S))}
    logits = model.forward(tparams, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert not torch.isnan(logits).any()
    params = from_numpy_tree(_np_tree(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = model.loss(params, batch)
    assert not torch.isnan(loss)
    gn = sum(float(g.abs().sum()) for g in torch.autograd.grad(loss, leaves))
    assert np.isfinite(gn) and gn > 0


def test_smoke_decode_step(arch):
    """``tests/test_models_smoke.py::test_smoke_decode_step``."""
    cfg, _, tparams = arch
    model = build_model(cfg, impl="naive", device="cpu")
    B = 2
    cache = model.init_cache(B, 24, torch.float32)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    logits, new_cache = model.decode_step(tparams, cache,
                                          torch.zeros((B, 1), dtype=torch.int32), 0)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert not torch.isnan(logits).any()
    assert {k: tuple(v.shape) for k, v in new_cache.items()} == shapes


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_decode_matches_forward(arch, impl):
    """``tests/test_decode_consistency.py::test_decode_matches_forward``
    (its 2e-3), through both decode paths."""
    cfg, _, tparams = arch
    model = build_model(cfg, impl=impl, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg, 3, B, S))
    with torch.no_grad():
        full = model.forward(tparams, {"tokens": toks})
        cache = model.init_cache(B, S, torch.float32)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(tparams, cache, toks[:, t:t + 1], t)
            outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# greedy streams through the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contig", "paged"])
def test_engine_streams_match_jax(arch, layout):
    """Three ragged requests through two slots (one admitted mid-stream);
    paged with blocks of 4, so decodes cross block boundaries."""
    cfg, jparams, tparams = arch
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, cfg.vocab_size, p).astype(np.int32), n)
             for p, n in ((5, 6), (9, 3), (3, 5))]
    kw = dict(max_batch=2, max_seq=32, kv_layout=layout)
    if layout == "paged":
        kw["block_size"] = 4
    jeng = jserve.ContinuousBatchingEngine(jax_build_model(cfg, impl="naive"),
                                           jparams, **kw)
    want = {u: (f.tokens, f.reason) for u, f in jeng.run(
        [jserve.Request(uid=u, prompt=p, max_new_tokens=n)
         for u, (p, n) in enumerate(specs)]).items()}
    for impl in ("naive", "pallas"):
        teng = tserve.ContinuousBatchingEngine(build_model(cfg, impl=impl, device="cpu"),
                                               tparams, **kw)
        got = {u: (f.tokens, f.reason) for u, f in teng.run(
            [tserve.Request(uid=u, prompt=p, max_new_tokens=n)
             for u, (p, n) in enumerate(specs)]).items()}
        assert got == want, impl
        assert teng.decode_steps == jeng.decode_steps


# ---------------------------------------------------------------------------
# the training CLI on granite-3-2b (the reference's CLI tests)
# ---------------------------------------------------------------------------


def _train_cli(*extra):
    from repro_torch.launch import train as ttrain
    return ttrain.main(["--device", "cpu", "--arch", "granite-3-2b", "--reduced",
                        "--optimizer", "adam", "--lr", "1e-3", "--log-every",
                        "100", *extra])


def _timeline(path):
    from repro_torch.engine.timeline import Timeline
    with open(path) as f:
        return Timeline.from_json(json.load(f))


def test_train_cli_adaptive_with_thermal_trace(tmp_path):
    """``tests/test_engine.py::test_train_cli_adaptive_with_thermal_trace``."""
    out = str(tmp_path / "tl.json")
    losses = _train_cli("--steps", "16", "--batch", "8", "--seq", "32",
                        "--adaptive", "--thermal-trace", "0.6:0.3:6.0",
                        "--timeline-out", out)
    assert len(losses) == 16
    assert any(m.reason == "interference" for m in _timeline(out).migrations), \
        "a 6x thermal throttle must trigger at least one downgrade"


def test_train_cli_adaptive_with_trace(tmp_path):
    """``tests/test_engine.py::test_train_cli_adaptive_with_trace``."""
    out = str(tmp_path / "tl.json")
    losses = _train_cli("--steps", "14", "--batch", "8", "--seq", "32",
                        "--adaptive", "--interference-trace", "4:10:8.0",
                        "--timeline-out", out)
    assert len(losses) == 14
    tl = _timeline(out)
    assert any(m.reason == "interference" for m in tl.migrations), \
        "an 8x burst must trigger at least one downgrade"
    assert len(tl.steps) == 14


def test_training_reduces_loss_end_to_end():
    """``tests/test_system.py::test_training_reduces_loss_end_to_end``."""
    losses = _train_cli("--steps", "15", "--batch", "4", "--seq", "32")
    assert losses[-1] < losses[0]
