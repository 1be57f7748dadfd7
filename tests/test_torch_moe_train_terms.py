"""Training of the moe family on the port against the JAX package: the
loss's terms and what surrounds ``loss_decoder``.

``tests/test_torch_moe_train.py``'s reduced deepseek configs, skewed
routers and decision recorder (its fixtures and helpers, imported):

- ``Model.loss`` passes ``moe_cf`` on;
- the aux term and the MTP term, each on its own, with their gradients;
- what ``dots`` and ``full`` keep, as ``tests/test_torch_remat.py`` checks
  it for the dense archs;
- an empty stack of layers draws nothing, and deepseek-v3 cut to its dense
  layer and the MTP head has the reference's tree, loss and gradients.

Every comparison with JAX also asserts that the two packages took the
same routing and capacity decisions. Tolerance: 2e-5 in f32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models import transformer as jtr
from repro.models.common import apply_norm as japply_norm
from repro.models.common import cross_entropy as jcross_entropy
from repro.models.common import embed_tokens as jembed_tokens
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_numpy_tree
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves
from test_torch_moe_train import (F32, _assert_grads_close, _flat,  # noqa: F401
                                  _np_tree, _port_value_and_grad, _tokens, arch,
                                  assert_same_decisions, recorder)


def test_capacity_factor_reaches_the_loss(arch):
    """``Model.loss`` passes ``moe_cf`` on: at 1.25 (tokens dropped) it is
    ``loss_decoder`` at 1.25, not at 100, and the two differ."""
    cfg, _, np_params = arch
    params = from_numpy_tree(np_params, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    with torch.no_grad():
        at = {cf: float(transformer.loss_decoder(params, cfg, batch, impl="naive",
                                                 moe_cf=cf)) for cf in (1.25, 100.0)}
        for cf in (1.25, 100.0):
            model = build_model(cfg, impl="naive", moe_cf=cf, device="cpu")
            assert float(model.loss(params, batch)) == at[cf]
    assert at[1.25] != at[100.0]


# ---------------------------------------------------------------------------
# the aux and MTP terms on their own
# ---------------------------------------------------------------------------


def _jax_mtp_term(params, cfg, tokens):
    """The reference's MTP term (``src/repro/models/transformer.py``'s
    ``loss_decoder``), before its factor 0.3."""
    _, _, h = jtr.forward_decoder(params, cfg, tokens, impl="naive")
    mtp = params["mtp"]
    emb_next = jembed_tokens(params["embed"], tokens[:, 1:-1])
    u = jnp.concatenate([h[:, :-2], emb_next], axis=-1) @ mtp["proj"]
    B, S2 = tokens.shape[0], tokens.shape[1] - 2
    pos = jnp.broadcast_to(jnp.arange(S2, dtype=jnp.int32)[None], (B, S2))
    u, _ = jtr.dense_block(mtp["block"], u, cfg, pos, "naive", 1024)
    logits = jtr._logits(params, cfg, japply_norm(mtp["ln"], u, cfg.norm))
    return jcross_entropy(logits, tokens[:, 2:])


def _port_mtp_term(params, cfg, tokens):
    _, _, h = transformer.forward_decoder(params, cfg, tokens, impl="naive",
                                          with_aux=True)
    return transformer._mtp_loss(params, cfg, h, tokens, "naive", 1024)


def test_aux_term_matches_jax(arch, recorder):
    """The summed router aux loss of the MoE layers, and its gradients."""
    cfg, jparams, np_params = arch
    toks = _tokens(cfg)

    def jaux(p):
        return jtr.forward_decoder(p, cfg, jnp.asarray(toks), impl="naive")[1]

    want, jgrads = jax.jit(jax.value_and_grad(jaux))(jparams)
    got, grads = _port_value_and_grad(
        cfg, np_params, "naive", "none", 1.25, toks,
        lambda p, b: transformer.forward_decoder(p, cfg, b["tokens"], impl="naive",
                                                 with_aux=True)[1])
    assert_same_decisions(*recorder.take())
    assert got > 0
    np.testing.assert_allclose(got, float(want), **F32)
    _assert_grads_close(grads, _flat(_np_tree(jgrads)), F32)


def test_mtp_term_matches_jax(arch, recorder):
    """deepseek-v3's MTP cross-entropy on token t+2, and its gradients;
    deepseek-moe-16b has no MTP head and its loss no MTP term."""
    cfg, jparams, np_params = arch
    toks = _tokens(cfg)
    if not cfg.n_mtp_modules:
        assert "mtp" not in np_params
        return
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_mtp_term(p, cfg, jnp.asarray(toks))))(jparams)
    got, grads = _port_value_and_grad(cfg, np_params, "naive", "none", 1.25, toks,
                                      lambda p, b: _port_mtp_term(p, cfg, b["tokens"]))
    assert_same_decisions(*recorder.take())
    np.testing.assert_allclose(got, float(want), **F32)
    _assert_grads_close(grads, _flat(_np_tree(jgrads)), F32)
    assert float(np.abs(_flat(_np_tree(jgrads))["mtp/proj"]).max()) > 0


# ---------------------------------------------------------------------------
# what each remat policy keeps
# ---------------------------------------------------------------------------


def _observe(monkeypatch, cfg, params, remat, toks):
    """``tests/test_torch_remat.py``'s observation: (tensors packed while a
    block ran, tensors packed outside, each block's input h, the selective
    policy's saved (op, args))."""
    inside, packed_in, packed_out, block_inputs, saved = [], [], [], [], []
    block, policy = transformer.dense_block, transformer._dots_policy

    def traced_block(p, h, *args, **kwargs):
        stack = len(block_inputs) < cfg.n_layers  # else the MTP head's block
        block_inputs.append(h)
        inside.append(stack)
        try:
            return block(p, h, *args, **kwargs)
        finally:
            inside.pop()

    def recorded_policy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision.name == "MUST_SAVE":
            saved.append((op, args))
        return decision

    def pack(t):
        (packed_in if inside and inside[-1] else packed_out).append(t)
        return t

    with monkeypatch.context() as m:
        m.setattr(transformer, "dense_block", traced_block)
        m.setitem(transformer.REMAT_POLICIES, "dots", functools.partial(
            transformer.create_selective_checkpoint_contexts, recorded_policy))
        model = build_model(cfg, impl="naive", remat=remat, device="cpu")
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(params, {"tokens": torch.from_numpy(toks)})
    return packed_in, packed_out, block_inputs, saved


def test_policies_keep_what_the_reference_policies_keep(arch, monkeypatch):
    """``full`` keeps only each block's inputs; ``dots``
    (``dots_with_no_batch_dims_saveable``) keeps exactly the outputs of the
    products with a 2-D weight: the attention's projections, the router,
    the shared experts and the dense MLP, and nothing of the experts'
    batched products. The MTP head's block is not checkpointed, as in the
    reference (its tensors are kept outside the blocks)."""
    cfg, _, np_params = arch
    params = from_numpy_tree(np_params, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    toks = _tokens(cfg)
    mtp = 1 if cfg.n_mtp_modules else 0
    _, none_out, _, _ = _observe(monkeypatch, cfg, params, "none", toks)
    views = transformer._stack_views(params, cfg)
    weights = [w for lp in views for w in tree_leaves(lp) if w.dim() == 2]
    ptrs = {w.data_ptr() for w in weights}
    for remat in ("full", "dots"):
        packed_in, packed_out, inputs, saved = _observe(monkeypatch, cfg, params,
                                                        remat, toks)
        n = cfg.n_layers
        assert len(inputs) == n + mtp
        # a checkpointed block packs nothing while it runs; outside them:
        # what `none` keeps there (the MTP block, which is not checkpointed,
        # among it), plus each block's tensor inputs, h and the positions
        assert packed_in == [], remat
        assert len(packed_out) == len(none_out) + 2 * n, remat
        assert sum(any(t is h for h in inputs[:n]) for t in packed_out) == n
        if remat == "full":
            assert saved == []
            continue
        assert len(saved) == len(weights)
        for op, (x, w) in saved:
            assert op is torch.ops.aten.mm.default
            assert x.dim() == w.dim() == 2 and w.data_ptr() in ptrs


# ---------------------------------------------------------------------------
# an empty stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v3-671b"], indirect=True)
def test_an_empty_stack_draws_nothing_and_trains(arch, recorder):
    """``_init_stacked(0, ...)`` draws nothing and keeps (0, ...) leaves, as
    ``jax.vmap`` over no keys does; deepseek-v3 cut to its dense layer and
    the MTP head (``n_layers=1, first_k_dense=1``) has the reference's tree,
    loss and gradients, and a train step gives its empty leaves zero
    gradients."""
    cfg, _, np_params = arch
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    empty = transformer._init_stacked(
        0, lambda: transformer.init_dense_layer(gen, cfg, moe=True))
    assert torch.equal(gen.get_state(), before)
    assert all(v.shape[0] == 0 for v in tree_leaves(empty))
    jcut = dataclasses.replace(cfg, n_layers=1, first_k_dense=1)
    cut = dataclasses.replace(get_config(cfg.name).reduced(), n_layers=1, first_k_dense=1)
    want = _flat(jax.eval_shape(jax_build_model(jcut).init, jax.random.PRNGKey(0)))
    own = _flat(transformer.init_decoder(torch.Generator().manual_seed(0), cut))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # the reduced model's params, its MoE layer cut away
    params = dict(np_params, layers=jax.tree_util.tree_map(lambda a: a[:0],
                                                           np_params["layers"]))
    toks = _tokens(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcut, impl="naive").loss))(
        jax.tree_util.tree_map(jnp.asarray, params), {"tokens": jnp.asarray(toks)})
    model = build_model(cut, impl="naive", device="cpu")
    loss, grads = _port_value_and_grad(cut, params, "naive", "none", 1.25, toks)
    assert recorder.take() == ([], [])  # no MoE layer ran
    np.testing.assert_allclose(loss, float(jloss), **F32)
    _assert_grads_close(grads, _flat(_np_tree(jgrads)), F32)
    state = tsteps.init_train_state(model, topt.adam(), model.generator(0))
    state, metrics = tsteps.build_train_step(model, topt.adam(), lr=3e-4)(
        state, {"tokens": toks})
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    assert state["params"]["layers"]["moe"]["router"].shape[0] == 0
