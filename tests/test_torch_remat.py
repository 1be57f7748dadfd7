"""Activation checkpointing (``remat``) and the LR schedules on the port,
against the JAX package.

The reference checkpoints each dense block with ``jax.checkpoint`` under
``REMAT_POLICIES`` (``"dots"``: ``dots_with_no_batch_dims_saveable``,
``"full"``: ``nothing_saveable``); the port with ``torch.utils.checkpoint``
(``"full"``: the block's inputs only; ``"dots"``: selective checkpointing
that keeps the outputs of the 2-D-weight projections). Reduced llama3.2-1b
and nemotron-4-15b (RMSNorm and SwiGLU; LayerNorm and squared ReLU),
initialised by JAX and carried over through numpy.

- Loss and gradients under each policy against JAX's under the same policy
  at 2e-5 (f32; the two differ in the order of f32 sums only).
- On the CPU a recomputation repeats the same arithmetic, so the port's
  ``dots`` and ``full`` gradients equal its ``none`` bit for bit.
- What a policy keeps, seen through ``saved_tensors_hooks`` and the
  selective policy's decisions.
- A ``Rung(remat="full")`` adam step against the JAX rung's.
- ``warmup_linear`` and ``cosine_schedule``: the reference's
  ``tests/test_optim.py::test_schedules``, and every step 0-120 against
  JAX's within 1e-6 (f32 ``cos`` differs by an ulp at a few steps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.engine.rungs import Rung as JRung
from repro.launch import steps as jsteps
from repro.launch.train import make_batch_fn
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro.optim import schedule as jschedule
from repro_torch.engine.rungs import Rung
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_numpy_train_state, from_numpy_tree
from repro_torch.optim import cosine_schedule, warmup_linear
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedule as tschedule
from repro_torch.tree import tree_leaves

ARCHS = ["llama3.2-1b", "nemotron-4-15b"]
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
    return cfg, jax_build_model(cfg).init(jax.random.PRNGKey(0))


def _tokens(cfg, B=2, S=19):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _torch_loss_grads(cfg, jparams, impl, remat, toks):
    model = build_model(cfg, impl=impl, remat=remat, chunk=8, device="cpu")
    params = from_numpy_tree(_np_tree(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = model.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(_flat(params).keys(), grads))


@pytest.mark.parametrize("impl,remat", [("pallas", "none"), ("pallas", "dots"),
                                        ("pallas", "full"), ("naive", "dots"),
                                        ("naive", "full")])
def test_loss_and_grads_match_jax_checkpoint(arch, impl, remat):
    cfg, jparams = arch
    toks = _tokens(cfg)
    jmodel = jax_build_model(cfg, impl=impl, remat=remat)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": jnp.asarray(toks)})
    loss, got = _torch_loss_grads(cfg, jparams, impl, remat, toks)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = _flat(_np_tree(jgrads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32, err_msg=k)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_recomputed_grads_equal_none_bitwise(arch, impl):
    cfg, jparams = arch
    toks = _tokens(cfg)
    base_loss, base = _torch_loss_grads(cfg, jparams, impl, "none", toks)
    for remat in ("dots", "full"):
        loss, got = _torch_loss_grads(cfg, jparams, impl, remat, toks)
        assert torch.equal(loss, base_loss), remat
        for k in base:
            assert torch.equal(got[k], base[k]), (remat, k)


# ---------------------------------------------------------------------------
# what each policy keeps
# ---------------------------------------------------------------------------


def _observe(monkeypatch, cfg, params, impl, remat, toks):
    """Run the loss under ``saved_tensors_hooks``. Returns (tensors packed
    while a block ran, tensors packed outside the blocks, each block's input
    h, the selective policy's saved decisions as (op, args))."""
    inside = []
    packed_in, packed_out, block_inputs, saved = [], [], [], []
    block = transformer.dense_block
    policy = transformer._dots_policy

    def traced_block(p, h, *args, **kwargs):
        block_inputs.append(h)
        inside.append(True)
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
        (packed_in if inside else packed_out).append(t)
        return t

    monkeypatch.setattr(transformer, "dense_block", traced_block)
    monkeypatch.setitem(transformer.REMAT_POLICIES, "dots", functools.partial(
        transformer.create_selective_checkpoint_contexts, recorded_policy))
    model = build_model(cfg, impl=impl, remat=remat, device="cpu")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(params, {"tokens": torch.from_numpy(toks)})
    monkeypatch.undo()
    return packed_in, packed_out, block_inputs, saved


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_policies_keep_what_the_reference_policies_keep(arch, monkeypatch, impl):
    cfg, jparams = arch
    params = from_numpy_tree(_np_tree(jparams), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    toks = _tokens(cfg)
    none_in, none_out, _, _ = _observe(monkeypatch, cfg, params, impl, "none", toks)
    assert len(none_in) > 20 * cfg.n_layers  # attention, norms, activations
    projections = 7 if cfg.activation != "relu2" else 6  # q k v o (gate) up down
    weight_ptrs = {w.data_ptr()
                   for lp in transformer._layer_views(params["layers"], cfg.n_layers)
                   for part in ("attn", "mlp") for w in lp[part].values()}
    for remat in ("full", "dots"):
        packed_in, packed_out, inputs, saved = _observe(monkeypatch, cfg, params,
                                                        impl, remat, toks)
        # nothing is packed while a block runs: its activations are not kept
        assert packed_in == [], remat
        # outside the blocks: what `none` keeps there, plus each block's
        # tensor inputs, h and the int positions
        assert len(inputs) == cfg.n_layers
        assert len(packed_out) == len(none_out) + 2 * cfg.n_layers, remat
        assert sum(any(t is h for h in inputs) for t in packed_out) == cfg.n_layers
        assert sum(t.dtype == torch.int32 for t in packed_out) == cfg.n_layers
        if remat == "full":
            assert saved == []
            continue
        # dots: exactly the projections' outputs, x @ W with W one of the
        # block's 2-D weights; nothing of attention's batched products, the
        # kernels, norms or activations
        assert len(saved) == projections * cfg.n_layers
        for op, (x, w) in saved:
            assert op is torch.ops.aten.mm.default
            assert x.dim() == w.dim() == 2 and w.data_ptr() in weight_ptrs


# ---------------------------------------------------------------------------
# a remat rung's train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_rung_step_matches_jax(remat):
    """Two adam steps (lr 3e-4) of ``Rung(remat=...)``'s compiled step from
    one JAX-initialised state, under ``tests/test_torch_train.py``'s rules:
    losses and gradient norms at 1e-4, parameters at 1e-6 but where a
    gradient lies at its tensor's f32 noise floor (2 x 2 x lr there)."""
    cfg = ASSIGNED["nemotron-4-15b"].reduced()
    lr = 3e-4
    jrung = JRung(name="r", attn_impl="pallas", remat=remat)
    trung = Rung(name="r", attn_impl="pallas", remat=remat)
    jmodel = jrung.build_model(cfg)
    jstate = jsteps.init_train_state(jmodel, jopt.adam(), jax.random.PRNGKey(0))
    tstate = from_numpy_train_state(_np_tree(jstate), device="cpu")
    jstep = jrung.jitted_step(cfg, jopt.adam(), lr=lr)
    tstep = trung.jitted_step(cfg, topt.adam(), lr=lr, device="cpu")
    assert trung.build_model(cfg, "cpu").build_kwargs["remat"] == remat
    batch_fn = make_batch_fn(cfg, 4, 32)
    jgrad = jax.jit(jax.grad(jmodel.loss))
    floor = None
    for i in range(2):
        batch = batch_fn(i)
        g = _flat(_np_tree(jgrad(jstate["params"], batch)))
        low = {k: np.abs(v) < 1e-5 * np.abs(v).max() for k, v in g.items()}
        floor = low if floor is None else {k: floor[k] | low[k] for k in low}
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    got, want = _flat(tstate["params"]), _flat(_np_tree(jstate["params"]))
    assert got.keys() == want.keys()
    for k in want:
        diff = np.abs(got[k].numpy() - want[k])
        assert (diff[~floor[k]] <= 1e-6).all(), (k, diff[~floor[k]].max())
        assert (diff[floor[k]] <= 2 * 2 * lr).all(), k


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def test_schedules():
    """``tests/test_optim.py::test_schedules`` on the port."""
    s = warmup_linear(1.0, 10)
    assert float(s(0)) == pytest.approx(0.1)
    assert float(s(9)) == pytest.approx(1.0)
    c = cosine_schedule(1.0, 100, warmup_steps=10, min_ratio=0.1)
    assert float(c(5)) < 1.0
    assert float(c(99)) == pytest.approx(0.1, abs=0.02)


@pytest.mark.parametrize("make", [
    lambda m: m.warmup_linear(3e-4, 10), lambda m: m.warmup_linear(1.0, 0),
    lambda m: m.cosine_schedule(3e-4, 100, warmup_steps=10),
    lambda m: m.cosine_schedule(1.0, 100), lambda m: m.cosine_schedule(2.0, 7, 20, 0.0)],
    ids=["warmup", "warmup0", "cosine-warmup", "cosine", "cosine-short"])
def test_schedules_match_jax_at_every_step(make):
    jfn, tfn = make(jschedule), make(tschedule)
    for step in range(121):
        want = np.float32(jfn(step))
        for arg in (step, torch.tensor(step), torch.tensor(step, dtype=torch.int32)):
            got = tfn(arg)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0,
                                       err_msg=f"step {step}")
