"""The port's training path against the JAX package's.

Loss and gradients of ``loss_decoder``, the optimizers, the gradient
compressor, ``build_train_step`` and the checkpoint format, at
``ModelConfig.reduced()`` size, with parameters and states initialised by
JAX and carried over through numpy (``repro_torch.models.convert``), and
batches from the shared numpy pipeline.

Tolerances: 1e-4 on losses and gradients (f32 on both sides; the two differ
in the order of f32 sums through two decoder layers and a 256-way softmax),
1e-6 on optimizer updates from the same gradients, and 1e-6 on parameters
after three adam steps at lr 3e-4. An adam update is lr times m / (sqrt(v) +
1e-8), so summation-order noise in the gradients moves it far below 1e-6 —
except for an element whose gradient sits at its tensor's f32 noise floor
(below 1e-5 of the tensor's largest gradient, i.e. within a few hundred
ulps of the sums that cancel to it), where eps = 1e-8 turns a 2% difference
of a 2e-8 gradient into a ~1e-6 move. Those elements (171 of the 90432,
mostly embedding rows of tokens the batches hold rarely) are held to what
three adam steps can move an element at most, 2 x 3 x lr, and counted.
"""
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ASSIGNED
from repro.launch import steps as jsteps
from repro.launch.train import make_batch_fn
from repro.models import build_model as jax_build_model
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import msgpack_lite
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_train_state, from_numpy_tree
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves

CFG = ASSIGNED["llama3.2-1b"].reduced()
TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (tuples/lists by index)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _assert_trees_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        a = got_np = g[k]
        if isinstance(a, torch.Tensor):
            got_np = a.detach().float().numpy() if a.is_floating_point() else a.numpy()
        np.testing.assert_allclose(got_np, np.asarray(w[k], np.float64), **tol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jparams():
    return jax_build_model(CFG).init(jax.random.PRNGKey(0))


def _batch(step=0, batch=4, seq=32):
    return make_batch_fn(CFG, batch, seq)(step)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_loss_decoder_value_and_grads_match_jax(jparams, impl):
    batch = _batch(seq=40)
    jmodel = jax_build_model(CFG, impl=impl, chunk=16)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, batch)

    model = build_model(CFG, impl=impl, chunk=16, device="cpu")
    params = from_numpy_tree(_np_tree(jparams), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = model.loss(params, {"tokens": torch.from_numpy(batch["tokens"])})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = _flat(_np_tree(jgrads))
    got = dict(zip(_flat(params).keys(), grads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)


def test_unknown_remat_policy_is_refused():
    """``none``, ``dots`` and ``full`` are the reference's policies (the
    last two are held to ``jax.checkpoint`` in ``tests/test_torch_remat.py``);
    any other name raises."""
    model = build_model(CFG, impl="naive", remat="offload", device="cpu")
    params = model.init(model.generator(0))
    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        model.loss(params, {"tokens": torch.zeros(1, 8, dtype=torch.int32)})


# ---------------------------------------------------------------------------
# optimizers and compression
# ---------------------------------------------------------------------------


def _param_grad_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return draw(shapes, 1.0), [draw(shapes, 0.1) for _ in range(3)]


@pytest.mark.parametrize("make", [
    lambda m: m.sgd(), lambda m: m.sgd(momentum=0.9),
    lambda m: m.sgd(momentum=0.9, nesterov=True), lambda m: m.adam(),
    lambda m: m.adam(weight_decay=0.01)],
    ids=["sgd", "momentum", "nesterov", "adam", "adamw"])
def test_optimizer_updates_match_jax(make):
    params, grads = _param_grad_trees(1)
    jo, to = make(jopt), make(topt)
    assert jo.name == to.name and jo.bytes_per_param == to.bytes_per_param
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = from_numpy_tree(params, device="cpu")
    ts = to.init(tp)
    for g in grads:
        jupd, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, 3e-2)
        jp = jopt.apply_updates(jp, jupd)
        tupd, ts = to.update(from_numpy_tree(g, device="cpu"), ts, tp, 3e-2)
        tp = topt.apply_updates(tp, tupd)
        _assert_trees_close(tupd, _np_tree(jupd), rtol=1e-6, atol=1e-6)
    _assert_trees_close(tp, _np_tree(jp), rtol=1e-6, atol=1e-6)
    _assert_trees_close(ts, _np_tree(js), rtol=1e-6, atol=1e-6)


def test_adam_keeps_f32_moments_under_bf16_params():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = topt.adam()
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.float32
    upd, state = opt.update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)},
                            state, params, 1e-2)
    assert upd["w"].dtype == torch.bfloat16 and state["v"]["w"].dtype == torch.float32


@pytest.mark.parametrize("scheme", ["int8", "topk:0.25", "int8+topk:0.25"])
def test_compressor_round_trip_matches_jax(scheme):
    _, grads = _param_grad_trees(2)
    jc, tc = jcomp.Compressor(scheme), tcomp.Compressor(scheme)
    assert jc.ratio() == tc.ratio()
    jerr = jc.init_error(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    terr = tc.init_error(from_numpy_tree(grads[0], device="cpu"))
    for g in grads:  # error feedback carries across rounds
        jdec, jerr = jc.roundtrip(jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tdec, terr = tc.roundtrip(from_numpy_tree(g, device="cpu"), terr)
        _assert_trees_close(tdec, _np_tree(jdec), rtol=1e-6, atol=1e-6)
        _assert_trees_close(terr, _np_tree(jerr), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [1, 2])
def test_build_train_step_matches_jax(jparams, microbatch):
    """Three adam steps (lr 3e-4) from one JAX-initialised state."""
    impl = "pallas"
    jmodel = jax_build_model(CFG, impl=impl)
    jstate = jsteps.init_train_state(jmodel, jopt.adam(), jax.random.PRNGKey(0))
    tstate = from_numpy_train_state(_np_tree(jstate), device="cpu")
    jstep = jax.jit(jsteps.build_train_step(jmodel, jopt.adam(),
                                            microbatch=microbatch, lr=3e-4))
    tstep = tsteps.build_train_step(build_model(CFG, impl=impl, device="cpu"),
                                    topt.adam(), microbatch=microbatch, lr=3e-4)
    floor = None  # per leaf: gradient at the f32 noise floor at some step
    for i in range(3):
        batch = _batch(step=i)
        g = _flat(_np_tree(jax.grad(jmodel.loss)(jstate["params"], batch)))
        low = {k: np.abs(v) < 1e-5 * np.abs(v).max() for k, v in g.items()}
        floor = low if floor is None else {k: floor[k] | low[k] for k in low}
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    got, want = _flat(tstate["params"]), _flat(_np_tree(jstate["params"]))
    assert got.keys() == want.keys()
    n_floor = 0
    for k in want:
        diff = np.abs(got[k].numpy() - want[k])
        assert (diff[~floor[k]] <= 1e-6).all(), (k, diff[~floor[k]].max())
        assert (diff[floor[k]] <= 2 * 3 * 3e-4).all(), k
        n_floor += int(floor[k].sum())
    assert n_floor < 1e-2 * sum(v.size for v in want.values()), n_floor
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert int(tstate["opt"]["t"]) == 3


def test_train_step_updates_the_state_in_place():
    model = build_model(CFG, impl="naive", device="cpu")
    state = tsteps.init_train_state(model, topt.adam(), model.generator(0))
    embed = state["params"]["embed"]
    before = embed.clone()
    new, metrics = tsteps.build_train_step(model, topt.adam(), lr=1e-2)(
        state, _batch())
    assert new["params"]["embed"] is embed and not torch.equal(embed, before)
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0


def test_cast_params_casts_floating_leaves_only():
    tree = {"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    out = tsteps.cast_params(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _jax_state():
    return {"params": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                       "h": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)},
            "opt": {"m": {"w": jnp.ones((2, 3)) * 0.5}, "t": jnp.asarray(4, jnp.int32)},
            "err": (), "step": jnp.asarray(7, jnp.int32)}


def test_jax_checkpoint_restores_in_the_port(tmp_path, monkeypatch):
    JManager(str(tmp_path)).save(7, _jax_state())
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # the port decodes bf16 itself
    step, state = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 7
    assert state["params"]["h"].dtype == torch.bfloat16
    assert state["params"]["h"].tolist() == [1.5, -2.25, 3.0]
    assert state["err"] == () and state["step"].dtype == torch.int32
    assert int(state["step"]) == 7 and int(state["opt"]["t"]) == 4
    np.testing.assert_array_equal(state["params"]["w"].numpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))


def test_port_checkpoint_restores_in_jax(tmp_path):
    tstate = from_numpy_train_state(_np_tree(_jax_state()), device="cpu")
    CheckpointManager(str(tmp_path)).save(7, tstate)
    step, state = JManager(str(tmp_path)).restore_latest()
    assert step == 7 and state["err"] == ()
    assert state["params"]["h"].dtype.name == "bfloat16"
    assert state["step"].dtype == np.int32 and int(state["step"]) == 7
    _assert_trees_close(tstate, state, rtol=0, atol=0)
    # the full state round-trips back into the port unchanged
    back = from_numpy_train_state(state, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_own_msgpack_codec_matches_msgpack():
    state = from_numpy_train_state(_np_tree(_jax_state()), device="cpu")
    encoded = tstore._encode({"step": 7, "state": state})

    def to_bytes(node):  # the store hands array buffers over as memoryviews
        if isinstance(node, dict):
            return {k: to_bytes(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_bytes(v) for v in node]
        return bytes(node) if isinstance(node, memoryview) else node

    want = msgpack.packb(to_bytes(encoded), use_bin_type=True)
    assert msgpack_lite.packb(encoded) == want
    jenc = jstore._encode({"step": 7, "state": _np_tree(_jax_state())})
    assert msgpack_lite.packb(jenc) == msgpack.packb(jenc, use_bin_type=True) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)
    odd = {"n": [None, True, False, -1, -200, 70000, 2 ** 40, -2 ** 40, 0.1,
                 "é" * 40, b"\x00" * 300, list(range(20))]}
    assert msgpack_lite.packb(odd) == msgpack.packb(odd, use_bin_type=True)
    assert msgpack_lite.unpackb(msgpack_lite.packb(odd)) == odd


def test_restore_latest_skips_a_torn_newest_file(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.ones(4)})
    path = mgr.save(6, {"w": torch.full((4,), 2.0)})
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])  # a torn write
    with pytest.warns(RuntimeWarning, match="step 6 unreadable"):
        step, state = mgr.restore_latest()
    assert step == 3 and torch.equal(state["w"], torch.ones(4))


def test_level_zero_stores_an_uncompressed_payload_jax_reads(tmp_path):
    tree = {"w": torch.randn(64), "s": (1, "x")}
    tstore.save_pytree(tree, str(tmp_path / "a.ckpt"), level=0)
    back = jstore.load_pytree(str(tmp_path / "a.ckpt"))
    np.testing.assert_array_equal(back["w"], tree["w"].numpy())
    assert back["s"] == (1, "x")
