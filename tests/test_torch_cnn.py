"""The port's CNN family (``repro_torch.models.cnn``) against the JAX
package's ``models/cnn.py``.

ResNet34, MobileNetV2 and ShuffleNetV2 at ``reduced()`` size (ShuffleNetV2
with two units in its first stage, so that one stride-1 basic unit, the
only place it runs the depthwise kernel, is in the cut), from one JAX
initialisation carried over through numpy, on batches of the shared numpy
pipeline. On the CPU the port's depthwise kernel runs its plain version and
the JAX package's runs in Pallas interpret mode.

Tolerances: 1e-4 on logits, losses and gradients (f32 on both sides; the two
differ in the order of f32 sums inside the convs and GroupNorm's
statistics); conv2d alone to 2e-5. Three adam steps: see
``test_build_train_step_matches_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_MODELS
from repro.engine import jobs as jjobs
from repro.engine.events import InterferenceTrace as JTrace
from repro.engine.rungs import default_rung_ladder as jladder
from repro.engine.session import TrainSession as JSession
from repro.launch import steps as jsteps
from repro.launch.train import make_batch_fn
from repro.models import build_model as jax_build_model
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import jobs as tjobs
from repro_torch.engine.events import InterferenceTrace
from repro_torch.engine.rungs import default_rung_ladder
from repro_torch.engine.session import TrainSession
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model, cnn
from repro_torch.models.convert import from_numpy_train_state, from_numpy_tree
from repro_torch.optim import optimizers as topt

ARCHS = ["resnet34", "mobilenet-v2", "shufflenet-v2"]
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 4


def _cfgs(arch):
    """(JAX config, port config) of the test's cut of ``arch``."""
    jcfg = PAPER_MODELS[arch].reduced()
    if arch == "shufflenet-v2":
        jcfg = dataclasses.replace(jcfg, cnn_stages=(2, 1, 1))
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _batch(cfg, step=0):
    return make_batch_fn(cfg, BATCH, 0)(step)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX cfg, port cfg, JAX params, the same params in torch)."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return request.param, jcfg, tcfg, jparams, from_numpy_tree(
        _np_tree(jparams), device="cpu")


def test_config_copies_match_the_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(PAPER_MODELS[arch])
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(PAPER_MODELS[arch].reduced())


def test_cnn_tree_converts_leaf_for_leaf(pair):
    _, _, tcfg, jparams, tparams = pair
    got, want = _flat(tparams), _flat(_np_tree(jparams))
    assert got.keys() == want.keys()
    assert isinstance(tparams["stages"], list) and isinstance(tparams["stages"][0], list)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the port's own init draws the same tree structure and shapes
    own = build_model(tcfg, device="cpu")
    mine = _flat(own.init(own.generator(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_logits_match_jax(pair, impl):
    _, jcfg, tcfg, jparams, tparams = pair
    b = _batch(jcfg)
    want = jcnn.forward_cnn(jparams, jcfg, jnp.asarray(b["images"]),
                            impl="pallas" if impl == "pallas" else "jnp")
    model = build_model(tcfg, impl=impl, device="cpu")
    with torch.no_grad():
        got = model.forward(tparams, _tbatch(b))
    assert got.shape == (BATCH, tcfg.n_classes)
    np.testing.assert_allclose(_to_np(got), np.asarray(want), **TOL)


def test_loss_and_grads_match_jax(pair):
    _, jcfg, tcfg, jparams, tparams = pair
    b = _batch(jcfg, step=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jcnn.loss_cnn(p, jcfg, jb, impl="jnp"))(jparams)
    model = build_model(tcfg, impl="naive", device="cpu")
    leaves = _flat(tparams)
    for v in leaves.values():
        v.requires_grad_()
    loss = model.loss(tparams, _tbatch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = _flat(_np_tree(jgrads))
    assert leaves.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_to_np(leaves[k].grad), want[k], **TOL, err_msg=k)
        leaves[k].grad = None
        leaves[k].requires_grad_(False)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_padding_matches_jax(size, k, stride):
    """XLA's SAME pads the odd row after: at stride 2 on an even size a 3x3
    conv pads 0 before and 1 after, where ``F.conv2d(padding=1)`` would pad
    both sides and shift the result."""
    rng = np.random.default_rng(size * k + stride)
    x = rng.standard_normal((2, size, size + 1, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    want = jcnn.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = cnn.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_matches_jax(stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 10, 9, 58)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 58)).astype(np.float32)
    for impl in ("naive", "pallas"):
        want = jcnn.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                     impl="pallas" if impl == "pallas" else "jnp")
        got = cnn.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                   stride=stride, impl=impl)
        np.testing.assert_allclose(_to_np(got), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_group_norm_steps_the_group_count_down_to_a_divisor():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 3, 58)).astype(np.float32)
    p = {"scale": rng.standard_normal(58).astype(np.float32),
         "bias": rng.standard_normal(58).astype(np.float32)}
    want = jcnn._gn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = cnn._gn(from_numpy_tree(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(_to_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch,launches", [("resnet34", 0), ("mobilenet-v2", 13),
                                           ("shufflenet-v2", 13)])
def test_full_width_forward_reaches_the_depthwise_op(monkeypatch, arch, launches):
    """The published configurations route 13, 13 and 0 depthwise layers a
    forward through the kernel (MobileNetV2: 17 blocks less 4 stride-2 stage
    heads; ShuffleNetV2: its 13 basic units). One 32x32 image at full
    width."""
    calls = []
    real = tops.depthwise_conv
    monkeypatch.setattr(tops, "depthwise_conv",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    cfg = get_config(arch)
    model = build_model(cfg, impl="pallas", device="cpu")
    params = model.init(model.generator(0))
    with torch.no_grad():
        out = model.forward(params, _tbatch(make_batch_fn(cfg, 1, 0)(0)))
    assert out.shape == (1, cfg.n_classes) and bool(torch.isfinite(out).all())
    assert len(calls) == launches


def test_pallas_training_raises_at_the_first_backward():
    _, tcfg = _cfgs("mobilenet-v2")
    model = build_model(tcfg, impl="pallas", device="cpu")
    state = tsteps.init_train_state(model, topt.adam(), model.generator(0))
    step = tsteps.build_train_step(model, topt.adam(), lr=1e-3)
    with pytest.raises(NotImplementedError, match="no gradient"):
        step(state, _batch(tcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_step_matches_jax(arch):
    """Three adam steps (lr 1e-3) from one JAX-initialised state.

    Losses and gradient norms agree to 1e-4 at every step. Adam divides each
    update by the gradient's own scale, so an element whose gradient f32
    does not resolve moves by up to lr in either package whatever its size:
    one below 1e-5 of its tensor's largest gradient, or one where the two
    packages' gradients from the same state differ by more than 1e-3 of it
    (GroupNorm of one channel per group leaves some biases a gradient that
    is zero but for rounding). Such elements, at any of the three steps, are
    held to what three steps can move an element at most, 2 x 3 x lr; all
    others to 1e-5, 1% of one step's largest move. At this cut they are 3.5%
    (ResNet34), 40% (MobileNetV2) and 2.7% (ShuffleNetV2) of the parameters;
    the test requires the held elements to be the majority.
    """
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg, impl="naive")
    tmodel = build_model(tcfg, impl="naive", device="cpu")
    jstate = jsteps.init_train_state(jmodel, jopt.adam(), jax.random.PRNGKey(1))
    tstate = from_numpy_train_state(_np_tree(jstate), device="cpu")
    jstep = jax.jit(jsteps.build_train_step(jmodel, jopt.adam(), lr=1e-3))
    tstep = tsteps.build_train_step(tmodel, topt.adam(), lr=1e-3)
    floor = None
    for i in range(3):
        b = _batch(jcfg, step=i)
        g = _flat(_np_tree(jax.grad(jmodel.loss)(jstate["params"], b)))
        same = from_numpy_tree(_np_tree(jstate["params"]), device="cpu")
        leaves = _flat(same)
        for v in leaves.values():
            v.requires_grad_()
        tmodel.loss(same, _tbatch(b)).backward()
        low = {k: (np.abs(v) < 1e-5 * np.abs(v).max())
               | (np.abs(leaves[k].grad.numpy() - v) > 1e-3 * np.abs(v))
               for k, v in g.items()}
        floor = low if floor is None else {k: floor[k] | low[k] for k in low}
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, b)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    got, want = _flat(tstate["params"]), _flat(_np_tree(jstate["params"]))
    assert got.keys() == want.keys()
    n_floor = 0
    for k in want:
        diff = np.abs(got[k].numpy() - want[k])
        assert (diff[~floor[k]] <= 1e-5).all(), (k, diff[~floor[k]].max())
        assert (diff[floor[k]] <= 2 * 3 * 1e-3).all(), k
        n_floor += int(floor[k].sum())
    assert n_floor < 0.5 * sum(v.size for v in want.values()), n_floor
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def _ladder(make):
    rungs = make(batch=8, microbatch=1, attn_impl="naive", include_bf16=False)
    for r in rungs:
        r.latency_estimate_s = 0.1 * r.rel_latency
    return rungs


def _migrations(timeline):
    return [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
            for m in timeline.migrations]


def test_session_migrations_match_jax_on_mobilenet():
    """The adaptive ladder without its bf16 rung (the one a CNN can run in
    the reference) under the interference trace 2:6:3.0, 10 steps."""
    jcfg = PAPER_MODELS["mobilenet-v2"].reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jstate = jsteps.init_train_state(jax_build_model(jcfg, impl="naive"), jopt.adam(),
                                     jax.random.PRNGKey(0))
    tstate = from_numpy_train_state(_np_tree(jstate), device="cpu")
    jtrace, ttrace = JTrace.parse("2:6:3.0"), InterferenceTrace.parse("2:6:3.0")
    jres = JSession(jcfg, _ladder(jladder), optimizer=jopt.adam(), lr=1e-3,
                    batch_fn=make_batch_fn(jcfg, 8, 0),
                    latency_fn=jjobs.trace_latency_fn(jtrace), trace=jtrace,
                    adaptive=True, verbose=False).run(10, state=jstate)
    tres = TrainSession(tcfg, _ladder(default_rung_ladder), optimizer=topt.adam(),
                        lr=1e-3, batch_fn=make_batch_fn(tcfg, 8, 0),
                        latency_fn=tjobs.trace_latency_fn(ttrace), trace=ttrace,
                        adaptive=True, verbose=False, device="cpu").run(10, state=tstate)
    got, want = _migrations(tres.timeline), _migrations(jres.timeline)
    assert got == want and got, got
    assert {m[4] for m in got} == {"in-place"}
    assert [s.rung for s in tres.timeline.steps] == [s.rung for s in jres.timeline.steps]
    assert tres.final_rung == jres.final_rung
    # the first three steps as in test_build_train_step_matches_jax; later
    # ones drift apart by adam's amplification of unresolved gradients
    np.testing.assert_allclose(tres.losses[:3], jres.losses[:3], rtol=1e-4)
    assert len(tres.losses) == 10 and all(np.isfinite(tres.losses))


def test_serve_cli_refuses_cnn_archs():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="CNN archs have no decode path"):
        serve.main(["--device", "cpu", "--arch", "mobilenet-v2", "--reduced"])


def test_train_cli_trains_a_cnn(capsys):
    from repro_torch.launch import train
    losses = train.main(["--device", "cpu", "--arch", "shufflenet-v2", "--reduced",
                         "--steps", "3", "--batch", "4", "--optimizer", "adam",
                         "--lr", "1e-3", "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
