"""Compiled steps (``launch/steps.CompiledStep``, the port's ``jax.jit``) on
the CPU.

On the CPU a compiled step runs eagerly, so ``jit=True`` must give bitwise
the results of ``jit=False`` for every builder. The CUDA graph itself runs
only on the card (``tests/test_torch_cuda.py``); here a stub stands in for
it (``_StubStep``: the capture runs the step once, a replay runs nothing) to
drive the bookkeeping around it: the eager first call, the capture, the
replays, the recapture when the state moves, the outputs and the launch
counts, with the wrappers' real counters. The repaired capture blockers
(``rope_freqs`` without a host tensor, adam's and the step counter's
in-place updates) are held against the JAX package at 2e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.models import common as jcommon
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.rungs import Rung
from repro_torch.engine.session import TrainSession
from repro_torch.kernels import depthwise_conv, flash_attention, flash_backward
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

CFG = ASSIGNED["llama3.2-1b"].reduced()
TINY = ModelConfig(name="compiled-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   tie_embeddings=True, source="tests/test_torch_compiled.py")
F32 = dict(rtol=2e-5, atol=2e-5)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# jit=True against jit=False on the CPU, bitwise
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    model = build_model(TINY, impl="pallas", device="cpu")
    params = model.init(model.generator(0))
    return model, params


def _serve_inputs(model, layout, S, seed):
    g = torch.Generator().manual_seed(seed)
    B, bs, T = 3, 4, 6
    if layout == "paged":
        cache = model.init_paged_cache(B * T + 1, bs, torch.float32)
        table = torch.randperm(B * T, generator=g)[:B * T].reshape(B, T) + 1
        extra = (table.to(torch.int32),)
    else:
        cache = model.init_cache(B, bs * T, torch.float32)
        extra = ()
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=g))
    tokens = torch.randint(0, TINY.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    cache_len = torch.tensor([0, 5, bs * T - S - 1], dtype=torch.int32)
    return cache, tokens, cache_len, extra


@pytest.mark.parametrize("layout", ["contig", "paged"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_jit_builders_match_eager_bitwise(tiny, layout, kind):
    model, params = tiny
    builders = {("decode", "contig"): tsteps.build_decode_step,
                ("decode", "paged"): tsteps.build_paged_decode_step,
                ("verify", "contig"): tsteps.build_spec_decode_step,
                ("verify", "paged"): tsteps.build_paged_spec_decode_step}
    build = builders[(kind, layout)]
    jitted, eager = build(model, jit=True), build(model, jit=False)
    assert isinstance(jitted, tsteps.CompiledStep)
    assert not isinstance(eager, tsteps.CompiledStep)
    for S in ((1,) if kind == "decode" else (2, 5, 3)):
        cache, tokens, cache_len, extra = _serve_inputs(model, layout, S, S)
        cache_e = _clone(cache)
        got = jitted(params, cache, tokens, cache_len, *extra)
        want = eager(params, cache_e, tokens, cache_len, *extra)
        assert got[-1] is cache  # the cache comes back, written in place
        _assert_same(got[:-1], want[:-1])
        _assert_same(cache, cache_e)
        assert jitted.last_call == "eager"


@pytest.mark.parametrize("jit", [True, False])
def test_jitted_train_step_matches_eager_bitwise(jit):
    """Three adam steps at microbatch 2 through ``Rung.jitted_step`` equal
    the raw step's, state and metrics."""
    model = build_model(CFG, impl="pallas", device="cpu")
    opt = topt.adam()
    s0 = tsteps.init_train_state(model, opt, model.generator(0))
    s1 = _clone(s0)
    batch_fn = make_batch_fn(CFG, 4, 16, seed=0)
    rung = Rung(name="mb2", microbatch=2, attn_impl="pallas")
    step = rung.jitted_step(CFG, opt, lr=1e-2, device="cpu", jit=jit)
    assert isinstance(step, tsteps.CompiledStep) == jit
    assert rung.jitted_step(CFG, opt, lr=1e-2, device="cpu", jit=jit) is step
    raw = tsteps.build_train_step(build_model(CFG, impl="pallas", device="cpu"),
                                  opt, microbatch=2, lr=1e-2)
    for i in range(3):
        s0, m0 = step(s0, batch_fn(i))
        s1, m1 = raw(s1, batch_fn(i))
        _assert_same(m0, m1)
    _assert_same(s0, s1)
    assert int(s0["step"]) == 3 and int(s0["opt"]["t"]) == 3


def test_train_step_advances_step_and_t_in_place():
    model = build_model(TINY, impl="naive", device="cpu")
    opt = topt.adam()
    state = tsteps.init_train_state(model, opt, model.generator(0))
    step_t, t_t = state["step"], state["opt"]["t"]
    fn = tsteps.build_train_step(model, opt, lr=1e-3)
    batch = make_batch_fn(TINY, 2, 8, seed=0)(0)
    for i in range(1, 3):
        new, _ = fn(state, batch)
        assert new["step"] is step_t and new["opt"]["t"] is t_t
        assert int(step_t) == i and int(t_t) == i
        state = new


# ---------------------------------------------------------------------------
# the bookkeeping around the graph, with a stub in its place
# ---------------------------------------------------------------------------


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StubStep(tsteps.CompiledStep):
    """A CompiledStep that takes CPU tensors for the card: its first call
    runs eagerly, its capture runs the step once (what a capture does to
    the wrappers' counters), and a replay runs nothing."""

    def _device(self, state):
        return torch.device("cpu") if any(
            isinstance(x, torch.Tensor) for x in state) else None

    def _eager_on_side_stream(self, device, args):
        return self.fn(*args)

    def _capture(self, device, run):
        return _StubGraph(), run()


def _counting_step(calls):
    """A step that counts like the wrappers: two flash_fwd, one dq and one
    dkv launch, and one depthwise launch a call; it writes its state in
    place and returns a small and a large output."""
    def step(state, batch):
        x = torch.as_tensor(batch["x"])
        calls.append(x.clone())
        flash_attention.launches["flash_fwd"] += 2
        flash_backward.launches["flash_bwd_dq"] += 1
        flash_backward.launches["flash_bwd_dkv"] += 1
        depthwise_conv.launches["depthwise_conv"] += 1
        state["w"].add_(x.sum())
        small = state["w"].sum()[None]
        big = torch.zeros(tsteps.COPY_OUT_MAX + 1)
        return {"w": state["w"]}, {"small": small, "big": big}
    return step


def _counts():
    return (flash_attention.all_launches()["flash_fwd"],
            flash_attention.all_launches()["flash_bwd_dq"],
            flash_attention.all_launches()["flash_bwd_dkv"],
            depthwise_conv.launches["depthwise_conv"])


@pytest.fixture
def zeroed():
    flash_attention.reset_launches()
    depthwise_conv.launches["depthwise_conv"] = 0
    yield
    flash_attention.reset_launches()
    depthwise_conv.launches["depthwise_conv"] = 0


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_launch_counts_after_n_calls_equal_n_eager_calls(zeroed, n):
    calls = []
    step = _StubStep(_counting_step(calls), "stub", state_argnums=(0,))
    state = {"w": torch.zeros(4)}
    kinds = []
    for i in range(n):
        assert step.compiles(state, {"x": np.ones(3, np.float32)}) == (i < 2)
        step(state, {"x": np.full(3, i, np.float32)})
        kinds.append(step.last_call)
    assert kinds == ["warmup", "capture", "replay", "replay", "replay",
                     "replay", "replay"][:n]
    assert _counts() == (2 * n, n, n, n)
    # the step ran in the first call and in the capture, never in a replay
    assert len(calls) == min(n, 2)
    assert step.captures == (1 if n >= 2 else 0)
    assert step.replays == max(n - 1, 0)


def test_recapture_does_not_count_twice(zeroed):
    calls = []
    step = _StubStep(_counting_step(calls), "stub", state_argnums=(0,))
    state = {"w": torch.zeros(4)}
    x = {"x": np.ones(3, np.float32)}
    for _ in range(3):
        step(state, x)
    moved = {"w": state["w"].clone()}  # new storage: the graph is stale
    assert step.compiles(moved, x)
    step(moved, x)
    assert step.last_call == "capture" and step.captures == 2
    step(moved, x)
    assert step.last_call == "replay"
    assert _counts() == (10, 5, 5, 5)
    # a new shape is a new signature: an eager first call, then a capture
    step(moved, {"x": np.ones(5, np.float32)})
    assert step.last_call == "warmup" and _counts() == (12, 6, 6, 6)


def test_replay_copies_inputs_and_small_outputs(zeroed):
    calls = []
    step = _StubStep(_counting_step(calls), "stub", state_argnums=(0,))
    state = {"w": torch.zeros(4)}
    step(state, {"x": np.ones(3, np.float32)})
    new_state, m1 = step(state, {"x": np.full(3, 2, np.float32)})  # capture
    g = next(iter(step._graphs.values()))
    # the capture ran on the static input buffer, filled before it
    assert torch.equal(calls[1], torch.full((3,), 2.))
    assert torch.equal(g.inputs[0], torch.full((3,), 2.))
    new_state2, m2 = step(state, {"x": np.full(3, 5, np.float32)})  # replay
    assert torch.equal(g.inputs[0], torch.full((3,), 5.))
    assert new_state["w"] is state["w"] and new_state2["w"] is state["w"]
    assert m1["small"] is not m2["small"]  # copied out on every replay
    assert m1["big"] is m2["big"]  # the graph's own buffer
    assert g.graph.replays == 2


def test_capture_error_raises_names_the_step_and_restores_counts(zeroed):
    class _Failing(_StubStep):
        def _capture(self, device, run):
            run()
            raise RuntimeError("operation not permitted when stream is capturing")

    step = _Failing(_counting_step([]), "my_step", state_argnums=(0,))
    state = {"w": torch.zeros(4)}
    step(state, {"x": np.ones(3, np.float32)})
    with pytest.raises(RuntimeError, match="my_step"):
        step(state, {"x": np.ones(3, np.float32)})
    assert _counts() == (2, 1, 1, 1)  # the warm-up call's only


def test_session_keeps_capture_quanta_out_of_calibration(monkeypatch):
    """A rung's first quantum (the eager call) and second (the capture) are
    both tagged warmup; the third, a replay, is the first steady one."""
    monkeypatch.setattr(tsteps, "CompiledStep", _StubStep)
    rung = Rung(name="static", attn_impl="naive")
    sess = TrainSession(TINY, [rung], optimizer=topt.sgd(), lr=1e-2,
                        batch_fn=make_batch_fn(TINY, 2, 8, seed=0),
                        adaptive=False, verbose=False, device="cpu")
    res = sess.run(4)
    assert [s.warmup for s in res.timeline.steps] == [True, True, False, False]
    assert isinstance(rung.jitted_step(TINY, topt.sgd(), lr=1e-2, device="cpu"),
                      _StubStep)


# ---------------------------------------------------------------------------
# the repaired capture blockers against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,theta", [(64, 500000.0), (16, 10000.0), (128, 1e6)])
def test_rope_matches_jax(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(tcommon.rope_freqs(hd, theta).numpy(),
                               np.asarray(jcommon.rope_freqs(hd, theta)), **F32)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_adam_four_steps_match_jax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    jo, to = jopt.adam(weight_decay=0.01), topt.adam(weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    t_obj = ts["t"]
    for g in grads:
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 3e-4)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                           tp, 3e-4)
        tp = topt.apply_updates(tp, tu)
    assert ts["t"] is t_obj and int(t_obj) == 4 == int(js["t"])
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **F32)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]), **F32)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]), **F32)


def test_capture_collects_no_garbage_during_it(monkeypatch):
    """The garbage collector is off while a capture lasts (a dead cycle
    holding a CUDA graph, collected there, would release its pool and
    invalidate the capture) and back on after it, also when the captured
    step raises. The CUDA graph and its context are stood in for."""
    import contextlib
    import gc
    events = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        events.append(("capture", gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(tsteps.GraphPool, "on", lambda self, device: self)
    step = tsteps.CompiledStep(lambda: None, "stub")
    assert gc.isenabled()
    step._capture(None, lambda: events.append(("run", gc.isenabled())))
    assert events == [("capture", False), ("run", False)] and gc.isenabled()

    def fail():
        raise RuntimeError("a step that cannot be captured")

    with pytest.raises(RuntimeError):
        step._capture(None, fail)
    assert gc.isenabled()
