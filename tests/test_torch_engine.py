"""The port's Swan engine (TrainSession under SwanRuntime) and train CLI
against the JAX package's.

The session scenario is ``tests/test_engine.py``'s burst -> downgrade ->
recover run: ``default_rung_ladder(batch=8)`` with planner latency estimates,
the deterministic ``trace_latency_fn`` of the trace ``8:20:3.0``, 34 steps,
both packages from one JAX-initialised state. Migration records must be
identical. Losses must agree to 1e-4 relative while the parameters are f32
(the two sides differ in the order of f32 sums), and to 2e-2 once the ladder
reaches its bf16 rung: from there both round every parameter, activation and
update to bf16 in different places (XLA and PyTorch each choose where a bf16
product is accumulated), a difference of a few bf16 ulps per step.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.engine import jobs as jjobs
from repro.engine.events import InterferenceTrace as JTrace
from repro.engine.rungs import default_rung_ladder as jladder
from repro.engine.session import TrainSession as JSession
from repro.launch.steps import init_train_state as jinit
from repro.launch.train import make_batch_fn
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import jobs as tjobs
from repro_torch.engine.events import InterferenceTrace
from repro_torch.engine.rungs import Rung, default_rung_ladder
from repro_torch.engine.session import TrainSession
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import from_numpy_train_state
from repro_torch.optim import optimizers as topt

TINY = dict(name="engine-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            tie_embeddings=True, source="tests/test_engine.py")
STEPS, TRACE, IMPL = 34, "8:20:3.0", "pallas"


def _ladder(make):
    rungs = make(batch=8, microbatch=1, attn_impl=IMPL)
    for r in rungs:
        r.latency_estimate_s = 0.1 * r.rel_latency
    return rungs


def _migrations(timeline):
    return [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
            for m in timeline.migrations]


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jstate = jinit(jax_build_model(jcfg, impl=IMPL), jopt.sgd(),
                   jax.random.PRNGKey(0))
    tstate = from_numpy_train_state(jax.tree_util.tree_map(np.asarray, jstate),
                                    device="cpu")
    jtrace, ttrace = JTrace.parse(TRACE), InterferenceTrace.parse(TRACE)
    jres = JSession(jcfg, _ladder(jladder), optimizer=jopt.sgd(), lr=0.05,
                    batch_fn=make_batch_fn(jcfg, 8, 32),
                    latency_fn=jjobs.trace_latency_fn(jtrace), trace=jtrace,
                    adaptive=True, upgrade_patience=4,
                    verbose=False).run(STEPS, state=jstate)
    tres = TrainSession(tcfg, _ladder(default_rung_ladder), optimizer=topt.sgd(),
                        lr=0.05, batch_fn=make_batch_fn(tcfg, 8, 32),
                        latency_fn=tjobs.trace_latency_fn(ttrace), trace=ttrace,
                        adaptive=True, upgrade_patience=4, verbose=False,
                        device="cpu").run(STEPS, state=tstate)
    return jres, tres


def test_session_migration_timeline_matches_jax(runs):
    jres, tres = runs
    assert _migrations(tres.timeline) == _migrations(jres.timeline)
    kinds = {m.kind for m in tres.timeline.migrations}
    reasons = {m.reason for m in tres.timeline.migrations}
    assert kinds == {"in-place"} and reasons == {"interference", "clear"}
    assert [s.rung for s in tres.timeline.steps] == [s.rung for s in jres.timeline.steps]
    assert tres.final_rung == jres.final_rung == "full"
    assert int(tres.state["step"]) == STEPS
    assert tres.state["params"]["embed"].dtype == torch.float32


def test_session_losses_match_jax(runs):
    jres, tres = runs
    assert len(tres.losses) == len(jres.losses) == STEPS
    bf16 = [s.step for s in tres.timeline.steps if s.rung == "lean"]
    assert bf16, "the ladder never reached its bf16 rung"
    first = bf16[0]
    np.testing.assert_allclose(tres.losses[:first], jres.losses[:first], rtol=1e-4)
    np.testing.assert_allclose(tres.losses[first:], jres.losses[first:], rtol=2e-2)
    assert tres.losses[-1] < tres.losses[0]


def test_session_summary_matches_jax(runs):
    jres, tres = runs
    js, ts = jres.timeline.summary(), tres.timeline.summary()
    for key in ("n_migrations", "downgrades", "upgrades"):
        assert ts[key] == js[key], key


def test_session_pause_resume_restores_the_exact_step(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg = ModelConfig(**TINY)
    sess = TrainSession(cfg, [Rung(name="static", attn_impl="naive")],
                        optimizer=topt.adam(), lr=1e-3,
                        batch_fn=make_batch_fn(cfg, 2, 16),
                        ckpt=CheckpointManager(str(tmp_path)), adaptive=False,
                        verbose=False, device="cpu")
    sess.bind(4)
    sess.prepare()
    for tick in range(2):
        sess.step(tick)
        sess.end_tick(tick)
    before = {k: v.clone() for k, v in sess._state["params"]["layers"]["attn"].items()}
    sess.pause(2)
    assert sess._state is None and sess.paused
    sess.resume(3)
    assert sess._step_idx == 2 and int(sess._state["step"]) == 2
    for k, v in before.items():
        assert torch.equal(sess._state["params"]["layers"]["attn"][k], v)
    assert [m.kind for m in sess.timeline.migrations] == ["pause", "pause"]


def test_single_card_session_refuses_mesh_features():
    cfg = ModelConfig(**TINY)
    with pytest.raises(NotImplementedError, match="one card"):
        Rung(name="meshed", mesh_shape=(2, 1))
    with pytest.raises(NotImplementedError, match="one card"):
        TrainSession(cfg, [Rung(name="r")], optimizer=topt.sgd(),
                     batch_fn=make_batch_fn(cfg, 2, 16), elastic=object(),
                     device="cpu")
    sess = TrainSession(cfg, [Rung(name="r")], optimizer=topt.sgd(),
                        batch_fn=make_batch_fn(cfg, 2, 16), device="cpu")
    with pytest.raises(NotImplementedError, match="one card"):
        sess.on_device_loss(0, [1])


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def _cli(tmp_path, *extra):
    return ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "64",
            "--attn-impl", "pallas", "--optimizer", "adam", "--lr", "3e-4",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "6",
            "--log-every", "0", *extra]


def test_train_cli_trains_and_resumes(tmp_path):
    from repro_torch.kernels import flash_attention as fa
    fa.reset_launches()
    losses = ttrain.main(_cli(tmp_path, "--steps", "12"))
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    # on the CPU the wrappers run their plain versions and count nothing
    assert all(n == 0 for n in fa.all_launches().values())
    more = ttrain.main(_cli(tmp_path, "--steps", "16", "--resume"))
    assert len(more) == 4 and all(np.isfinite(more))
    assert ttrain.main(_cli(tmp_path, "--steps", "16", "--resume")) == []


def test_train_cli_rejects_both_traces(tmp_path):
    with pytest.raises(SystemExit):
        ttrain.main(_cli(tmp_path, "--steps", "2", "--interference-trace",
                         "1:2:3", "--thermal-trace", "0.5:0.2:3"))


@pytest.mark.parametrize("capability,impl", [((9, 0), "pallas"), ((8, 0), "chunked")])
def test_train_cli_resolves_auto_through_the_device(tmp_path, capsys, monkeypatch,
                                                     capability, impl):
    """``auto`` takes the kernels only on an sm_90 device (torch.cuda's
    answers patched for the check), and the CLI resolves it on the CPU."""
    from repro_torch.kernels.backend import auto_attn_impl
    assert auto_attn_impl(1024, device="cpu") == "chunked"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "current_device", lambda: 0)
        m.setattr(torch.cuda, "get_device_capability", lambda device=None: capability)
        assert auto_attn_impl(1024, device="cuda") == impl
    losses = ttrain.main(_cli(tmp_path, "--steps", "2")[:5] + [
        "--seq", "32", "--attn-impl", "auto", "--steps", "2", "--adaptive",
        "--interference-trace", "0:2:3.0"])
    assert len(losses) == 2
