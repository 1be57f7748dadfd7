"""Training of the moe family on the port against the JAX package: the
train step, the train CLI and checkpoints.

``tests/test_torch_moe_train.py``'s reduced deepseek configs, skewed
routers and decision recorder (its fixtures and helpers, imported):

- ``build_train_step`` with adam at microbatch 1 and 2 for 3 steps on
  deepseek-v3 (MoE, MLA, MTP), from one JAX state;
- the train CLI on deepseek-moe-16b, static and ``--adaptive`` down to its
  bf16 ``lean`` rung (latencies from the trace in both packages), from one
  state saved by the JAX package;
- a moe train state checkpointed by either package restoring in the other.

Every comparison also asserts that the two packages took the same routing
and capacity decisions. Tolerances: 2e-5 in f32; the train step's
parameters at 1e-6 but at a gradient's f32 noise floor, as
``tests/test_torch_train.py``'s docstring says; 5e-2 on the bf16 rung.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.engine import jobs as jjobs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.engine import jobs as tjobs
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_train_state
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves
from test_torch_moe_train import (F32, _flat, _n_moe, _np_tree,  # noqa: F401
                                  arch, assert_same_decisions, recorder)

BF16 = dict(rtol=5e-2, atol=5e-2)


def _batch(cfg, step, batch=4, seq=16):
    return jtrain.make_batch_fn(cfg, batch, seq)(step)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b"], indirect=True)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_build_train_step_matches_jax(arch, recorder, microbatch):
    """Three adam steps (lr 3e-4) of deepseek-v3 (MoE, MLA, MTP) from one
    JAX state, under ``tests/test_torch_train.py``'s rules: losses and
    gradient norms at 2e-5, parameters at 1e-6 but where a gradient lies at
    its tensor's f32 noise floor (found from the port's own gradients, which
    equal JAX's at 2e-5), there 2 x 3 x lr. With microbatch 2 each slice's
    capacity counts that slice's tokens, as the reference's scan does."""
    cfg, jparams, _ = arch
    lr, impl = 3e-4, "pallas"
    jmodel = jax_build_model(cfg, impl=impl)
    jstate = {"params": jparams, "opt": jopt.adam().init(jparams), "err": (),
              "step": jnp.zeros((), jnp.int32)}
    tstate = from_numpy_train_state(_np_tree(jstate), device="cpu")
    jstep = jax.jit(jsteps.build_train_step(jmodel, jopt.adam(), microbatch=microbatch,
                                            lr=lr))
    model = build_model(cfg, impl=impl, device="cpu")
    tstep = tsteps.build_train_step(model, topt.adam(), microbatch=microbatch, lr=lr)
    floor = None
    for i in range(3):
        batch = _batch(cfg, i)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(tstate["params"])]
        it = iter(leaves)
        params = jax.tree_util.tree_map(lambda _: next(it), _flat(tstate["params"]))
        grads = torch.autograd.grad(
            model.loss(_unflat(params), {"tokens": torch.from_numpy(batch["tokens"])}),
            leaves)
        g = {k: v.numpy() for k, v in zip(params, grads)}
        low = {k: _noise_floor(k, v) for k, v in g.items()}
        floor = low if floor is None else {k: floor[k] | low[k] for k in low}
        recorder.take()
        jstate, jm = jstep(jstate, batch)
        jax.block_until_ready(jm)
        tstate, tm = tstep(tstate, batch)
        jdec, tdec = recorder.take()
        assert len(tdec) == len(jdec) == microbatch * _n_moe(cfg)
        assert_same_decisions(jdec, tdec)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **F32,
                                       err_msg=f"step {i} {key}")
    got, want = _flat(tstate["params"]), _flat(_np_tree(jstate["params"]))
    assert got.keys() == want.keys()
    n_floor = 0
    for k in want:
        diff = np.abs(got[k].numpy() - want[k])
        assert (diff[~floor[k]] <= 1e-6).all(), (k, diff[~floor[k]].max())
        assert (diff[floor[k]] <= 2 * 3 * lr).all(), k
        n_floor += int(floor[k].sum())
    assert n_floor < 1e-2 * sum(v.size for v in want.values()), n_floor
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def _noise_floor(key, g):
    """Elements of a gradient below 1e-5 of their tensor's largest, the
    tensor being each expert's own matrix in a stacked expert leaf (L, E,
    ...): experts that few tokens reach have gradients orders below the
    busiest expert's. Exact zeros (an expert no token reached) move neither
    side and are not counted."""
    axes = (-2, -1) if "/experts/" in key else None
    top = np.abs(g).max(axis=axes, keepdims=axes is not None)
    return (np.abs(g) < 1e-5 * top) & (g != 0)


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


TRACE = "1:6:8.0"  # full -> accum at step 1, accum -> lean at step 3


def _deterministic_sessions(monkeypatch):
    """Both CLIs' sessions observe each rung's planner estimate scaled by the
    trace (``trace_latency_fn``) instead of wall time, so that both migrate
    at the same steps."""
    for mod, jobs in ((jtrain, jjobs), (ttrain, tjobs)):
        real = mod.TrainSession

        def make(cfg, rungs, *, _real=real, _jobs=jobs, **kw):
            for r in rungs:
                r.latency_estimate_s = 0.1 * r.rel_latency
            return _real(cfg, rungs, latency_fn=_jobs.trace_latency_fn(kw["trace"]), **kw)

        monkeypatch.setattr(mod, "TrainSession", make)


def _migrations(path):
    import json
    with open(path) as f:
        return [(m["step"], m["from_rung"], m["to_rung"], m["reason"])
                for m in json.load(f)["migrations"]]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b"], indirect=True)
@pytest.mark.parametrize("mode", ["static", "adaptive"])
def test_train_cli_matches_jax(arch, recorder, monkeypatch, tmp_path, mode):
    """Both train CLIs on reduced deepseek-moe-16b (batch 4 x 16, adam lr
    3e-4, pallas, 6 steps), resumed from one JAX state saved at step 0:
    static, and ``--adaptive`` under the burst ``1:6:8.0`` with latencies
    from the trace, down the ladder to ``lean`` (microbatch 4, bf16). The
    same migrations, the same decisions, losses at 2e-5 while f32 and at
    5e-2 on the bf16 rung."""
    cfg, jparams, _ = arch
    JManager(str(tmp_path / "jax")).save(0, {
        "params": jparams, "opt": jopt.adam().init(jparams), "err": (),
        "step": jnp.zeros((), jnp.int32)})
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    argv = ["--arch", cfg.name, "--reduced", "--steps", "6", "--batch", "4", "--seq",
            "16", "--attn-impl", "pallas", "--optimizer", "adam", "--lr", "3e-4",
            "--log-every", "0", "--resume", "--ckpt-every", "100"]
    if mode == "adaptive":
        _deterministic_sessions(monkeypatch)
        argv += ["--adaptive", "--interference-trace", TRACE, "--upgrade-patience", "2"]
    recorder.take()
    jlosses = jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "jax"),
                                  "--timeline-out", str(tmp_path / "jax.json")])
    tlosses = ttrain.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port"),
                                  "--timeline-out", str(tmp_path / "port.json")])
    jdec, tdec = recorder.take()
    assert len(tlosses) == len(jlosses) == 6
    assert_same_decisions(jdec, tdec)
    moves = _migrations(tmp_path / "port.json")
    assert moves == _migrations(tmp_path / "jax.json")
    lean = [s for s, _, to, _ in moves if to == "lean"]
    if mode == "adaptive":
        # a migration recorded at step s takes effect from step s + 1
        (down, _, _, _), (to_lean, _, _, _) = moves
        assert [to for _, _, to, _ in moves] == ["accum", "lean"]
        # one call a microbatch: 1 on full, 2 on accum, 4 on lean
        assert len(tdec) == down + 1 + 2 * (to_lean - down) + 4 * (5 - to_lean)
    else:
        assert moves == [] and len(tdec) == 6
    first = lean[0] + 1 if lean else 6
    np.testing.assert_allclose(tlosses[:first], jlosses[:first], **F32)
    np.testing.assert_allclose(tlosses[first:], jlosses[first:], **BF16)
    assert tlosses[-1] < tlosses[0]


def test_moe_checkpoint_restores_across_packages(arch, tmp_path):
    """A moe train state (the first dense layers, the stacked expert leaves
    (L, E, d, ff), the MTP head; adam's moments) saved by either package
    restores in the other leaf for leaf."""
    cfg, jparams, _ = arch
    jstate = {"params": jparams, "opt": jopt.adam().init(jparams), "err": (),
              "step": jnp.asarray(3, jnp.int32)}
    JManager(str(tmp_path / "jax")).save(3, jstate)
    step, tstate = CheckpointManager(str(tmp_path / "jax")).restore_latest()
    want = _flat(_np_tree(jstate))
    got = _flat(tstate)
    assert step == 3 and got.keys() == want.keys()
    assert tstate["err"] == ()
    for k in (k for k in want if k != "err"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert got["params/layers/moe/experts/w_gate"].shape == (_n_moe(cfg), E, d, ff)
    assert got["opt/m/layers/moe/experts/w_down"].shape == (_n_moe(cfg), E, ff, d)
    assert "params/dense_layers/mlp/w_up" in got
    assert ("params/mtp/proj" in got) == bool(cfg.n_mtp_modules)
    CheckpointManager(str(tmp_path / "port"), level=0).save(3, tstate)
    step, back = JManager(str(tmp_path / "port")).restore_latest()
    back = _flat(back)
    assert step == 3 and back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)
