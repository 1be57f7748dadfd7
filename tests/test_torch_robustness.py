"""Robustness on the port: graceful degradation of the serve engine, the
preemption lifecycle, SLO arbitration and chaos injection, against the JAX
package.

The scenarios of ``tests/test_robustness.py`` from
``test_shed_policy_bounds_queue_with_retry_after`` to
``test_charging_trace_parse_and_rate`` and the two interleaving properties,
each with the reference's assertions, run on the port; where the run is
deterministic (seeded requests, scripted schedules, virtual latencies) the
JAX package runs it too, on the same carried-over parameters and train
state, and the two must agree: served tokens and rejections, migrations and
steps, train losses within 1e-5, the chaos schedule event for event.

Then the decode wrappers' dtype contract: each of the four takes q and the
cache each in f32 or bf16 (the reference's kernels cast both to the dots'
type), and refuses a k/v pair of two dtypes and any other dtype. Here they
run their plain versions, held to the JAX kernels in interpret mode.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.engine import chaos as jchaos
from repro.engine import jobs as jjobs
from repro.engine.rungs import default_rung_ladder as jladder
from repro.engine.runtime import SwanRuntime as JRuntime
from repro.engine.session import TrainSession as JSession
from repro.kernels import flash_attention as jfa
from repro.launch import serve as jserve
from repro.launch.steps import init_train_state as jinit
from repro.launch.train import make_batch_fn as jbatch_fn
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import chaos as tchaos
from repro_torch.engine import jobs as tjobs
from repro_torch.engine.events import ChargingTrace
from repro_torch.engine.jobs import PAUSED, RUNNING, ForegroundAppJob
from repro_torch.engine.rungs import default_rung_ladder
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.engine.session import TrainSession
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_train_state, from_numpy_tree
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves

KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5


def _tiny(name):
    return dict(name=name, family="dense", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=128, tie_embeddings=True,
                source="tests/test_robustness.py")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pkgs():
    """Both packages' engines and train jobs, from the JAX package's own
    initialisations carried across for the port."""
    jserve_cfg, jtrain_cfg = JModelConfig(**_tiny("rb-serve")), \
        JModelConfig(**_tiny("rb-train"))
    jparams = jax_build_model(jserve_cfg, impl="naive").init(KEY)
    jstate = jinit(jax_build_model(jtrain_cfg, impl="naive"), jopt.sgd(), KEY)
    return {
        "jax": types.SimpleNamespace(
            serve=jserve, jobs=jjobs, runtime=JRuntime, ladder=jladder,
            session=JSession, sgd=jopt.sgd, batch_fn=jbatch_fn, kw={},
            serve_cfg=jserve_cfg, train_cfg=jtrain_cfg,
            model=lambda: jax_build_model(jserve_cfg, impl="naive"),
            params=lambda: jparams, state=lambda: None),
        "torch": types.SimpleNamespace(
            serve=tserve, jobs=tjobs, runtime=SwanRuntime,
            ladder=default_rung_ladder, session=TrainSession, sgd=topt.sgd,
            batch_fn=make_batch_fn, kw={"device": "cpu"},
            serve_cfg=ModelConfig(**_tiny("rb-serve")),
            train_cfg=ModelConfig(**_tiny("rb-train")),
            model=lambda: build_model(ModelConfig(**_tiny("rb-serve")),
                                      impl="naive", device="cpu"),
            params=lambda: from_numpy_tree(_np(jparams), device="cpu"),
            state=lambda: from_numpy_train_state(_np(jstate), device="cpu")),
    }


def _engine(pkg, policy="serialize", *, slots=2, max_queue=None,
            num_blocks=10):
    return pkg.serve.ContinuousBatchingEngine(
        pkg.model(), pkg.params(), max_batch=slots, max_seq=32,
        kv_layout="paged", block_size=4, num_blocks=num_blocks,
        admission_policy=policy, max_queue=max_queue)


def _req(pkg, uid, *, n_prompt=5, gen=4, deadline=None):
    rng = np.random.default_rng(uid)
    return pkg.serve.Request(uid=uid, prompt=rng.integers(0, 64, n_prompt)
                             .astype(np.int32), max_new_tokens=gen,
                             deadline_steps=deadline)


def _drain(eng):
    while eng.queue or eng.swapped or any(u is not None for u in eng.slot_uid):
        eng.step()


def _outcome(eng):
    """What an engine served and declined, and its degradation counters."""
    return ({u: (f.tokens, f.reason) for u, f in eng.finished.items()},
            {u: (r.reason, r.retry_after) for u, r in eng.rejected.items()},
            eng.shed_count, eng.timeout_count, eng.decode_steps)


def _both(pkgs, scenario):
    """``scenario(pkg) -> engine`` in both packages: the same outcome.
    Returns the port's engine."""
    got, want = scenario(pkgs["torch"]), scenario(pkgs["jax"])
    assert _outcome(got) == _outcome(want)
    return got


# ---------------------------------------------------------------------------
# serve engine: graceful degradation
# ---------------------------------------------------------------------------


def test_shed_policy_bounds_queue_with_retry_after(pkgs):
    def scenario(pkg):
        eng = _engine(pkg, "shed", max_queue=3)
        eng.accepted = [eng.submit(_req(pkg, i)) for i in range(6)]
        _drain(eng)
        return eng

    eng = _both(pkgs, scenario)
    assert eng.accepted == [True] * 3 + [False] * 3
    assert eng.shed_count == 3
    assert all(r.reason == "shed" and r.retry_after >= 1
               for r in eng.rejected.values())
    assert sorted(eng.finished) == [0, 1, 2]
    assert eng.stats()["shed"] == 3


def test_serialize_policy_never_refuses(pkgs):
    def scenario(pkg):
        eng = _engine(pkg, "serialize")
        assert all(eng.submit(_req(pkg, i)) for i in range(6))
        _drain(eng)
        return eng

    eng = _both(pkgs, scenario)
    assert sorted(eng.finished) == list(range(6))
    assert eng.shed_count == 0 and not eng.rejected


@pytest.mark.parametrize("policy", ["shed", "serialize"])
def test_pool_pressure_shed_vs_serialize(pkgs, policy):
    """9 usable blocks: the resident (5 prompt + 12 budget) reserves 5, the
    hold takes the other 4, and admitting uid 7 (3 more) would over-commit
    the pool while slot 1 sits free — where the two policies diverge."""
    def scenario(pkg):
        eng = _engine(pkg, policy, num_blocks=10)
        eng.submit(_req(pkg, 0, gen=12))
        eng.step()
        eng.held = eng.hold_blocks(100)
        eng.submit(_req(pkg, 7))
        eng.step()
        eng.queued = [r.uid for r in eng.queue]
        eng.release_held()
        _drain(eng)
        return eng

    eng = _both(pkgs, scenario)
    assert eng.held == 4
    if policy == "shed":
        assert 7 in eng.rejected and eng.rejected[7].reason == "shed"
    else:
        assert 7 not in eng.rejected and eng.queued == [7]
        assert 7 in eng.finished  # served once the pressure cleared


def test_hold_blocks_never_starves_residents(pkgs):
    def scenario(pkg):
        eng = _engine(pkg, "shed", num_blocks=10)
        eng.submit(_req(pkg, 0, gen=8))
        eng.step()
        eng.reserved = sum(eng._reserved.values())
        eng.held = eng.hold_blocks(100)
        eng.stats_held = eng.stats()["held_blocks"]
        while any(u is not None for u in eng.slot_uid):
            eng.step()  # decode grows into reserved blocks; must never raise
        return eng

    eng = _both(pkgs, scenario)
    assert eng.held == eng.kv.pool.num_usable - eng.reserved == eng.stats_held
    assert 0 in eng.finished and len(eng.finished[0].tokens) == 8


def test_hold_blocks_under_swap_parks_residents(pkgs):
    """Under the swap policy a hold parks cold residents on the host to
    get its blocks; they come back, bitwise, once the hold is released."""
    def scenario(pkg):
        eng = _engine(pkg, "swap", num_blocks=10)
        for i in range(2):
            eng.submit(_req(pkg, i, gen=8))
        for _ in range(3):
            eng.step()
        eng.held = eng.hold_blocks(8)
        eng.parked = sorted(eng.swapped)
        eng.step()
        eng.release_held()
        _drain(eng)
        return eng

    eng = _both(pkgs, scenario)
    assert eng.held > 0 and eng.parked and eng.swap_ins == eng.swap_outs >= 1
    assert sorted(eng.finished) == [0, 1]


def test_queued_deadline_times_out_waiting_not_resident(pkgs):
    def scenario(pkg):
        eng = _engine(pkg, "serialize", slots=1)
        eng.submit(_req(pkg, 0, gen=6, deadline=50))  # admitted at once
        eng.submit(_req(pkg, 1, gen=4, deadline=2))   # waits behind, expires
        for _ in range(10):
            eng.step()
        return eng

    eng = _both(pkgs, scenario)
    assert 1 in eng.rejected and eng.rejected[1].reason == "timeout"
    assert eng.timeout_count == 1 and eng.stats()["timeouts"] == 1
    assert 0 in eng.finished


def test_drain_sheds_queue_and_finishes_residents(pkgs):
    def scenario(pkg):
        eng = _engine(pkg, "serialize", slots=1)
        for i in range(3):
            eng.submit(_req(pkg, i))
        eng.step()
        eng.drain()
        eng.drain()  # idempotent
        eng.late = eng.submit(_req(pkg, 9))
        while any(u is not None for u in eng.slot_uid):
            eng.step()
        return eng

    eng = _both(pkgs, scenario)
    assert not eng.accepting and not eng.late
    assert {r.reason for r in eng.rejected.values()} == {"draining"}
    assert 0 in eng.finished and 9 in eng.rejected
    assert eng.stats()["accepting"] is False


def test_stats_keys_follow_the_reference(pkgs):
    """``stats()`` carries the reference's keys in its order (the port adds
    its launch counts at the end), so bundles read alike."""
    got = list(_engine(pkgs["torch"]).stats())
    want = list(_engine(pkgs["jax"]).stats())
    assert got[:len(want)] == want and got[len(want):] == ["kernel_launches"]


# ---------------------------------------------------------------------------
# job lifecycle + foreground preemption + SLO arbitration
# ---------------------------------------------------------------------------


def _train_job(pkg, ticks, *, name="train"):
    rungs = pkg.ladder(batch=4, microbatch=1, attn_impl="naive",
                       include_bf16=False)
    for r in rungs:
        r.latency_estimate_s = 0.1 * r.rel_latency
    ses = pkg.session(pkg.train_cfg, rungs, optimizer=pkg.sgd(), lr=0.05,
                      batch_fn=pkg.batch_fn(pkg.train_cfg, 4, 8),
                      latency_fn=pkg.jobs.trace_latency_fn(None),
                      adaptive=False, verbose=False, name=name, **pkg.kw)
    return ses.bind(ticks, state=pkg.state())


def _records(job):
    return ([(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
             for m in job.timeline.migrations],
            [(s.step, s.rung) for s in job.timeline.steps])


def test_foreground_burst_pauses_and_resumes_exactly(pkgs):
    def scenario(pkg):
        train = _train_job(pkg, 12)
        fg = pkg.jobs.ForegroundAppJob(bursts=[(4, 7)])
        return train, pkg.runtime([train, fg]).run(18)

    (train, res), (jtrain, jres) = scenario(pkgs["torch"]), scenario(pkgs["jax"])
    assert _records(train) == _records(jtrain)
    assert res.preemptions == jres.preemptions == 1
    np.testing.assert_allclose(train.result().losses, jtrain.result().losses,
                               rtol=LOSS_RTOL)
    pauses = [m for m in train.timeline.migrations if m.reason == "pause"]
    resumes = [m for m in train.timeline.migrations if m.reason == "resume"]
    assert len(pauses) == 1 and len(resumes) == 1
    assert pauses[0].step == resumes[0].step
    assert [s.step for s in train.timeline.steps] == list(range(12))
    assert train.state == RUNNING


def test_runtime_resumes_paused_jobs_at_horizon(pkgs):
    train = _train_job(pkgs["torch"], 20)
    fg = ForegroundAppJob(bursts=[(2, 50)])  # burst outlives the horizon
    SwanRuntime([train, fg]).run(6)
    assert train.state == RUNNING and train._state is not None


def test_pause_is_idempotent_and_guards_state(pkgs):
    train = _train_job(pkgs["torch"], 4)
    train.prepare()
    train.pause(0)
    assert train.paused and train.state == PAUSED
    train.pause(1)
    assert len([m for m in train.timeline.migrations if m.reason == "pause"]) == 1
    train.resume(2)
    assert train.state == RUNNING
    train.resume(3)
    assert len([m for m in train.timeline.migrations if m.reason == "resume"]) == 1


class _StubJob:
    """Minimal SocJob surface for arbitration unit tests."""

    def __init__(self, name, *, headroom=None, relinquish=1.0, priority=1.0):
        self.name = name
        self.priority = priority
        self._headroom = headroom
        self._relinquish = relinquish
        self.migrations = []
        self.paused = False

    def slo_headroom(self):
        return self._headroom

    def can_downgrade(self):
        return True

    def relinquish_score(self):
        return self._relinquish

    def migrate(self, direction, reason, tick):
        self.migrations.append((direction, reason))
        return None


def _arbitrate(runtime, jobs, proposals):
    rt = runtime.__new__(runtime)
    rt.verbose = False
    rt._arbitrate(0, jobs, [(jobs[i], p) for i, p in proposals])
    return [j.migrations for j in jobs]


@pytest.mark.parametrize("case", ["violator", "blocks_upgrades", "auction",
                                  "headroom"])
def test_slo_arbitration_matches_jax(case):
    def jobs():
        if case == "violator":
            return [_StubJob("serve", headroom=-0.5, relinquish=10.0),
                    _StubJob("train", relinquish=1.0)], []
        if case == "blocks_upgrades":
            return [_StubJob("serve", headroom=-0.1), _StubJob("train")], \
                [(1, "up")]
        if case == "auction":
            return [_StubJob("a", relinquish=5.0),
                    _StubJob("b", relinquish=1.0)], [(1, "down")]
        return [_StubJob("serve", headroom=0.0)], [(0, "up")]

    got = _arbitrate(SwanRuntime, *jobs())
    assert got == _arbitrate(JRuntime, *jobs())
    want = {"violator": [[], [("down", "slo")]],
            "blocks_upgrades": [[], [("down", "slo")]],
            "auction": [[("down", "arbitration")], []],
            "headroom": [[]]}[case]
    assert got == want


# ---------------------------------------------------------------------------
# chaos injector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,horizon", [(3, 64), (4, 64), (0, 40), (7, 17),
                                          (11, 200)])
def test_chaos_random_schedule_matches_jax(seed, horizon):
    got = tchaos.ChaosInjector.random(seed, horizon)
    want = jchaos.ChaosInjector.random(seed, horizon)
    assert [(e.tick, e.kind, e.duration, e.magnitude) for e in got.events] == \
        [(e.tick, e.kind, e.duration, e.magnitude) for e in want.events]
    assert {e.kind for e in got.events} == set(tchaos.KINDS) == set(jchaos.KINDS)
    assert got.events == tchaos.ChaosInjector.random(seed, horizon).events
    for t in range(horizon):
        assert got.latency_multiplier(t) == want.latency_multiplier(t)


def test_chaos_random_schedule_differs_by_seed():
    assert tchaos.ChaosInjector.random(4, 64).events != \
        tchaos.ChaosInjector.random(3, 64).events


def test_chaos_event_validation():
    with pytest.raises(ValueError):
        tchaos.ChaosEvent(tick=0, kind="meteor_strike")
    with pytest.raises(ValueError):
        tchaos.ChaosEvent(tick=0, kind="fg_burst", duration=0)


def test_chaos_latency_multiplier_windows():
    inj = tchaos.ChaosInjector([
        tchaos.ChaosEvent(tick=4, kind="latency_spike", duration=3,
                          magnitude=2.0),
        tchaos.ChaosEvent(tick=5, kind="latency_spike", duration=1,
                          magnitude=3.0)])
    assert inj.latency_multiplier(3) == 1.0
    assert inj.latency_multiplier(4) == 2.0
    assert inj.latency_multiplier(5) == 6.0  # overlapping spikes compound
    assert inj.latency_multiplier(7) == 1.0


def test_chaos_skips_absent_targets_loudly(pkgs):
    """No foreground job and no elastic pool on one card: both faults are
    logged as skipped, none applied."""
    inj = tchaos.ChaosInjector([tchaos.ChaosEvent(tick=0, kind="fg_burst"),
                                tchaos.ChaosEvent(tick=0, kind="device_loss")])
    SwanRuntime([_train_job(pkgs["torch"], 2)], chaos=inj).run(2)
    assert inj.skipped_kinds() == {"fg_burst", "device_loss"}
    assert inj.applied == set()
    assert {e["skipped"] for e in inj.log} == {"no foreground job",
                                               "no elastic pool"}


def test_chaos_schedule_applies_like_jax(pkgs):
    """A scripted schedule of every applicable fault over a train job, a
    paged serve job and a foreground app: pool pressure (hold_blocks), a
    torn checkpoint, a thermal spike, a latency spike and a foreground
    burst apply in both packages alike, device loss is skipped (no elastic
    pool), and the runs agree: migrations, served tokens, steps, losses."""
    def scenario(pkg, chaos_mod):
        from repro.engine.events import ThermalTrace as JThermal
        from repro_torch.engine.events import ThermalTrace as TThermal
        trace = (TThermal if pkg is pkgs["torch"] else JThermal)(
            heat_rate=0.2, cool_rate=0.25, slowdown=3.0)
        inj = chaos_mod.ChaosInjector([
            chaos_mod.ChaosEvent(tick=2, kind="pool_pressure", duration=3,
                                 magnitude=4.0),
            chaos_mod.ChaosEvent(tick=3, kind="ckpt_torn"),
            chaos_mod.ChaosEvent(tick=4, kind="thermal_spike", magnitude=1.2),
            chaos_mod.ChaosEvent(tick=5, kind="latency_spike", duration=2,
                                 magnitude=2.5),
            chaos_mod.ChaosEvent(tick=6, kind="fg_burst", duration=2),
            chaos_mod.ChaosEvent(tick=7, kind="device_loss", magnitude=3.0)])
        train = _train_job(pkg, 12)
        eng = _engine(pkg, "swap", num_blocks=12)
        rungs = [pkg.jobs.ServeRung(name="serve-full", latency_estimate_s=0.1)]
        serve = pkg.jobs.ServeJob(eng, [_req(pkg, i, gen=6) for i in range(6)],
                                  rungs=rungs,
                                  latency_fn=pkg.jobs.trace_latency_fn(trace),
                                  adaptive=False, name="serve")
        fg = pkg.jobs.ForegroundAppJob()
        res = pkg.runtime([train, serve, fg], trace=trace, chaos=inj).run(16)
        return inj, res, train, serve

    tinj, tres, ttrain, tserve_ = scenario(pkgs["torch"], tchaos)
    jinj, jres, jtrain, jserve_ = scenario(pkgs["jax"], jchaos)
    assert tinj.applied == jinj.applied == {
        "pool_pressure", "ckpt_torn", "thermal_spike", "latency_spike",
        "fg_burst"}
    assert tinj.skipped_kinds() == jinj.skipped_kinds() == {"device_loss"}
    strip = lambda log: [{k: v for k, v in e.items() if k != "path"}  # noqa: E731
                         for e in log]
    assert strip(tinj.log) == strip(jinj.log)
    assert _records(ttrain) == _records(jtrain)
    assert tres.preemptions == jres.preemptions == 1
    np.testing.assert_allclose(ttrain.result().losses, jtrain.result().losses,
                               rtol=LOSS_RTOL)
    assert _outcome(tserve_.engine) == _outcome(jserve_.engine)
    pauses = [m.step for m in ttrain.timeline.migrations if m.reason == "pause"]
    resumes = [m.step for m in ttrain.timeline.migrations if m.reason == "resume"]
    assert pauses and pauses == resumes  # resumed at the exact step


def test_charging_trace_parse_and_rate():
    tr = ChargingTrace.parse("4:8:5, 6:10:2")
    assert tr.rate(3) == 0.0
    assert tr.rate(4) == 5.0
    assert tr.rate(7) == 7.0  # overlapping chargers sum
    assert tr.rate(9) == 2.0 and not tr.active(10)
    with pytest.raises(ValueError):
        ChargingTrace.parse("5:5:1")


# ---------------------------------------------------------------------------
# property-style: seeded interleavings of pause/resume/migrate/tick
# ---------------------------------------------------------------------------


def _interleave(pkg, seed, ckpt_cls, directory):
    train = _train_job(pkg, 10_000, name=f"prop-{seed}")
    train.ckpt = ckpt_cls(directory, keep=3)
    train.prepare()
    rng = np.random.default_rng(seed)
    executed = []
    tick = 0
    for _ in range(30):
        op = rng.choice(["tick", "pause", "resume", "down", "up"])
        if op == "tick" and not train.paused:
            report = train.step(tick)
            train.observe(tick, report, 1.0)
            executed.append(train._step_idx)
            train.end_tick(tick)
        elif op == "pause" and not train.paused:
            train.pause(tick)
        elif op == "resume" and train.paused:
            train.resume(tick)
        elif op in ("down", "up") and not train.paused:
            train.migrate(op, "test", tick)
        tick += 1
    if train.paused:
        train.resume(tick)
    return train, executed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaved_lifecycle_keeps_steps_monotonic(pkgs, seed, tmp_path):
    """Any seeded interleaving of tick / pause / resume / migrate leaves the
    step counter monotonic and the checkpoint restorable at the final step;
    the JAX session, given the same interleaving, executes the same steps
    on the same rungs with the same losses."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    train, executed = _interleave(pkgs["torch"], seed, CheckpointManager,
                                  str(tmp_path / "ck"))
    jtrain, jexecuted = _interleave(pkgs["jax"], seed, JManager,
                                    str(tmp_path / "jck"))
    assert executed == jexecuted == list(range(len(executed)))
    assert _records(train) == _records(jtrain)
    np.testing.assert_allclose(train.result().losses, jtrain.result().losses,
                               rtol=LOSS_RTOL)
    assert train._step_idx == len(executed)
    train.ckpt.save(train._step_idx, train._state)
    step, state = train.ckpt.restore_latest()
    assert step == train._step_idx
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(state["params"]))


def test_interleaving_survives_torn_checkpoint_between_pause_resume(
        pkgs, tmp_path):
    """A torn file appearing after the pause save (a crash mid-write of a
    newer checkpoint) must not derail resume: it falls back to the intact
    pause checkpoint and the step counter is unchanged."""
    train = _train_job(pkgs["torch"], 100)
    train.ckpt = CheckpointManager(str(tmp_path / "ck"), keep=5)
    train.prepare()
    for tick in range(3):
        report = train.step(tick)
        train.observe(tick, report, 1.0)
        train.end_tick(tick)
    train.pause(3)
    pre = train._step_idx
    with open(train.ckpt._path(pre + 1), "wb") as f:
        f.write(b"SWCK\x01\x00garbage")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        train.resume(4)
    assert train._step_idx == pre
    report = train.step(5)
    train.observe(5, report, 1.0)
    train.end_tick(5)
    assert train._step_idx == pre + 1


# ---------------------------------------------------------------------------
# the decode wrappers' dtypes
# ---------------------------------------------------------------------------

PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
WRAPPERS = ["flash_decode", "flash_decode_paged", "flash_decode_spec",
            "flash_decode_spec_paged"]
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _decode_case(name, qdt, kvdt):
    """(port args, JAX args) of one small call of decode wrapper ``name``:
    B 3, K 2, G 2, hd 16, 4 blocks of 4 a row (paged) or Smax 16, lengths
    0, 7 and past the capacity, S 3 for the verify kernels."""
    rng = np.random.default_rng(5)
    B, K, G, hd, S, bs, T = 3, 2, 2, 16, 3, 4, 4
    spec, paged = "spec" in name, name.endswith("paged")
    q = rng.standard_normal((B, K) + ((S,) if spec else ()) + (G, hd),
                            dtype=np.float32)
    if paged:
        NB = B * T + 1
        kv = [rng.standard_normal((NB, bs, K, hd), dtype=np.float32)
              for _ in range(2)]
        table = (rng.permutation(B * T) + 1).reshape(B, T).astype(np.int32)
        extra = [table]
    else:
        kv = [rng.standard_normal((B, bs * T, K, hd), dtype=np.float32)
              for _ in range(2)]
        extra = []
    lengths = np.array([0, 7, 99 if not spec else 13], np.int32)
    t_args = [torch.from_numpy(q).to(qdt)] + \
        [torch.from_numpy(a).to(kvdt) for a in kv] + \
        [torch.from_numpy(a) for a in extra + [lengths]]
    # the same values, rounded as the port's inputs are
    j_args = [jnp.asarray(t_args[0].float().numpy(), _JDT[qdt])] + \
        [jnp.asarray(a.float().numpy(), _JDT[kvdt]) for a in t_args[1:3]] + \
        [jnp.asarray(a) for a in extra + [lengths]]
    return t_args, j_args


@pytest.mark.parametrize("qdt,kvdt", PAIRS,
                         ids=["f32-f32", "bf16-bf16", "f32q-bf16kv", "bf16q-f32kv"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_decode_wrappers_take_a_cache_dtype_of_their_own(name, qdt, kvdt):
    """The plain path with q and the cache each in f32 or bf16, against the
    JAX kernel (interpret mode) on the same values: the output is in q's
    dtype and within 2e-5 (f32 q) or one bf16 rounding (bf16 q)."""
    t_args, j_args = _decode_case(name, qdt, kvdt)
    got = getattr(tfa, name)(*t_args)
    want = np.asarray(getattr(jfa, name)(*j_args, interpret=True)
                      .astype(jnp.float32))
    assert got.dtype == qdt
    tol = dict(rtol=2e-5, atol=2e-5) if qdt == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("name", WRAPPERS)
def test_decode_wrappers_refuse_mixed_kv_and_other_dtypes(name):
    t_args, _ = _decode_case(name, torch.float32, torch.bfloat16)
    fn = getattr(tfa, name)
    mixed = list(t_args)
    mixed[2] = mixed[2].float()  # v in f32 beside a bf16 k
    with pytest.raises(TypeError, match="k and v share one dtype"):
        fn(*mixed)
    for i in (0, 1):  # an f16 q, or an f16 cache
        other = list(t_args)
        other[i] = other[i].half()
        if i == 1:
            other[2] = other[2].half()
        with pytest.raises(TypeError, match="f32 or bf16"):
            fn(*other)
