"""Planner ladders onto the port's rungs, the measured rung profiler on the
CPU, and the energy budget under the port's SwanRuntime, against the JAX
package.

- ``Rung.from_mesh_choice``, ``rungs_from_ladder`` and ``SwanPlan.rung_ladder``
  on ``tests/test_engine.py``'s MeshChoice ladder, both packages with
  ``mesh_shape=None`` (the port runs on one card): every Rung field equal.
- ``Rung.rung_fields()`` round-trips a rung, so a ladder of the Rungs that
  ``profile_rung`` measured maps back onto the same rungs.
- A planned session in ``latency_fn`` mode (``tests/test_torch_engine.py``'s
  tiny config, a burst): migration records identical to JAX's, losses within
  that file's f32 tolerance (1e-4 relative; every rung here is f32).
- ``profile_rung`` on the CPU is work-conserving: the state after profiling
  k steps equals, exactly, the state after k session steps on that rung.
- ``SwanRuntime`` with the port's ``EnergyLoan`` walks down and holds as the
  reference's does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import planner as jplanner
from repro.core.choices import MeshChoice as JMeshChoice
from repro.core.cost import ChoiceProfile as JChoiceProfile
from repro.core.cost import ladder as jladder
from repro.core.energy import EnergyLoan as JEnergyLoan
from repro.engine import jobs as jjobs
from repro.engine.events import InterferenceTrace as JTrace
from repro.engine.rungs import Rung as JRung
from repro.engine.rungs import default_rung_ladder as jdefault_ladder
from repro.engine.rungs import rungs_from_ladder as jrungs_from_ladder
from repro.engine.runtime import SwanRuntime as JRuntime
from repro.engine.session import TrainSession as JSession
from repro.launch.steps import init_train_state as jinit
from repro.launch.train import make_batch_fn
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost
from repro_torch.core.choices import MeshChoice
from repro_torch.core.cost import ChoiceProfile
from repro_torch.core.energy import EnergyLoan
from repro_torch.core.planner import ExplorationState, plan_from_profiles
from repro_torch.core.profiler import TIMED_STEPS, profile_rung
from repro_torch.engine import jobs as tjobs
from repro_torch.engine import rungs_from_ladder
from repro_torch.engine.events import InterferenceTrace
from repro_torch.engine.rungs import Rung, default_rung_ladder
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.engine.session import TrainSession
from repro_torch.launch.steps import init_train_state
from repro_torch.models.convert import from_numpy_train_state
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

TINY = dict(name="engine-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            tie_embeddings=True, source="tests/test_engine.py")
# tests/test_engine.py:97-118's ladder
ENGINE_LADDER = [dict(mesh_shape=(16, 16), microbatch=1, attn_impl="pallas",
                      prime_pod=True),
                 dict(mesh_shape=(8, 16), microbatch=4, remat="full",
                      prime_pod=False),
                 dict(mesh_shape=(8, 8), microbatch=16, prime_pod=False)]
# a ladder every field of which the port runs (remat among them, as in
# ENGINE_LADDER), microbatches dividing batch 8
SESSION_LADDER = [dict(mesh_shape=(16, 16), microbatch=1, attn_impl="naive",
                       prime_pod=True),
                  dict(mesh_shape=(8, 16), microbatch=2, attn_impl="naive",
                       remat="full", prime_pod=False),
                  dict(mesh_shape=(8, 8), microbatch=4, attn_impl="naive",
                       remat="dots", prime_pod=False)]


def _profiles(mesh_cls, profile_cls, specs, lats=(0.1, 0.2, 0.3)):
    choices = [mesh_cls(s["mesh_shape"], ("data", "model"),
                        **{k: v for k, v in s.items() if k != "mesh_shape"})
               for s in specs]
    return [profile_cls(choice=c, latency_s=lat, energy_j=1.0, power_w=1.0,
                        cost_key=c.cost_key())
            for c, lat in zip(choices, lats)]


def _fields(rung):
    return {f.name: getattr(rung, f.name) for f in dataclasses.fields(rung)}


# ---------------------------------------------------------------------------
# ladders onto rungs
# ---------------------------------------------------------------------------


def test_rungs_from_ladder_match_jax():
    got = rungs_from_ladder(cost.ladder(_profiles(MeshChoice, ChoiceProfile,
                                                  ENGINE_LADDER)), mesh_shape=None)
    want = jrungs_from_ladder(jladder(_profiles(JMeshChoice, JChoiceProfile,
                                                ENGINE_LADDER)), mesh_shape=None)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert [r.microbatch for r in got] == [1, 4, 16]
    assert got[0].attn_impl == "pallas" and got[1].remat == "full"
    sens = [r.interference_sensitivity for r in got]
    assert sens == sorted(sens, reverse=True) and sens[0] == 1.0
    assert [r.latency_estimate_s for r in got] == [0.1, 0.2, 0.3]
    assert got[1].rel_latency == 2.0


@pytest.mark.parametrize("objective", ["fastest", "efficient"])
def test_swan_plan_rung_ladder_matches_jax(objective):
    got = plan_from_profiles("llama3.2-1b", "h100", _profiles(
        MeshChoice, ChoiceProfile, ENGINE_LADDER), objective=objective)
    want = jplanner.plan_from_profiles("llama3.2-1b", "h100", _profiles(
        JMeshChoice, JChoiceProfile, ENGINE_LADDER), objective=objective)
    assert got.selected.name == want.selected.name
    assert [_fields(r) for r in got.rung_ladder(mesh_shape=None)] == \
        [_fields(r) for r in want.rung_ladder(mesh_shape=None)]


def test_a_mesh_raises_without_the_override():
    choice = MeshChoice((16, 16), ("data", "model"))
    with pytest.raises(NotImplementedError, match="one card"):
        Rung.from_mesh_choice(choice)
    with pytest.raises(NotImplementedError, match="one card"):
        rungs_from_ladder(_profiles(MeshChoice, ChoiceProfile, ENGINE_LADDER[:1]))
    assert JRung.from_mesh_choice(JMeshChoice((16, 16), ("data", "model"))
                                  ).mesh_shape == (16, 16)
    assert Rung.from_mesh_choice(choice, mesh_shape=None).name == choice.name


@pytest.mark.parametrize("rung", default_rung_ladder(batch=4, attn_impl="pallas") + [
    Rung(name="odd", microbatch=2, attn_impl="chunked", param_dtype="float16",
         chunk=256, remat="dots", compression="int8",
         interference_sensitivity=0.3, rel_latency=1.7, latency_estimate_s=0.2)],
    ids=lambda r: r.name)
def test_rung_fields_round_trip(rung):
    again = Rung.from_mesh_choice(rung, name=rung.name,
                                  interference_sensitivity=rung.interference_sensitivity,
                                  rel_latency=rung.rel_latency,
                                  latency_estimate_s=rung.latency_estimate_s)
    assert again == rung and again.signature() == rung.signature()
    assert set(rung.rung_fields()) == set(JMeshChoice((1,), ("data",)).rung_fields()) \
        | {"param_dtype"}


def test_a_measured_ladder_maps_back_onto_its_rungs():
    """The profiles ``profile_rung`` gives carry their Rung as the choice."""
    rungs = default_rung_ladder(batch=4, attn_impl="pallas")
    profiles = [dataclasses.replace(r.profile(position=i, n=3), latency_s=0.1 * (i + 1))
                for i, r in enumerate(rungs)]
    planned = plan_from_profiles("llama3.2-1b", "h100", profiles).rung_ladder()
    assert [r.name for r in planned] == [r.name for r in rungs]
    assert [r.signature() for r in planned] == [r.signature() for r in rungs]
    assert [r.latency_estimate_s for r in planned] == [0.1, 0.2, 0.1 * 3]
    assert all(a is not b for a, b in zip(planned, rungs))


# ---------------------------------------------------------------------------
# a planned session against JAX's
# ---------------------------------------------------------------------------

STEPS, TRACE = 20, "4:12:3.0"


@pytest.fixture(scope="module")
def planned_runs():
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    lats = (0.1, 0.115, 0.135)
    jrungs = jplanner.plan_from_profiles("tiny", "cpu", _profiles(
        JMeshChoice, JChoiceProfile, SESSION_LADDER, lats)).rung_ladder(mesh_shape=None)
    trungs = plan_from_profiles("tiny", "cpu", _profiles(
        MeshChoice, ChoiceProfile, SESSION_LADDER, lats)).rung_ladder(mesh_shape=None)
    jstate = jinit(jax_build_model(jcfg, impl="naive"), jopt.sgd(),
                   jax.random.PRNGKey(0))
    tstate = from_numpy_train_state(jax.tree_util.tree_map(np.asarray, jstate),
                                    device="cpu")
    jtrace, ttrace = JTrace.parse(TRACE), InterferenceTrace.parse(TRACE)
    jres = JSession(jcfg, jrungs, optimizer=jopt.sgd(), lr=0.05,
                    batch_fn=make_batch_fn(jcfg, 8, 32),
                    latency_fn=jjobs.trace_latency_fn(jtrace), trace=jtrace,
                    adaptive=True, upgrade_patience=4,
                    verbose=False).run(STEPS, state=jstate)
    tres = TrainSession(tcfg, trungs, optimizer=topt.sgd(), lr=0.05,
                        batch_fn=make_batch_fn(tcfg, 8, 32),
                        latency_fn=tjobs.trace_latency_fn(ttrace), trace=ttrace,
                        adaptive=True, upgrade_patience=4, verbose=False,
                        device="cpu").run(STEPS, state=tstate)
    return jres, tres


def test_planned_session_migrations_match_jax(planned_runs):
    jres, tres = planned_runs
    mig = [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
           for m in tres.timeline.migrations]
    assert mig == [(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
                   for m in jres.timeline.migrations]
    assert {m[3] for m in mig} == {"interference", "clear"}
    assert [s.rung for s in tres.timeline.steps] == [s.rung for s in jres.timeline.steps]
    assert [s.observed_s for s in tres.timeline.steps] == \
        [s.observed_s for s in jres.timeline.steps]


def test_planned_session_losses_match_jax(planned_runs):
    jres, tres = planned_runs
    assert len(tres.losses) == STEPS
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


# ---------------------------------------------------------------------------
# profile_rung on the CPU
# ---------------------------------------------------------------------------

CPU_BATCH, CPU_SEQ = 4, 32


def _clone(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


@pytest.fixture(scope="module")
def start_state():
    cfg = get_config("llama3.2-1b").reduced()
    model = Rung(name="init", attn_impl="pallas").build_model(cfg, "cpu")
    return cfg, init_train_state(model, topt.adam(), model.generator(0))


@pytest.mark.parametrize("position", [0, 1, 2])
def test_profile_rung_is_work_conserving(start_state, position):
    """k profiled steps from step 5 leave the state k session steps on the
    same rung leave, bit for bit, and report the session's losses."""
    cfg, state = start_state
    batch_fn = make_batch_fn(cfg, CPU_BATCH, CPU_SEQ)
    rung = default_rung_ladder(batch=CPU_BATCH, attn_impl="pallas")[position]
    k, start = TIMED_STEPS, 5
    prof, got = profile_rung(rung, cfg, _clone(state), optimizer=topt.adam(),
                             batch_fn=batch_fn, start=start, lr=1e-3,
                             position=position, n=3, device="cpu")
    want = TrainSession(cfg, [dataclasses.replace(rung)], optimizer=topt.adam(),
                        lr=1e-3, batch_fn=batch_fn, adaptive=False,
                        verbose=False, device="cpu", jit=False
                        ).run(start + k, start=start, state=_clone(state))
    leaves, ref = tree_leaves(got), tree_leaves(want.state)
    assert len(leaves) == len(ref)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves, ref))
    assert int(got["step"]) == k and got["params"]["embed"].dtype == rung.dtype
    assert prof.meta["losses"] == want.losses and prof.meta["steps"] == k
    assert prof.choice is rung and prof.name == rung.name
    assert prof.cost_key == rung.profile(position=position, n=3).cost_key == (3 - position,)
    assert prof.latency_s > 0 and prof.energy_j == prof.latency_s
    assert (prof.power_w, prof.memory_bytes) == (1.0, 0)
    assert prof.meta["power"] == "unmeasured" and prof.meta["timing"] == "perf_counter"
    assert prof.meta["calls"] == ["eager"] * k


def test_exploration_plans_the_default_ladder_on_the_cpu(start_state):
    """Phase 16 of chip_smoke.py in small: one state carried through
    ExplorationState's profiles, the plan, then a session on its rungs."""
    cfg, state = start_state
    batch_fn = make_batch_fn(cfg, CPU_BATCH, CPU_SEQ)
    rungs = default_rung_ladder(batch=CPU_BATCH, attn_impl="pallas")
    carried = {"state": _clone(state), "step": 0}

    def profiler(rung):
        prof, carried["state"] = profile_rung(
            rung, cfg, carried["state"], optimizer=topt.adam(), batch_fn=batch_fn,
            start=carried["step"], lr=1e-3, position=rungs.index(rung),
            n=len(rungs), device="cpu")
        carried["step"] += prof.meta["steps"]
        return prof

    explorer = ExplorationState(rungs, profiler)
    while not explorer.complete:
        explorer.explore_one()
    profiles = explorer.done
    plan = plan_from_profiles(cfg.name, "cpu", profiles)
    assert [p.name for p in plan.ladder] == [p.name for p in cost.ladder(profiles)]
    assert plan.selected is min(profiles, key=lambda p: (p.latency_s, p.cost_key))
    k = TIMED_STEPS
    assert [p.meta["start"] for p in profiles] == [0, k, 2 * k]
    assert int(carried["state"]["step"]) == carried["step"] == 3 * k
    planned = plan.rung_ladder()
    by_name = {r.name: r for r in rungs}
    assert [r.signature() for r in planned] == \
        [by_name[r.name].signature() for r in planned]
    res = TrainSession(cfg, planned, optimizer=topt.adam(), lr=1e-3,
                       batch_fn=batch_fn, verbose=False, device="cpu",
                       trace=InterferenceTrace.parse(f"{3 * k}:{3 * k + 2}:3.0")
                       ).run(3 * k + 2, start=3 * k, state=carried["state"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


# ---------------------------------------------------------------------------
# the energy budget under SwanRuntime
# ---------------------------------------------------------------------------


def _energy_run(pkg, level, ticks=8):
    if pkg == "jax":
        cfg, ladder, session, runtime, loan_cls, opt, fn = (
            JModelConfig(**TINY), jdefault_ladder, JSession, JRuntime, JEnergyLoan,
            jopt.sgd(), jjobs.trace_latency_fn(None))
        kw = {}
    else:
        cfg, ladder, session, runtime, loan_cls, opt, fn = (
            ModelConfig(**TINY), default_rung_ladder, TrainSession, SwanRuntime,
            EnergyLoan, topt.sgd(), tjobs.trace_latency_fn(None))
        kw = {"device": "cpu"}
    rungs = ladder(batch=8, microbatch=1, attn_impl="naive")
    for r in rungs:
        r.latency_estimate_s = 0.1 * r.rel_latency
    job = session(cfg, rungs, optimizer=opt, lr=0.05, batch_fn=make_batch_fn(cfg, 8, 32),
                  latency_fn=fn, adaptive=True, upgrade_patience=2, verbose=False,
                  **kw).bind(ticks)
    loan = loan_cls(battery_j=50.0, daily_charge_j=0.0, daily_usage_j=0.0)
    res = runtime([job], energy=loan, battery_level=level).run(ticks)
    return ([(m.step, m.from_rung, m.to_rung, m.reason, m.kind)
             for m in res.timeline.migrations], loan.loan_j, loan.available(level))


@pytest.mark.parametrize("level", [0.2, 1.0])
def test_runtime_energy_budget_matches_jax(level):
    """A depleted battery walks the job down for energy and holds it there;
    a full one never does: the port's loan and runtime as the reference's."""
    got, want = _energy_run("torch", level), _energy_run("jax", level)
    assert got == want
    energy = [m for m in got[0] if m[3] == "energy"]
    if level < 0.5:
        assert energy and energy[0][2] != "full" and not got[2]
        assert not [m for m in got[0] if m[3] == "clear"]
    else:
        assert not energy and got[2]
