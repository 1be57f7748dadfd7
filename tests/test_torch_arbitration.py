"""Serving co-scheduled with training under one arbiter: the port against
the JAX package.

The co-tenancy scenarios of ``tests/test_arbitration.py`` (from
``test_thermal_pressure_downgrades_serve_first_when_more_sensitive`` to
``test_energy_budget_blocks_upgrades``) run through both packages on the
same carried-over parameters (``models/convert.py``) and train state, with
``trace_latency_fn`` latencies so that every run is deterministic: the
migrations (step, job, from, to, reason, kind) must be equal, the served
tokens equal, the train losses within 1e-5 (2e-2 from the first step on
the bf16 ``lean`` rung on, as in ``tests/test_torch_engine.py``: bf16 sums in
another order), and each scenario's own
assertions hold on the port. One case walks ``serve-lean`` with a bf16 KV
cache on ``impl="naive"``, where the streams must equal the JAX engine's
but where the plain path's top-2 logit margin is below 1e-3; one runs the
port's ``launch.mixed.main`` on the CPU with the arguments and assertions of
``test_mixed_cli_cotenancy_under_thermal_trace``.

Not here: device loss mid-co-tenancy (``test_device_loss_mid_cotenancy_
train_remeshes_serve_streams``) needs the elastic remesh over a device
mesh, which the single-card port does not have yet; the MLA prefill
fallback and the asymmetric-head refusal are model and kernel checks, not
co-tenancy ones; the two controller regressions run on ``core.controller``,
which ``tests/test_torch_engine.py`` already holds to the reference.
"""
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.energy import EnergyLoan as JEnergyLoan
from repro.engine import events as jevents
from repro.engine import jobs as jjobs
from repro.engine.runtime import SwanRuntime as JRuntime
from repro.engine.rungs import default_rung_ladder as jladder
from repro.engine.session import TrainSession as JSession
from repro.launch import serve as jserve
from repro.launch.steps import init_train_state as jinit
from repro.launch.train import make_batch_fn as jbatch_fn
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy import EnergyLoan
from repro_torch.engine import events as tevents
from repro_torch.engine import jobs as tjobs
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.engine.rungs import default_rung_ladder
from repro_torch.engine.session import TrainSession
from repro_torch.engine.timeline import Timeline
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_train_state, from_numpy_tree
from repro_torch.optim import optimizers as topt

TINY = dict(name="arb-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            tie_embeddings=True, source="tests/test_arbitration.py")
KEY = jax.random.PRNGKey(0)
LOSS_RTOL = 1e-5       # train losses on the f32 rungs
BF16_LOSS_RTOL = 2e-2  # ... and from the first step on the bf16 rung on
LOGIT_TOL = 1e-3


@pytest.fixture(scope="module")
def pkgs():
    """Both packages' surfaces, each with the same starting parameters: the
    JAX package's own initialisations, carried across for the port."""
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jparams = jax_build_model(jcfg, impl="naive").init(KEY)
    jstate = jinit(jax_build_model(jcfg, impl="naive"), jopt.sgd(), KEY)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jax_pkg = types.SimpleNamespace(
        name="jax", cfg=jcfg, events=jevents, jobs=jjobs, runtime=JRuntime,
        ladder=jladder, session=JSession, serve=jserve, loan=JEnergyLoan,
        sgd=jopt.sgd, batch_fn=jbatch_fn, kw={},
        build=lambda impl: jax_build_model(jcfg, impl=impl),
        params=lambda: jparams, state=lambda: None)
    torch_pkg = types.SimpleNamespace(
        name="torch", cfg=tcfg, events=tevents, jobs=tjobs,
        runtime=SwanRuntime, ladder=default_rung_ladder, session=TrainSession,
        serve=tserve, loan=EnergyLoan, sgd=topt.sgd, batch_fn=make_batch_fn,
        kw={"device": "cpu"},
        build=lambda impl: build_model(tcfg, impl=impl, device="cpu"),
        params=lambda: from_numpy_tree(as_np(jparams), device="cpu"),
        state=lambda: from_numpy_train_state(as_np(jstate), device="cpu"))
    return {"jax": jax_pkg, "torch": torch_pkg}


# ---------------------------------------------------------------------------
# the scenarios' jobs, built in either package
# ---------------------------------------------------------------------------


def _thermal(pkg, heat=0.4):
    return pkg.events.ThermalTrace(heat_rate=heat, cool_rate=0.3,
                                   slowdown=4.0, trigger_temp=1.0,
                                   release_temp=0.4)


def _train_job(pkg, trace, ticks, *, sens=None, rel=None, name="train",
               priority=1.0, patience=4):
    rungs = pkg.ladder(batch=8, microbatch=1, attn_impl="naive")
    if sens is not None:
        rungs = rungs[:len(sens)]
        for r, s in zip(rungs, sens):
            r.interference_sensitivity = s
    if rel is not None:
        for r, rl in zip(rungs, rel):
            r.rel_latency = rl
    for r in rungs:
        r.latency_estimate_s = 0.1 * r.rel_latency
    ses = pkg.session(pkg.cfg, rungs, optimizer=pkg.sgd(), lr=0.05,
                      batch_fn=pkg.batch_fn(pkg.cfg, 8, 32),
                      latency_fn=pkg.jobs.trace_latency_fn(trace),
                      adaptive=True, upgrade_patience=patience, verbose=False,
                      name=name, priority=priority, **pkg.kw)
    return ses.bind(ticks, state=pkg.state())


def _serve_rungs(pkg, slots, *, sens=(1.0, 0.4), rel=(1.0, 1.5),
                 kv_dtype=None):
    names = ("serve-full", "serve-capped", "serve-lean")
    caps = (None, max(1, slots // 2), 1)
    return [pkg.jobs.ServeRung(name=names[i], slot_cap=caps[i],
                               interference_sensitivity=s, rel_latency=r,
                               latency_estimate_s=0.1 * r,
                               kv_dtype=kv_dtype if i == len(sens) - 1 else None)
            for i, (s, r) in enumerate(zip(sens, rel))]


def _requests(pkg, n_req, gen, seed=7, n_prompt=5):
    rng = np.random.default_rng(seed)
    return [pkg.serve.Request(uid=i,
                              prompt=rng.integers(0, 64, n_prompt).astype(np.int32),
                              max_new_tokens=gen) for i in range(n_req)]


def _engine(pkg, *, slots=2, max_seq=48, impl="naive", **kw):
    return pkg.serve.ContinuousBatchingEngine(pkg.build(impl), pkg.params(),
                                              max_batch=slots, max_seq=max_seq,
                                              **kw)


def _serve_job(pkg, trace, *, slots=2, n_req=8, gen=8, rungs=None,
               name="serve", priority=1.0, patience=4, adaptive=True,
               impl="naive"):
    return pkg.jobs.ServeJob(_engine(pkg, slots=slots, impl=impl),
                             _requests(pkg, n_req, gen),
                             rungs=rungs or _serve_rungs(pkg, slots),
                             latency_fn=pkg.jobs.trace_latency_fn(trace),
                             adaptive=adaptive, upgrade_patience=patience,
                             name=name, priority=priority)


def _migrations(res):
    return [(m.step, m.job, m.from_rung, m.to_rung, m.reason, m.kind)
            for m in res.timeline.migrations]


def _served(job):
    return {u: (f.tokens, f.reason) for u, f in job.result().items()}


def _same_runs(got, want):
    """The port's run (res, jobs) holds the reference's: equal migrations,
    equal served tokens, train losses within LOSS_RTOL."""
    (tres, tjobs_), (jres, jjobs_) = got, want
    assert _migrations(tres) == _migrations(jres)
    assert tres.ticks == jres.ticks
    for name, jjob in jjobs_.items():
        tjob = tjobs_[name]
        if hasattr(jjob, "engine"):
            assert _served(tjob) == _served(jjob), name
            assert tjob.engine.tokens_out == jjob.engine.tokens_out
        else:
            tl, jl = tjob.result().losses, jjob.result().losses
            assert len(tl) == len(jl)
            # f32 steps to 1e-5; from the first step on the bf16 rung on, the
            # tolerance of tests/test_torch_engine.py's bf16 steps
            rungs = [s.rung for s in tjob.timeline.steps]
            first = next((i for i, r in enumerate(rungs) if r == "lean"),
                         len(tl))
            np.testing.assert_allclose(tl[:first], jl[:first], rtol=LOSS_RTOL)
            np.testing.assert_allclose(tl[first:], jl[first:],
                                       rtol=BF16_LOSS_RTOL)
    assert [(s.job, s.step, s.rung, s.observed_s, s.work)
            for s in tres.timeline.steps] == \
        [(s.job, s.step, s.rung, s.observed_s, s.work)
         for s in jres.timeline.steps]


def _both(pkgs, scenario):
    """``scenario(pkg) -> (RuntimeResult, {name: job})`` in both packages,
    held to each other; returns the port's."""
    got, want = scenario(pkgs["torch"]), scenario(pkgs["jax"])
    _same_runs(got, want)
    return got


# ---------------------------------------------------------------------------
# two-job thermal arbitration: downgrade order follows sensitivity
# ---------------------------------------------------------------------------


def _first_downgrade(pkg, train_sens, serve_sens, ticks=10):
    trace = _thermal(pkg)
    train = _train_job(pkg, trace, ticks, sens=train_sens, rel=(1.0, 1.5))
    serve = _serve_job(pkg, trace, rungs=_serve_rungs(pkg, 2, sens=serve_sens,
                                                      rel=(1.0, 1.5)),
                       n_req=12, gen=12)
    res = pkg.runtime([train, serve], trace=trace).run(ticks)
    return res, {"train": train, "serve": serve}


@pytest.mark.parametrize("train_sens,serve_sens,first", [
    ((1.0, 0.6), (1.0, 0.2), "serve"),
    ((1.0, 0.2), (1.0, 0.6), "train")])
def test_thermal_downgrade_order_matches_jax(pkgs, train_sens, serve_sens,
                                             first):
    res, _ = _both(pkgs, lambda p: _first_downgrade(p, train_sens, serve_sens))
    downs = [m for m in res.timeline.migrations if m.reason != "clear"]
    assert downs, "combined power must trip the shared throttle"
    assert downs[0].job == first


def test_priority_tilt_matches_jax(pkgs):
    def scenario(pkg):
        trace = _thermal(pkg)
        train = _train_job(pkg, trace, 10, sens=(1.0, 0.4), rel=(1.0, 1.5),
                           priority=0.5)
        serve = _serve_job(pkg, trace, rungs=_serve_rungs(
            pkg, 2, sens=(1.0, 0.4), rel=(1.0, 1.5)), n_req=12, gen=12,
            priority=2.0)
        return (pkg.runtime([train, serve], trace=trace).run(10),
                {"train": train, "serve": serve})

    res, _ = _both(pkgs, scenario)
    downs = [m for m in res.timeline.migrations if m.reason != "clear"]
    assert downs and downs[0].job == "train"


@pytest.mark.parametrize("both", [False, True], ids=["alone", "cotenant"])
def test_shared_thermal_sums_power_like_jax(pkgs, both):
    """Alone, the train job's draw never reaches the trigger in 12 ticks;
    with the serve job beside it the summed draw does."""
    def scenario(pkg):
        trace = _thermal(pkg, heat=0.35)
        jobs = {"train": _train_job(pkg, trace, 12)}
        if both:
            jobs["serve"] = _serve_job(pkg, trace, n_req=12, gen=12)
        return pkg.runtime(list(jobs.values()), trace=trace).run(12), jobs

    res, _ = _both(pkgs, scenario)
    assert bool(res.timeline.migrations) == both


def test_merged_timeline_round_trip_matches_jax(pkgs, tmp_path):
    def scenario(pkg):
        trace = _thermal(pkg)
        train = _train_job(pkg, trace, 8)
        serve = _serve_job(pkg, trace, n_req=10, gen=10)
        return (pkg.runtime([train, serve], trace=trace).run(8),
                {"train": train, "serve": serve})

    res, jobs = _both(pkgs, scenario)
    tl = res.timeline
    assert set(tl.jobs()) == {"train", "serve"}
    for name, job in jobs.items():
        view = tl.for_job(name)
        assert len(view.steps) == len(job.timeline.steps)
        assert len(view.migrations) == len(job.timeline.migrations)
        assert [s.step for s in view.steps] == [s.step for s in job.timeline.steps]
    assert len(tl.steps) == sum(len(j.timeline.steps) for j in jobs.values())
    p = str(tmp_path / "merged.json")
    tl.save(p)
    with open(p) as f:
        back = Timeline.from_json(json.load(f))
    assert back.summary() == tl.summary()
    assert set(back.jobs()) == {"train", "serve"}


# ---------------------------------------------------------------------------
# ServeJob: rung migration is bookkeeping, never math
# ---------------------------------------------------------------------------


def _moving_serve(pkg, migrating, *, kv_dtype=None, rungs_sens=(1.0, 0.4),
                  rel=(1.0, 1.5)):
    trace = pkg.events.InterferenceTrace.parse("3:7:4.0") if migrating else None
    job = _serve_job(pkg, trace, slots=2, n_req=6, gen=8,
                     rungs=_serve_rungs(pkg, 2, sens=rungs_sens, rel=rel,
                                        kv_dtype=kv_dtype),
                     adaptive=migrating)
    return pkg.runtime([job], trace=trace).run(200), {"serve": job}


@pytest.mark.parametrize("migrating", [False, True], ids=["fixed", "moved"])
def test_serve_rung_migration_matches_jax(pkgs, migrating):
    res, jobs = _both(pkgs, lambda p: _moving_serve(p, migrating))
    assert bool(res.timeline.migrations) == migrating


def test_serve_rung_migration_keeps_tokens(pkgs):
    """A stream that migrates down (slot cap) and back up emits what a
    fixed-rung engine emits: concurrency rungs change scheduling, not
    math."""
    fixed = _served(_moving_serve(pkgs["torch"], False)[1]["serve"])
    res, jobs = _moving_serve(pkgs["torch"], True)
    assert res.timeline.migrations
    assert _served(jobs["serve"]) == fixed


def _margin(model, params, prompt, tokens, index, dtype):
    """The plain path's top-2 logit margin where it chose ``tokens[index]``,
    replaying the request alone over a ``dtype`` cache."""
    with torch.inference_mode():
        logits, pcache = model.prefill(params, {"tokens": torch.as_tensor(
            prompt)[None]})
        cache = model.init_cache(1, 48, dtype)
        for name in cache:
            cache[name][:, :, :len(prompt)] = pcache[name].to(dtype)
        for i in range(index):
            tok = torch.tensor([[tokens[i]]], dtype=torch.int32)
            logits, cache = model.decode_step(params, cache, tok,
                                              len(prompt) + i)
        top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def test_serve_lean_bf16_kv_walk_matches_jax(pkgs):
    """The bottom rung with a bf16 KV cache, walked down to and back up
    from on the plain path: the same migrations as the JAX engine, and the
    same streams but where the plain path's top-2 margin (over the cache
    dtype the token was chosen on) is below 1e-3."""
    sens, rel = (1.0, 0.4, 0.16), (1.0, 1.5, 2.0)
    tres, tjob = _moving_serve(pkgs["torch"], True, kv_dtype="bfloat16",
                               rungs_sens=sens, rel=rel)
    jres, jjob = _moving_serve(pkgs["jax"], True, kv_dtype="bfloat16",
                               rungs_sens=sens, rel=rel)
    assert _migrations(tres) == _migrations(jres)
    lean = [m for m in tres.timeline.migrations if m.to_rung == "serve-lean"]
    assert lean, "the burst must walk the job onto its bf16-KV rung"
    assert any(m.from_rung == "serve-lean" for m in tres.timeline.migrations)
    got, want = _served(tjob["serve"]), _served(jjob["serve"])
    assert sorted(got) == sorted(want)
    model, params = pkgs["torch"].build("naive"), pkgs["torch"].params()
    reqs = {r.uid: r for r in _requests(pkgs["torch"], 6, 8)}
    for u in want:
        a, b = got[u][0], want[u][0]
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        assert min(_margin(model, params, reqs[u].prompt, b, i, dt)
                   for dt in (torch.float32, torch.bfloat16)) < LOGIT_TOL, u
    # the engine is back on its as-built f32 cache once the burst clears
    assert tjob["serve"].engine.cache["k"].dtype == torch.float32


def test_serve_job_slot_cap_limits_concurrency_like_jax(pkgs):
    def run(pkg):
        engine = _engine(pkg, slots=4, max_seq=32)
        engine.set_slot_cap(2)
        rng = np.random.default_rng(3)
        for i in range(6):
            engine.submit(pkg.serve.Request(
                uid=i, prompt=rng.integers(0, 64, 4).astype(np.int32),
                max_new_tokens=4))
        live = []
        while engine.queue or any(u is not None for u in engine.slot_uid):
            engine.step()
            live.append(sum(1 for u in engine.slot_uid if u is not None))
        return engine, live

    (teng, tlive), (jeng, jlive) = run(pkgs["torch"]), run(pkgs["jax"])
    assert max(tlive) <= 2 and tlive == jlive
    assert sorted(teng.finished) == list(range(6))
    assert {u: f.tokens for u, f in teng.finished.items()} == \
        {u: f.tokens for u, f in jeng.finished.items()}


def _ladder_fields(rungs):
    return [dataclasses.asdict(r) for r in rungs]


@pytest.mark.parametrize("slots,depth", [(8, None), (1, None), (2, None),
                                         (8, 4), (8, 1), (4, 4), (1, 3)])
def test_default_serve_ladder_matches_jax(slots, depth):
    kw = {} if depth is None else {"draft_depth": depth}
    got = tjobs.default_serve_ladder(slots, **kw)
    assert _ladder_fields(got) == _ladder_fields(
        jjobs.default_serve_ladder(slots, **kw))
    assert _ladder_fields(tjobs.default_serve_ladder(
        slots, include_bf16_kv=False, **kw)) == _ladder_fields(
        jjobs.default_serve_ladder(slots, include_bf16_kv=False, **kw))


def test_default_serve_ladder_dedupes_and_orders():
    full = tjobs.default_serve_ladder(8)
    assert [r.slot_cap for r in full] == [None, 4, 2]
    sens = [r.interference_sensitivity for r in full]
    assert sens == sorted(sens, reverse=True) and sens[0] == 1.0
    tiny = tjobs.default_serve_ladder(1)
    assert len(tiny) == 2 and tiny[-1].kv_dtype == "bfloat16"
    rungs = tjobs.default_serve_ladder(8, draft_depth=4)
    assert [r.name for r in rungs] == ["serve-full", "serve-spec-half",
                                       "serve-spec-off", "serve-capped",
                                       "serve-lean"]
    assert [r.draft_depth for r in rungs] == [None, 2, 0, 0, 0]
    assert [r.slot_cap for r in rungs] == [None, None, None, 4, 2]
    assert [r.name for r in tjobs.default_serve_ladder(8, draft_depth=1)] == \
        ["serve-full", "serve-spec-off", "serve-capped", "serve-lean"]


def test_thermal_walks_draft_depth_before_slot_cap_like_jax(pkgs):
    def scenario(pkg):
        trace = _thermal(pkg)
        engine = _engine(pkg, slots=4, max_seq=48, draft_depth=4)
        rungs = pkg.jobs.default_serve_ladder(4, draft_depth=4)
        for r in rungs:
            r.latency_estimate_s = 0.1 * r.rel_latency
        serve = pkg.jobs.ServeJob(engine, _requests(pkg, 16, 20), rungs=rungs,
                                  latency_fn=pkg.jobs.trace_latency_fn(trace),
                                  adaptive=True, upgrade_patience=100,
                                  name="serve")
        return pkg.runtime([serve], trace=trace).run(14), {"serve": serve}

    res, jobs = _both(pkgs, scenario)
    engine = jobs["serve"].engine
    assert engine.spec_rounds > 0, "speculation must run at the full rung"
    downs = [m.to_rung for m in res.timeline.migrations if m.reason != "clear"]
    assert downs and downs[0] == "serve-spec-half"
    if len(downs) > 1:
        assert downs[1] == "serve-spec-off"
    first_cap = next((i for i, n in enumerate(downs)
                      if n in ("serve-capped", "serve-lean")), None)
    if first_cap is not None:
        assert {"serve-spec-half", "serve-spec-off"} <= set(downs[:first_cap])
    assert engine.draft_depth < 4


# ---------------------------------------------------------------------------
# energy budget: low battery forces low-power rungs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0.2, 1.0])
def test_energy_budget_matches_jax(pkgs, level):
    def scenario(pkg):
        train = _train_job(pkg, None, 8)
        loan = pkg.loan(battery_j=50.0, daily_charge_j=0.0, daily_usage_j=0.0)
        return (pkg.runtime([train], energy=loan, battery_level=level).run(8),
                {"train": train})

    res, _ = _both(pkgs, scenario)
    energy = [m for m in res.timeline.migrations if m.reason == "energy"]
    if level < 0.5:
        assert energy and energy[0].to_rung != "full"
    else:
        assert not energy


def test_energy_budget_blocks_upgrades_like_jax(pkgs):
    def scenario(pkg):
        train = _train_job(pkg, None, 12, patience=2)
        loan = pkg.loan(battery_j=20.0, daily_charge_j=0.0, daily_usage_j=0.0)
        return (pkg.runtime([train], energy=loan, battery_level=0.2).run(12),
                {"train": train})

    res, jobs = _both(pkgs, scenario)
    assert not [m for m in res.timeline.migrations if m.reason == "clear"]
    train = jobs["train"]
    assert train.rung.name == train.rungs()[-1].name


# ---------------------------------------------------------------------------
# the warmup rule of a compiled serve step
# ---------------------------------------------------------------------------


def test_serve_job_marks_unreplayed_compiled_steps_warmup(pkgs):
    """A quantum whose compiled decode step ran its eager first call or its
    capture is warmup, as the first quantum on a rung is; a replay (or an
    eager call, as on the CPU) is not. The decode step is stood in for by
    one that reports the call kinds a CompiledStep would."""
    pkg = pkgs["torch"]
    job = _serve_job(pkg, None, n_req=4, gen=8,
                     rungs=[tjobs.ServeRung(name="serve-full",
                                           latency_estimate_s=0.1)],
                     adaptive=False)
    calls = ["replay", "capture", "replay", "replay", "eager", "warmup",
             "capture", "replay"]

    class Reporting:
        def __init__(self, fn):
            self.fn, self.n, self.last_call = fn, 0, None

        def __call__(self, *args):
            self.last_call = calls[self.n]
            self.n += 1
            return self.fn(*args)

    job.engine._decode = Reporting(job.engine._decode)
    job.prepare()
    warm = [job.step(tick).warmup for tick in range(len(calls))]
    assert warm == [True, True, False, False, False, True, True, False]


# ---------------------------------------------------------------------------
# mixed CLI
# ---------------------------------------------------------------------------


def test_mixed_cli_cotenancy_under_thermal_trace(tmp_path):
    from repro_torch.launch import mixed as M
    out = str(tmp_path / "merged.json")
    res = M.main(["--device", "cpu", "--arch", "llama3.2-1b", "--reduced",
                  "--ticks", "12", "--batch", "8", "--seq", "32", "--slots",
                  "2", "--requests", "4", "--prompt-len", "8", "--gen", "6",
                  "--thermal-trace", "0.5:0.3:4.0", "--quiet",
                  "--timeline-out", out])
    with open(out) as f:
        tl = Timeline.from_json(json.load(f))
    assert set(tl.jobs()) == {"train", "serve"}
    assert any(m.reason in ("interference", "arbitration")
               for m in tl.migrations), \
        "the shared thermal trace must force at least one downgrade"
    assert len(res.jobs["train"].result().losses) == 12
    assert res.jobs["serve"].result(), "serve stream must finish requests"
