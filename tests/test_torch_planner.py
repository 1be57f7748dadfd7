"""The port's Swan planner (``repro_torch.core``: energy, choices, the SoC
profiler, planner) against the JAX package's ``repro.core``.

The copied modules are plain Python, the same arithmetic on both sides, so
everything is held to exact equality: the SoC models and workload tables,
every (device, workload)'s choices, throughputs and profiles, exploration,
fleet amortization and planning, the energy loan, the cases of
``tests/test_core.py`` and ``tests/test_system.py`` O1-O4 run on the port,
and the rows that ``benchmarks/{table2_local,table3_interference,
figure2_choices}.py`` compute, each script run once on the JAX modules and
once with the port's modules in their place.
"""
import dataclasses
import importlib

import pytest

import benchmarks.table2_local as table2
from repro.core import choices as jchoices
from repro.core import cost as jcost
from repro.core import energy as JE
from repro.core import planner as jplanner
from repro.core import profiler as jprofiler
from repro_torch.core import cost as tcost
from repro_torch.core import energy as E
from repro_torch.core import planner as tplanner
from repro_torch.core import profiler as tprofiler
from repro_torch.core.choices import (CoreChoice, MeshChoice,
                                      enumerate_core_choices,
                                      enumerate_mesh_choices)
from repro_torch.core.controller import SwanController
from repro_torch.core.cost import ChoiceProfile, pareto_prune, pick_fastest
from repro_torch.core.planner import (explore_soc, fleet_explore,
                                      merge_fleet_profiles, plan_from_profiles)
from repro_torch.core.profiler import (greedy_baseline_profile,
                                       profile_soc_choice, soc_throughput)

DEVICES = sorted(JE.SOC_MODELS)
WORKLOADS = sorted(JE.WORKLOAD_GFLOPS_PER_STEP)
PAIRS = [(d, w) for d in DEVICES for w in WORKLOADS]


def _row(p):
    """Every field of a ChoiceProfile but the choice, which is named."""
    return (p.name, p.latency_s, p.energy_j, p.power_w, p.cost_key,
            p.memory_bytes, p.meta)


# ---------------------------------------------------------------------------
# the copied tables and the analytic profiler
# ---------------------------------------------------------------------------


def test_the_tables_are_the_reference_tables():
    assert sorted(E.SOC_MODELS) == DEVICES
    assert E.WORKLOAD_MEM_INTENSITY == JE.WORKLOAD_MEM_INTENSITY
    assert E.WORKLOAD_GFLOPS_PER_STEP == JE.WORKLOAD_GFLOPS_PER_STEP
    assert not hasattr(E, "tpu_power")  # the TPU half is not copied


@pytest.mark.parametrize("device", DEVICES)
def test_soc_model_matches_jax(device):
    got, want = E.SOC_MODELS[device], JE.SOC_MODELS[device]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.core_ids == want.core_ids and got.classes() == want.classes()


@pytest.mark.parametrize("device,workload", PAIRS)
def test_choices_and_profiles_match_jax(device, workload):
    tm, jm = E.SOC_MODELS[device], JE.SOC_MODELS[device]
    got, want = enumerate_core_choices(tm), jchoices.enumerate_core_choices(jm)
    assert [(c.cores, c.soc, c.name) for c in got] == \
        [(c.cores, c.soc, c.name) for c in want]
    mem = E.WORKLOAD_MEM_INTENSITY[workload]
    for tc, jc in zip(got, want):
        assert tc.counts(tm) == jc.counts(jm) and tc.cost_key(tm) == jc.cost_key(jm)
        assert soc_throughput(tc, tm, mem) == jprofiler.soc_throughput(jc, jm, mem)
        for batches in (1, 3):
            assert _row(profile_soc_choice(tc, tm, workload, batches=batches)) == \
                _row(jprofiler.profile_soc_choice(jc, jm, workload, batches=batches))
    assert _row(greedy_baseline_profile(tm, workload)) == \
        _row(jprofiler.greedy_baseline_profile(jm, workload))


@pytest.mark.parametrize("device,workload", PAIRS)
def test_explore_soc_matches_jax(device, workload):
    got, want = explore_soc(device, workload), jplanner.explore_soc(device, workload)
    assert (got.workload, got.device) == (want.workload, want.device)
    assert got.explored_names == want.explored_names
    assert [_row(p) for p in got.profiles] == [_row(p) for p in want.profiles]
    assert [_row(p) for p in got.ladder] == [_row(p) for p in want.ladder]
    assert _row(got.selected) == _row(want.selected)
    assert [p.name for p in got.controller().ladder] == \
        [p.name for p in want.controller().ladder]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("n_devices", [1, 3, 4])
def test_fleet_explore_matches_jax(device, n_devices):
    for workload in WORKLOADS:
        assert fleet_explore(device, workload, n_devices) == \
            jplanner.fleet_explore(device, workload, n_devices)


@pytest.mark.parametrize("device,workload", PAIRS)
def test_merge_fleet_profiles_matches_jax(device, workload):
    """Overlapping shards with a straggler's report: the median survives."""
    def shards(planner, profiler, model, choices):
        profs = [profiler.profile_soc_choice(c, model, workload) for c in choices]
        slow = [profiler.profile_soc_choice(c, model, workload, batches=4)
                for c in choices[1:3]]
        return [profs[:4], profs[2:], slow]

    tm, jm = E.SOC_MODELS[device], JE.SOC_MODELS[device]
    got = merge_fleet_profiles(shards(tplanner, tprofiler, tm,
                                      enumerate_core_choices(tm)))
    want = jplanner.merge_fleet_profiles(shards(jplanner, jprofiler, jm,
                                                jchoices.enumerate_core_choices(jm)))
    assert [_row(p) for p in got] == [_row(p) for p in want]


def _sized(profiles, cost_mod):
    """The profiles with a peak memory that falls with the choice's cost."""
    return [cost_mod.ChoiceProfile(choice=p.choice, latency_s=p.latency_s,
                                   energy_j=p.energy_j, power_w=p.power_w,
                                   cost_key=p.cost_key,
                                   memory_bytes=(sum(p.cost_key) + 1) << 30,
                                   meta=p.meta)
            for p in profiles]


@pytest.mark.parametrize("objective", ["fastest", "efficient"])
@pytest.mark.parametrize("memory_limit", [None, 3 << 30])
@pytest.mark.parametrize("device,workload", [("s10e", "resnet34"),
                                             ("pixel3", "mobilenet-v2"),
                                             ("tab_s6", "shufflenet-v2")])
def test_plan_from_profiles_matches_jax(device, workload, objective, memory_limit):
    got = plan_from_profiles(workload, device,
                             _sized(explore_soc(device, workload).profiles, tcost),
                             objective=objective, memory_limit=memory_limit)
    want = jplanner.plan_from_profiles(
        workload, device, _sized(jplanner.explore_soc(device, workload).profiles, jcost),
        objective=objective, memory_limit=memory_limit)
    assert [_row(p) for p in got.ladder] == [_row(p) for p in want.ladder]
    assert _row(got.selected) == _row(want.selected)
    if memory_limit is not None:
        assert got.selected.memory_bytes <= memory_limit


@pytest.mark.parametrize("idle,discharging", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_exploration_state_gating_matches_jax(idle, discharging):
    """One choice explored per call, only while idle and discharging."""
    def walk(mod, profiler, model, choices):
        seen = []
        state = mod.ExplorationState(choices,
                                     lambda c: profiler.profile_soc_choice(
                                         c, model, "mobilenet-v2"))
        for _ in range(len(choices) + 2):
            prof = state.explore_one(idle=idle, discharging=discharging)
            seen.append((None if prof is None else _row(prof), len(state.pending),
                         len(state.done), state.complete))
        return seen

    tm, jm = E.SOC_MODELS["oneplus8"], JE.SOC_MODELS["oneplus8"]
    got = walk(tplanner, tprofiler, tm, enumerate_core_choices(tm))
    want = walk(jplanner, jprofiler, jm, jchoices.enumerate_core_choices(jm))
    assert got == want
    assert got[-1][3] == (idle and discharging)


@pytest.mark.parametrize("ops", [
    [("available", 0.5), ("borrow", 40.0), ("available", 0.5), ("repay_daily",),
     ("available", 0.6), ("repay", 100.0), ("available", 0.16)],
    [("borrow", 5.0), ("repay", -3.0), ("repay", 2.0), ("available", 0.2),
     ("borrow", 4.0), ("repay_daily",), ("available", 0.2)],
])
def test_energy_loan_matches_jax(ops):
    kw = dict(battery_j=100.0, daily_charge_j=60.0, daily_usage_j=50.0,
              critical_frac=0.2)
    loans = E.EnergyLoan(**kw), JE.EnergyLoan(**kw)
    for op, *args in ops:
        got, want = (getattr(loan, op)(*args) for loan in loans)
        assert got == want and loans[0].loan_j == loans[1].loan_j


# ---------------------------------------------------------------------------
# tests/test_core.py's cases and tests/test_system.py's O1-O4 on the port
# ---------------------------------------------------------------------------


def _prof(name, lat, cost, energy=1.0):
    return ChoiceProfile(choice=type("C", (), {"name": name})(), latency_s=lat,
                         energy_j=energy, power_w=1.0, cost_key=cost)


def test_paper_pixel3_cost_order():
    model = E.SOC_MODELS["pixel3"]
    names = ["4567", "456", "45", "4", "0123", "012", "01", "0"]
    keys = [CoreChoice(tuple(int(c) for c in n), "pixel3").cost_key(model)
            for n in names]
    assert keys == sorted(keys, reverse=True)


def test_cost_rules_prime_and_class():
    model = E.SOC_MODELS["s10e"]
    assert CoreChoice((4, 7), "s10e").cost_key(model) > \
        CoreChoice((4, 5), "s10e").cost_key(model)
    assert CoreChoice((4,), "s10e").cost_key(model) > \
        CoreChoice((0, 1, 2, 3), "s10e").cost_key(model)


def test_pareto_prune_keeps_fastest_and_drops_dominated():
    profs = [_prof("fast_expensive", 1.0, (2,)), _prof("slow_expensive", 2.0, (2,)),
             _prof("slow_cheap", 3.0, (1,)), _prof("slower_cheaper", 4.0, (0,))]
    assert [p.name for p in pareto_prune(profs)] == \
        ["fast_expensive", "slow_cheap", "slower_cheaper"]


def test_shufflenet_ladder_collapses():
    names = [p.name for p in explore_soc("pixel3", "shufflenet-v2").ladder]
    assert "4567" not in names and names[0] == "4"
    assert explore_soc("pixel3", "resnet34").ladder[0].name == "4567"


def test_controller_downgrades_and_recovers():
    ctl = SwanController(explore_soc("s10e", "shufflenet-v2").ladder,
                         upgrade_patience=3)
    start = ctl.active.name
    for _ in range(6):
        ctl.observe_step(ctl.active.latency_s * 2.0)
    assert ctl.idx > 0
    for _ in range(20):
        ctl.observe_step(ctl.active.latency_s)
    assert ctl.active.name == start
    assert {m.reason for m in ctl.migrations} == {"interference", "clear"}


def test_energy_loan_gates_availability():
    loan = E.EnergyLoan(battery_j=100.0, daily_charge_j=60.0, daily_usage_j=50.0,
                        critical_frac=0.2)
    assert loan.available(0.5)
    loan.borrow(40.0)
    assert not loan.available(0.5)
    loan.repay_daily()
    assert loan.loan_j == pytest.approx(30.0)
    assert loan.available(0.6)


def test_fleet_exploration_amortizes():
    assignment = fleet_explore("s10e", "shufflenet-v2", n_devices=4)
    all_names = {c.name for c in enumerate_core_choices(E.SOC_MODELS["s10e"])}
    assert {n for names in assignment.values() for n in names} == all_names
    assert max(len(v) for v in assignment.values()) <= -(-len(all_names) // 4) + 1


def test_merge_fleet_profiles_dedupes_and_orders():
    model = E.SOC_MODELS["pixel3"]
    choices = enumerate_core_choices(model)
    merged = merge_fleet_profiles(
        [[profile_soc_choice(c, model, "resnet34") for c in choices[:4]],
         [profile_soc_choice(c, model, "resnet34") for c in choices[2:]]])
    names = [p.name for p in merged]
    assert len(names) == len(set(names))
    assert [p.latency_s for p in merged] == sorted(p.latency_s for p in merged)


def test_mesh_choice_cost_order_matches_jax():
    full = MeshChoice((16, 16), ("data", "model"), prime_pod=True)
    half = MeshChoice((8, 16), ("data", "model"), prime_pod=False)
    small_tp = MeshChoice((16, 8), ("data", "model"), prime_pod=False)
    assert full.cost_key() > half.cost_key() > small_tp.cost_key()
    for kw in (dict(), dict(multi_pod=True), dict(attn_impls=("chunked", "pallas"))):
        got, want = enumerate_mesh_choices(256, **kw), \
            jchoices.enumerate_mesh_choices(256, **kw)
        assert [(c.name, c.cost_key(), c.rung_fields(), c.rules()) for c in got] == \
            [(c.name, c.cost_key(), c.rung_fields(), c.rules()) for c in want]
    assert any(c.n_chips < 256 for c in enumerate_mesh_choices(256))


def test_pick_fastest_respects_memory_limit():
    profs = [ChoiceProfile(choice=_prof("big", 1.0, (2,)).choice, latency_s=1.0,
                           energy_j=1.0, power_w=1.0, cost_key=(2,),
                           memory_bytes=32 << 30),
             ChoiceProfile(choice=_prof("small", 2.0, (1,)).choice, latency_s=2.0,
                           energy_j=1.0, power_w=1.0, cost_key=(1,),
                           memory_bytes=8 << 30)]
    assert pick_fastest(profs, memory_limit=16 << 30).name == "small"


def test_O1_power_energy_inversion():
    m = E.SOC_MODELS["pixel3"]
    little = profile_soc_choice(CoreChoice((0, 1, 2, 3), "pixel3"), m, "resnet34")
    big = profile_soc_choice(CoreChoice((4,), "pixel3"), m, "resnet34")
    assert little.power_w < big.power_w and little.energy_j > big.energy_j


def test_O2_depthwise_scaling_inversion():
    m = E.SOC_MODELS["pixel3"]

    def lat(cores, wl):
        return profile_soc_choice(CoreChoice(cores, "pixel3"), m, wl).latency_s

    assert lat((4,), "shufflenet-v2") < lat((4, 5, 6, 7), "shufflenet-v2")
    assert lat((4, 5, 6, 7), "resnet34") < lat((4,), "resnet34")


@pytest.mark.parametrize("workload,device,target", [
    ("shufflenet-v2", "s10e", 39), ("shufflenet-v2", "oneplus8", 17),
    ("mobilenet-v2", "mi10", 14), ("resnet34", "pixel3", 1.0)])
def test_O3_table2_speedups_in_band(workload, device, target):
    plan = explore_soc(device, workload)
    sp = greedy_baseline_profile(E.SOC_MODELS[device], workload).latency_s \
        / plan.selected.latency_s
    assert 0.7 * target <= sp <= 1.4 * target


# ---------------------------------------------------------------------------
# the paper benchmarks' rows: each script on the JAX modules, then on the port's
# ---------------------------------------------------------------------------

PORT = {"E": E, "explore_soc": explore_soc,
        "greedy_baseline_profile": greedy_baseline_profile,
        "enumerate_core_choices": enumerate_core_choices,
        "profile_soc_choice": profile_soc_choice}


def _bench(name, port):
    """The benchmark module, its module-level planner names bound to the
    port's where ``port`` (the JAX module's otherwise)."""
    mod = importlib.import_module(f"benchmarks.{name}")
    mp = pytest.MonkeyPatch()
    if port:
        for attr, value in PORT.items():
            if hasattr(mod, attr):
                mp.setattr(mod, attr, value)
    return mod, mp


def _rows(name, port):
    mod, mp = _bench(name, port)
    try:
        return mod.run()
    finally:
        mp.undo()


def _untimed(rows):
    """(row name, value) with the host-timed column left out: Figure 2's
    per-choice rows carry a modelled latency there, kept."""
    return [(n, us if n.startswith("fig2/") and not n.endswith("pruned_ladder")
             else None, v) for n, us, v in rows]


@pytest.fixture(scope="module")
def table2_rows():
    return _untimed(_rows("table2_local", False)), _untimed(_rows("table2_local", True))


@pytest.mark.parametrize("workload,device", sorted(table2.PAPER))
def test_table2_rows_match_jax(table2_rows, workload, device):
    want, got = table2_rows
    names = (f"table2/{device}/{workload}/speedup",
             f"table2/{device}/{workload}/energy_eff")
    pick = [r for r in got if r[0] in names]
    assert len(pick) == 2 and pick == [r for r in want if r[0] in names]
    plan = explore_soc(device, workload)
    base = greedy_baseline_profile(E.SOC_MODELS[device], workload)
    jplan = jplanner.explore_soc(device, workload)
    jbase = jprofiler.greedy_baseline_profile(JE.SOC_MODELS[device], workload)
    assert base.latency_s / plan.selected.latency_s == \
        jbase.latency_s / jplan.selected.latency_s
    assert base.energy_j / plan.selected.energy_j == \
        jbase.energy_j / jplan.selected.energy_j


@pytest.mark.parametrize("device", ["tab_s6", "oneplus8", "pixel3", "s10e"])
def test_table3_score_impact_matches_jax(device):
    """O4 on the port: Swan's controller relinquishes the contended cores,
    and the impact and migrations equal the JAX modules'."""
    mod, mp = _bench("table3_interference", False)
    want = mod.score_impact(device)
    mod, mp = _bench("table3_interference", True)
    try:
        got = mod.score_impact(device)
    finally:
        mp.undo()
    assert isinstance(got[2], SwanController)
    assert got[:2] == want[:2] and got[1] >= got[0]
    assert [dataclasses.astuple(m) for m in got[2].migrations] == \
        [dataclasses.astuple(m) for m in want[2].migrations]
    if device == "pixel3":
        assert got[1] > got[0] and len(got[2].migrations) >= 1


def test_figure2_rows_match_jax():
    want, got = _untimed(_rows("figure2_choices", False)), \
        _untimed(_rows("figure2_choices", True))
    assert got == want
    assert len(got) == 2 * (len(enumerate_core_choices(E.SOC_MODELS["pixel3"])) + 1)
    ladders = {n: v for n, _, v in got if n.endswith("pruned_ladder")}
    assert ladders["fig2/pixel3/shufflenet-v2/pruned_ladder"].split(">")[0] == "4"
