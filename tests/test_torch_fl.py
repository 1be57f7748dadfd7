"""The port's federated learning (``repro_torch.fl``) against the JAX
package's ``fl/``.

The numpy modules (traces, selection, the client and the simulator) are
copies, held to the reference exactly: the same seeded inputs give the same
arrays bit for bit and the same round logs field for field. Aggregation runs
over tensors in the port and over JAX arrays in the reference: 1e-6.
The real FedAvg cohort (``fl.real.run_real``, the port's counterpart of
``benchmarks/table4_fl.py``'s ``run_real``) at the reduced ResNet34 from one
JAX initialisation against the same loop written here with JAX's ``fedavg``,
``sgd`` and ``jax.value_and_grad(model.loss)``: 1e-4, as in
``tests/test_torch_cnn.py`` (f32 on both sides; the convs and GroupNorm sum
in another order). Last, the port's cases of every test in
``tests/test_fl.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_MODELS
from repro.fl import aggregation as jagg
from repro.fl import selection as jsel
from repro.fl import simulator as jsim
from repro.fl import traces as jtr
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig
from repro_torch.fl import aggregation as tagg
from repro_torch.fl import selection as tsel
from repro_torch.fl import simulator as tsim
from repro_torch.fl import traces as ttr
from repro_torch.fl.real import run_real
from repro_torch.models.convert import from_numpy_tree

AGG_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


# ---------------------------------------------------------------------------
# traces: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_raw_trace_filters_and_resample_equal(seed):
    outs = []
    for mod in (jtr, ttr):
        ts, lv = mod.generate_raw_trace(np.random.default_rng(seed), days=29)
        tr = mod.resample_trace(ts, lv)
        outs.append((ts, lv, mod.passes_quality_filters(ts), tr.level, tr.state))
    (ts0, lv0, ok0, l0, s0), (ts1, lv1, ok1, l1, s1) = outs
    np.testing.assert_array_equal(ts0, ts1)
    np.testing.assert_array_equal(lv0, lv1)
    assert ok0 == ok1
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(s0, s1)


def _filter_cases():
    day = 1440.0
    dense = np.arange(0.0, 29 * day, 10.0)
    return {
        "dense": dense,
        "short": np.arange(0.0, 10 * day, 10.0),
        "sparse": np.arange(0.0, 29 * day, 20.0 * 60.0),
        "gapped": np.concatenate([dense[dense < 5 * day],
                                  dense[dense > 5 * day + 25 * 60.0]]),
        "degenerate": np.array([0.0]),
    }


@pytest.mark.parametrize("case", sorted(_filter_cases()))
def test_quality_filters_equal(case):
    ts = _filter_cases()[case]
    assert jtr.passes_quality_filters(ts) == ttr.passes_quality_filters(ts)


def test_make_client_traces_equal():
    a = jtr.make_client_traces(2, seed=1, tz_shifts=3)
    b = ttr.make_client_traces(2, seed=1, tz_shifts=3)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.level, y.level)
        np.testing.assert_array_equal(x.state, y.state)
        assert x.start_offset_min == y.start_offset_min
        assert x.at(1234.5) == y.at(1234.5)


@pytest.mark.parametrize("n", [2, 3, 40])
def test_pchip_interpolate_equal(n):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 3.0, n))
    y = rng.standard_normal(n)
    xq = np.linspace(x[0] - 1.0, x[-1] + 1.0, 300)
    np.testing.assert_array_equal(jtr.pchip_interpolate(x, y, xq),
                                  ttr.pchip_interpolate(x, y, xq))


# ---------------------------------------------------------------------------
# selection: the same lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [5, 30])
def test_random_selection_equal(seed, k):
    avail = list(range(3, 33))
    a = jsel.random_selection(np.random.default_rng(seed), avail, k)
    b = tsel.random_selection(np.random.default_rng(seed), avail, k)
    assert [int(c) for c in a] == [int(c) for c in b]


@pytest.mark.parametrize("seed", range(3))
def test_oort_select_equal(seed):
    rng = np.random.default_rng(100 + seed)
    sels = [jsel.OortSelector(), tsel.OortSelector()]
    for c in range(0, 40, 2):  # half the clients explored
        loss, n, lat = rng.uniform(0.1, 3.0), int(rng.integers(10, 400)), \
            rng.uniform(1.0, 20.0)
        for s in sels:
            s.report(c, loss, n, lat)
    picks = [s.select(np.random.default_rng(seed), list(range(40)), 12,
                      deadline_s=10.0) for s in sels]
    assert [int(c) for c in picks[0]] == [int(c) for c in picks[1]]


# ---------------------------------------------------------------------------
# aggregation: 1e-6
# ---------------------------------------------------------------------------


def _trees(seed, n):
    """(global, deltas) as numpy: an f32 matrix, an f32 vector and a bf16
    leaf (drawn in f32, rounded by each package)."""
    rng = np.random.default_rng(seed)

    def one(scale):
        return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
                "blk": {"b": (scale * rng.standard_normal(7)).astype(np.float32),
                        "h": (scale * rng.standard_normal((3, 4))).astype(np.float32)}}

    return one(1.0), [one(0.1) for _ in range(n)]


def _to_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["blk"]["h"] = out["blk"]["h"].astype(jnp.bfloat16)
    return out


def _to_torch(tree):
    out = from_numpy_tree(tree, device="cpu")
    out["blk"]["h"] = out["blk"]["h"].to(torch.bfloat16)
    return out


def _assert_trees_close(got, want, tol=AGG_TOL):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        want_dtype = str(fw[k].dtype)
        assert str(fg[k].dtype).replace("torch.", "") == want_dtype, k
        np.testing.assert_allclose(_np(fg[k]), _np(fw[k]), err_msg=k, **tol)


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 2.0]])
def test_fedavg_matches_jax(weights):
    g, ds = _trees(0, 3)
    want = jagg.fedavg(_to_jax(g), [_to_jax(d) for d in ds], weights)
    got = tagg.fedavg(_to_torch(g), [_to_torch(d) for d in ds], weights)
    _assert_trees_close(got, want)
    assert got["blk"]["h"].dtype == torch.bfloat16


def test_fedprox_grad_matches_jax():
    g, (loc,) = _trees(1, 1)
    want = jagg.fedprox_grad(_to_jax(loc), _to_jax(g), 0.01)
    got = tagg.fedprox_grad(_to_torch(loc), _to_torch(g), 0.01)
    _assert_trees_close(got, want)
    assert all(t.dtype == torch.float32 for t in _flat(got).values())


def test_fedyogi_three_steps_match_jax():
    g, _ = _trees(2, 0)
    jy, ty = jagg.FedYogi(), tagg.FedYogi()
    jp, tp = _to_jax(g), _to_torch(g)
    for step in range(3):
        _, ds = _trees(10 + step, 4)
        w = [1.0, 2.0, 3.0, 4.0] if step == 1 else None
        jp = jy.step(jp, [_to_jax(d) for d in ds], w)
        tp = ty.step(tp, [_to_torch(d) for d in ds], w)
        _assert_trees_close(tp, jp)
        for key in ("m", "v"):
            _assert_trees_close(ty.state[key], jy.state[key])
    assert tp["blk"]["h"].dtype == torch.bfloat16


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 1), (4, 2), (5, 3), (6, 4),
                                    (2, 50), (6, 99)])
def test_fedavg_equal_weights_is_mean(n, seed):
    """``tests/test_property.py``'s property on the port: equal weights give
    the mean of the deltas (and JAX's fedavg of the same deltas)."""
    rng = np.random.default_rng(seed)
    deltas = [rng.standard_normal(8).astype(np.float32) for _ in range(n)]
    out = tagg.fedavg({"w": torch.zeros(8)},
                      [{"w": torch.from_numpy(d)} for d in deltas])
    np.testing.assert_allclose(out["w"].numpy(), np.mean(np.stack(deltas), 0),
                               rtol=1e-5, atol=1e-6)
    want = jagg.fedavg({"w": jnp.zeros((8,))}, [{"w": jnp.asarray(d)} for d in deltas])
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(want["w"]), **AGG_TOL)


# ---------------------------------------------------------------------------
# the simulator: round logs field for field, Table 4's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(workload="resnet34", n_clients=48, rounds=20, clients_per_round=8, seed=11),
    dict(workload="mobilenet-v2", n_clients=48, rounds=12, clients_per_round=8,
         seed=2, selector="oort"),
    dict(workload="shufflenet-v2", n_clients=48, rounds=12, clients_per_round=8,
         seed=4, policy="baseline"),
], ids=["resnet34", "oort", "baseline"])
def test_run_fl_round_logs_equal(kw):
    a = jsim.run_fl(jsim.FLConfig(**kw))
    b = tsim.run_fl(tsim.FLConfig(**kw))
    assert [dataclasses.asdict(r) for r in a.rounds] == \
        [dataclasses.asdict(r) for r in b.rounds]


def _table4_rows(res):
    """``benchmarks/table4_fl.py``'s ``run`` formula: TTA speedup, energy
    efficiency and the online counts of the last 20 rounds."""
    tgt = min(res["baseline"].final_accuracy, res["swan"].final_accuracy)
    tb = res["baseline"].time_to_accuracy(tgt) or float("inf")
    ts = res["swan"].time_to_accuracy(tgt) or float("inf")
    ee = res["baseline"].total_energy_j / max(res["swan"].total_energy_j, 1e-9)
    online_b = np.mean([r.online for r in res["baseline"].rounds[-20:]])
    online_s = np.mean([r.online for r in res["swan"].rounds[-20:]])
    return tb / ts, ee, online_s, online_b


def test_compare_policies_gives_table4_rows_equal():
    kw = dict(rounds=60, n_clients=96, clients_per_round=16, seed=3)
    a = jsim.compare_policies("shufflenet-v2", **kw)
    b = tsim.compare_policies("shufflenet-v2", **kw)
    assert _table4_rows(a) == _table4_rows(b)
    for p in ("baseline", "swan"):
        assert [dataclasses.asdict(r) for r in a[p].rounds] == \
            [dataclasses.asdict(r) for r in b[p].rounds]


# ---------------------------------------------------------------------------
# the real FedAvg cohort
# ---------------------------------------------------------------------------


def _resnet():
    jcfg = PAPER_MODELS["resnet34"].reduced()
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _jax_run_real(jcfg, params, *, n_clients, rounds, local_steps, batch, lr):
    """``table4_fl.run_real``'s loop at the given sizes, returning each
    round's mean client loss and the final parameters."""
    from repro.data.pipeline import synthetic_cnn_batch
    model = jax_build_model(jcfg)
    opt = jopt.sgd()

    @jax.jit
    def local_update(p, b):
        loss, g = jax.value_and_grad(model.loss)(p, b)
        upd, _ = opt.update(g, (), p, lr)
        return jopt.apply_updates(p, upd), loss

    out = []
    for rnd in range(rounds):
        deltas, losses = [], []
        for c in range(n_clients):
            rng = np.random.default_rng([rnd, c])
            local = params
            for _ in range(local_steps):
                b = synthetic_cnn_batch(rng, batch, jcfg.image_size,
                                        jcfg.in_channels, jcfg.n_classes)
                local, loss = local_update(local, b)
            losses.append(float(loss))
            deltas.append(jax.tree_util.tree_map(lambda a, b: a - b, local, params))
        params = jagg.fedavg(params, deltas)
        out.append(float(np.mean(losses)))
    return out, params


def test_run_real_matches_the_jax_loop():
    jcfg, cfg = _resnet()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    sizes = dict(n_clients=2, rounds=2, local_steps=2, batch=16, lr=0.05)
    want_losses, want_params = _jax_run_real(jcfg, jparams, **sizes)
    seen = []
    res = run_real(cfg, device="cpu",
                   params=from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                                          device="cpu"),
                   on_aggregate=lambda rnd, g, ds, new: seen.append((rnd, len(ds))),
                   **sizes)
    np.testing.assert_allclose(res.losses, want_losses, **TOL)
    got, want = _flat(res.params), _flat(want_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **TOL)
    assert seen == [(0, 2), (1, 2)]
    assert res.captures == 0  # eager on the CPU
    assert len(res.step_s) == 2 * 2 * 2 and len(res.agg_s) == 2


def test_run_real_meets_the_reference_check():
    """The reference's own check at its settings (8 clients x 6 rounds x 4
    local steps, batch 16, sgd lr 0.05, the reduced ResNet34): the last
    round's mean loss is below the first's. The port's own initialisation."""
    _, cfg = _resnet()
    res = run_real(cfg, device="cpu")
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0], res.losses


def test_run_real_on_cuda_without_a_card_raises(monkeypatch):
    _, cfg = _resnet()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_real(cfg, n_clients=1, rounds=1, local_steps=1)


# ---------------------------------------------------------------------------
# the port's cases of tests/test_fl.py
# ---------------------------------------------------------------------------


def test_generated_traces_pass_paper_filters():
    rng = np.random.default_rng(7)
    for _ in range(5):
        ts, lv = ttr.generate_raw_trace(rng, days=29)
        assert ttr.passes_quality_filters(ts)
        tr = ttr.resample_trace(ts, lv)
        assert tr.days >= 28
        assert set(np.unique(tr.state)).issubset({-1, 0, 1})
        assert 0.0 <= tr.level.min() and tr.level.max() <= 1.0


def test_timezone_augmentation_counts():
    traces = ttr.make_client_traces(2, seed=1, tz_shifts=24)
    assert len(traces) == 48
    assert len({t.start_offset_min for t in traces}) == 24


def test_oort_prefers_high_utility():
    sel = tsel.OortSelector(epsilon=0.0)
    rng = np.random.default_rng(0)
    for c in range(10):
        sel.report(c, loss=2.0 if c < 5 else 0.1, n_samples=100, latency_s=1.0)
    chosen = sel.select(rng, list(range(10)), 5, deadline_s=10.0)
    assert set(chosen) == {0, 1, 2, 3, 4}


def test_fl_swan_beats_baseline():
    res = tsim.compare_policies("shufflenet-v2", rounds=60, n_clients=96,
                                clients_per_round=16, seed=3)
    tgt = min(res["baseline"].final_accuracy, res["swan"].final_accuracy)
    tb = res["baseline"].time_to_accuracy(tgt)
    ts = res["swan"].time_to_accuracy(tgt)
    assert ts is not None and tb is not None and ts <= tb
    assert res["swan"].total_energy_j < res["baseline"].total_energy_j


def test_fl_sim_determinism():
    cfg = tsim.FLConfig(workload="resnet34", n_clients=48, rounds=20,
                        clients_per_round=8, seed=11)
    a, b = tsim.run_fl(cfg), tsim.run_fl(cfg)
    assert [r.accuracy for r in a.rounds] == [r.accuracy for r in b.rounds]


def test_make_client_traces_rejects_impossible_days_min():
    with pytest.raises(ValueError, match="days_min"):
        ttr.make_client_traces(1, seed=0, days=5, tz_shifts=1,
                               max_attempts_per_trace=3)


def test_pchip_monotone_and_shape_preserving():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.uniform(0.5, 3.0, 40))
    y = np.cumsum(rng.uniform(0.0, 1.0, 40))
    xq = np.linspace(x[0], x[-1] - 1e-9, 500)
    yq = ttr.pchip_interpolate(x, y, xq)
    assert np.all(np.diff(yq) >= -1e-9)
    assert yq.min() >= y.min() - 1e-9 and yq.max() <= y.max() + 1e-9
    np.testing.assert_allclose(ttr.pchip_interpolate(x, y, x[1:-1]), y[1:-1],
                               atol=1e-9)


def test_quality_filter_rejections():
    cases = _filter_cases()
    assert ttr.passes_quality_filters(cases["dense"])
    for name in ("short", "sparse", "gapped", "degenerate"):
        assert not ttr.passes_quality_filters(cases[name]), name
