"""The port's fleet runtime (``repro_torch.fleet``, ``launch/fleet.py``)
against the JAX package's.

The fleet is a numpy simulation in both packages (a client's update is a
``dim``-vector), over each package's engine, planner and checkpoint store,
so the results must be equal exactly: ``FleetResult.to_json()`` and the
CLI's ``--json-out`` payload, with and without fleet chaos, through a
coordinator crash and its resume. Then the port's case of each test in
``tests/test_fleet.py``, and the checkpoint boundary: the port's store
restores CPU tensors where the reference's restores numpy arrays, and the
fleet turns them back into numpy before its arithmetic and crc32 checks.
"""
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro import fleet as jfleet
from repro.engine.chaos import FleetChaos as JChaos
from repro.fl.traces import make_client_traces as jtraces
from repro.launch import fleet as jcli
from repro_torch import fleet as tfleet
from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.engine.chaos import FLEET_KINDS, FleetChaos
from repro_torch.engine.jobs import ForegroundAppJob
from repro_torch.engine.runtime import SwanRuntime
from repro_torch.fl.traces import make_client_traces
from repro_torch.fleet import (CoordinatorCrash, FleetClient, FleetConfig,
                               FleetCoordinator, FLTrainJob,
                               build_fleet_clients, run_client_round)
from repro_torch.launch import fleet as tcli

PROBS = dict(churn_prob=0.1, drop_prob=0.05, dup_prob=0.05, corrupt_prob=0.05)


@pytest.fixture(scope="module")
def traces():
    return make_client_traces(2, seed=3, tz_shifts=24)  # 48 clients


@pytest.fixture(scope="module")
def ref_traces():
    return jtraces(2, seed=3, tz_shifts=24)


@pytest.fixture
def telemetry_off():
    """Both packages' global telemetry off, and restored after the test
    (the CLIs' ``--telemetry-out`` installs an enabled one)."""
    prev = (ref_obs.set_telemetry(ref_obs.Telemetry(enabled=False)),
            obs.set_telemetry(obs.Telemetry(enabled=False)))
    yield
    ref_obs.set_telemetry(prev[0])
    obs.set_telemetry(prev[1])


def _kw(**kw):
    base = dict(n_clients=48, clients_per_round=5, rounds=3, local_steps=8,
                dim=16, seed=3, fg_prob=0.0)
    base.update(kw)
    return base


def _cfg(**kw):
    return FleetConfig(**_kw(**kw))


def _client(traces, cid=0, device="s10e", policy="swan"):
    return FleetClient(cid, device, traces[cid], "shufflenet-v2",
                       policy=policy)


def _run(pkg, trs, d, chaos=None, crash=False, **kw):
    """One package's fleet run (``pkg`` is ``repro.fleet`` or
    ``repro_torch.fleet``); with ``crash`` the coordinator dies and is
    resumed from its durable state."""
    cfg = pkg.FleetConfig(**_kw(**kw))
    clients = pkg.build_fleet_clients(cfg, traces=trs)
    co = pkg.FleetCoordinator(clients, cfg, state_dir=str(d), chaos=chaos)
    if not crash:
        return co.run()
    with pytest.raises(pkg.CoordinatorCrash):
        co.run()
    return pkg.FleetCoordinator.resume(clients, cfg, state_dir=str(d),
                                       chaos=chaos).run()


def _run_fleet(traces, tmp_path, sub, chaos=None, crash=False, **kw):
    """The port's fleet run, as ``tests/test_fleet.py`` runs the reference's."""
    return _run(tfleet, traces, tmp_path / sub, chaos, crash, **kw)


# ---------------------------------------------------------------------------
# equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "chaos_crash"])
def test_fleet_result_json_equals_the_reference(case, traces, ref_traces, tmp_path):
    crash = case == "chaos_crash"
    # foreground bursts pause jobs (the checkpoint path) in both cases
    kw = dict(fg_prob=0.2 if crash else 0.4)
    chaos = dict(seed=5, crash_at=(1, 2), **PROBS) if crash else None
    jch, tch = (None, None) if chaos is None else (JChaos(**chaos), FleetChaos(**chaos))
    want = _run(jfleet, ref_traces, tmp_path / "ref", jch, crash, **kw)
    got = _run(tfleet, traces, tmp_path / "port", tch, crash, **kw)
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())  # key order too
    if not crash:
        assert sum(r.preemptions for r in got.rounds) > 0
    else:
        assert tch.applied == jch.applied and "coordinator_crash" in tch.applied
        clean = _run_fleet(traces, tmp_path, "clean", FleetChaos(seed=5, **PROBS), **kw)
        assert [r.agg_crc for r in clean.rounds] == [r.agg_crc for r in got.rounds]


def test_fleet_cli_json_equals_the_reference(tmp_path, telemetry_off):
    argv = ["--clients", "48", "--rounds", "3", "--per-round", "5",
            "--local-steps", "8", "--churn", "0.1", "--heavy-churn", "2:0.35",
            "--drop", "0.05", "--dup", "0.05", "--corrupt", "0.05",
            "--crash-round", "1", "--crash-after", "2", "--quiet"]
    texts, payloads, spans = [], [], []
    for name, cli in (("ref", jcli), ("port", tcli)):
        out, tel = tmp_path / f"{name}.json", tmp_path / f"{name}_tel"
        cli.main(argv + ["--json-out", str(out), "--telemetry-out", str(tel),
                         "--state-dir", str(tmp_path / f"{name}_state")])
        texts.append(out.read_text())
        payloads.append(json.loads(texts[-1]))
        trace = json.loads((tel / "trace.json").read_text())
        spans.append(sorted({e["name"] for e in trace["traceEvents"]
                             if e.get("ph") == "X"}))
        assert (tel / "metrics.jsonl").exists() and (tel / "spans.jsonl").exists()
    assert texts[1] == texts[0]  # byte for byte, key order included
    assert spans[1] == spans[0]
    assert {"fleet.round", "fleet.invite", "fleet.accept"} <= set(spans[1])
    assert "coordinator_crash" in payloads[1]["chaos"]["applied"]


# ---------------------------------------------------------------------------
# the checkpoint boundary: restored tensors come back as numpy
# ---------------------------------------------------------------------------


def test_restored_delta_and_global_are_float32_numpy(traces, tmp_path):
    client = _client(traces)
    job = FLTrainJob(client, rnd=0, local_steps=8, dim=16, seed=3,
                     ckpt_dir=str(tmp_path / "job"))
    for t in range(3):
        job.step(t)
    before = job._delta.copy()
    job.on_pause(3)
    # the port's store restores tensors (the reason for the conversion)
    _, raw = CheckpointManager(str(tmp_path / "job")).restore_latest()
    assert isinstance(raw["delta"], torch.Tensor)
    job.on_resume(4)
    assert type(job._delta) is np.ndarray and job._delta.dtype == np.float32
    np.testing.assert_array_equal(job._delta, before)

    cfg = _cfg()
    clients = build_fleet_clients(cfg, traces=traces)
    d = str(tmp_path / "coord")
    with pytest.raises(CoordinatorCrash):
        FleetCoordinator(clients, cfg, state_dir=d,
                         chaos=FleetChaos(seed=5, crash_at=(1, 2))).run()
    co = FleetCoordinator.resume(clients, cfg, state_dir=d,
                                 chaos=FleetChaos(seed=5))
    g = co.state["global"]
    assert type(g) is np.ndarray and g.dtype == np.float32 and g.shape == (16,)
    infl = co.state["inflight"]
    assert type(infl["agg"]) is np.ndarray and infl["agg"].dtype == np.float64
    for a in infl["arrivals"]:
        assert type(a["delta"]) is np.ndarray and a["delta"].dtype == np.float32
        assert zlib.crc32(a["delta"].tobytes()) == a["checksum"]


# ---------------------------------------------------------------------------
# the port's cases of tests/test_fleet.py
# ---------------------------------------------------------------------------


def test_pause_exact_resume_bitwise(traces, tmp_path):
    def run_round(with_fg, sub):
        job = FLTrainJob(_client(traces), rnd=0, local_steps=8, dim=16, seed=3,
                         ckpt_dir=str(tmp_path / sub))
        jobs = [job]
        if with_fg:
            jobs.append(ForegroundAppJob([(2, 5)], latency_s=0.5, power=1.2))
        SwanRuntime(jobs).run(24)
        assert job.done
        return job

    plain = run_round(False, "plain")
    paused = run_round(True, "paused")
    assert plain.pauses == 0 and paused.pauses >= 1
    d0, crc0 = plain.update_payload()
    d1, crc1 = paused.update_payload()
    np.testing.assert_array_equal(d0, d1)
    assert crc0 == crc1


def test_client_round_deterministic(traces, tmp_path):
    cfg = _cfg(fg_prob=0.3)
    outs = [run_client_round(_client(traces, cid=7, device="pixel3"), 0,
                             300.0, cfg, ckpt_root=str(tmp_path / f"r{i}"))
            for i in range(2)]
    assert outs[0].status == outs[1].status
    assert outs[0].latency_s == outs[1].latency_s
    if outs[0].status == "ok":
        np.testing.assert_array_equal(outs[0].delta, outs[1].delta)
        assert outs[0].checksum == outs[1].checksum


def test_baseline_client_has_single_rung(traces, tmp_path):
    client = _client(traces, policy="baseline")
    assert len(client.rungs) == 1
    job = FLTrainJob(client, rnd=0, local_steps=4, dim=8, seed=0,
                     ckpt_dir=str(tmp_path / "b"))
    assert not job.adaptive


def _arrival(cid, arrival_s, dim=16, n=10, corrupt=False):
    rng = np.random.default_rng((99, cid))
    delta = rng.standard_normal(dim).astype(np.float32)
    crc = zlib.crc32(delta.tobytes())
    if corrupt:
        delta = delta.copy()
        delta[0] += 1.0
    return {"cid": cid, "arrival_s": float(arrival_s), "delta": delta,
            "n_samples": n, "checksum": crc, "device": "s10e", "charging": 0}


def _hand_coordinator(traces, tmp_path, arrivals, k=4, deadline=10.0, stale=2.5):
    cfg = _cfg()
    clients = build_fleet_clients(cfg, traces=traces)
    co = FleetCoordinator(clients, cfg, state_dir=str(tmp_path))
    counters = {c: 0 for c in ("churned", "offline", "preempted", "straggled",
                               "dropped", "duplicated", "dup_rejected",
                               "corrupt_rejected", "late_rejected",
                               "preemptions")}
    co.state["inflight"] = {
        "rnd": 0, "t_start": 0.0, "online": len(clients),
        "invited": len(arrivals), "k": k, "deadline_s": deadline,
        "stale_s": stale, "arrivals": arrivals, "next_idx": 0,
        "accepted_cids": [], "accepted_on_time": 0, "stale_accepted": 0,
        "last_accept_s": 0.0, "agg": np.zeros(cfg.dim, np.float64),
        "weight": 0.0, "useful_samples": 0.0, "counters": counters,
        "by_class": {}, "by_class_energy": {}, "charging_accepted": 0,
        "retries": 0, "energy_j": 0.0,
    }
    co._save()
    co._finish_round()
    return co.result().rounds[0]


def test_acceptance_dedup_checksum_stale_window(traces, tmp_path):
    arrivals = [_arrival(1, 2.0), _arrival(1, 3.0), _arrival(2, 4.0, corrupt=True),
                _arrival(3, 11.0), _arrival(4, 13.0)]
    r = _hand_coordinator(traces, tmp_path, arrivals)
    assert r.accepted == 2 and r.accepted_cids == [1, 3]
    assert r.accepted_on_time == 1 and r.stale_accepted == 1
    assert r.dup_rejected == 1 and r.corrupt_rejected == 1 and r.late_rejected == 1
    assert r.shortfall == 2


def test_acceptance_stops_at_capacity(traces, tmp_path):
    r = _hand_coordinator(traces, tmp_path, [_arrival(c, 1.0 + c) for c in range(6)],
                          k=3)
    assert r.accepted == 3 and r.accepted_cids == [0, 1, 2]
    assert r.round_s == 3.0


def test_crash_resume_bitwise_parity(traces, tmp_path):
    clean = _run_fleet(traces, tmp_path, "clean", FleetChaos(seed=5, **PROBS))
    crashed = _run_fleet(traces, tmp_path, "crash",
                         FleetChaos(seed=5, crash_at=(1, 2), **PROBS), crash=True)
    assert [r.agg_crc for r in clean.rounds] == [r.agg_crc for r in crashed.rounds]
    assert [r.accepted_cids for r in clean.rounds] == \
        [r.accepted_cids for r in crashed.rounds]


def test_heavy_churn_round_degrades_gracefully(traces, tmp_path):
    ch = FleetChaos(seed=1, churn_rounds={1: 0.5})
    r = _run_fleet(traces, tmp_path, "churn", ch).rounds[1]
    assert r.churned > 0 and r.accepted > 0
    assert r.round_s <= r.deadline_s * 1.25 + 1e-9
    assert "client_churn" in ch.applied


def test_fleet_determinism(traces, tmp_path):
    logs = [[dataclasses.asdict(r) for r in _run_fleet(
        traces, tmp_path, f"det{i}",
        FleetChaos(seed=2, churn_prob=0.1, drop_prob=0.05)).rounds]
        for i in range(2)]
    assert logs[0] == logs[1]


def test_swan_beats_baseline_goodput(traces, tmp_path):
    swan = _run_fleet(traces, tmp_path, "sw", FleetChaos(seed=4, drop_prob=0.05))
    base = _run_fleet(traces, tmp_path, "bl", FleetChaos(seed=4, drop_prob=0.05),
                      policy="baseline")
    assert swan.goodput_samples_per_h >= base.goodput_samples_per_h
    assert swan.total_energy_j < base.total_energy_j


def test_fleet_chaos_delivery_is_seeded():
    a = FleetChaos(seed=9, drop_prob=0.3, dup_prob=0.3, corrupt_prob=0.3)
    b = FleetChaos(seed=9, drop_prob=0.3, dup_prob=0.3, corrupt_prob=0.3)
    fates = [a.delivery(0, cid) for cid in range(40)]
    assert fates == [b.delivery(0, cid) for cid in range(40)]
    assert set(fates) >= {"ok", "dropped"}
    for kind in a.applied:
        assert kind in FLEET_KINDS
