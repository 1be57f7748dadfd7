"""The port's telemetry (``repro_torch.obs``, the serve engine's spans and
speculation metrics, ``launch/obs_report.py``) against the JAX package's.

- The reference's unit tests of ``obs`` (``tests/test_obs.py``: metrics,
  tracer, schema, timeline, audit, bundle) run unchanged on the port's
  modules: each test function is rebound to globals that name the port's.
- The serve engine: the same requests through the JAX engine and the
  port's, each package's telemetry on, give the same ordered list of
  ``(name, args)`` of every span and the same final metrics, on every
  path (contiguous with and without bucketing, paged with shared prefixes
  and copy-on-write, the swap tier, n-gram speculation on both layouts,
  sampling); with telemetry off the port's streams are the same tokens.
- The mixed CLI: with the reference's ``test_mixed_run_emits_complete_bundle``
  argv the reference's assertions hold on the port's bundle; with an upgrade
  patience that keeps every decision on the thermal trace, its metric
  families, span names and counts, audit rows and final metric keys equal
  the reference CLI's.
- The serve CLI's ``--telemetry-out`` and versioned ``--json-out``.

Both packages' global telemetry is installed disabled around every test
and restored after it, so that nothing leaks into later tests on a worker.
"""
import collections
import importlib.util
import json
import pathlib
import types

import jax
import numpy as np
import pytest

from repro import obs as ref_obs
from repro.configs.base import ModelConfig as JModelConfig
from repro.launch import mixed as jmixed
from repro.launch import obs_report as jreport
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.timeline import Timeline
from repro_torch.launch import mixed as tmixed
from repro_torch.launch import obs_report
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_tree
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import schema as tschema
from repro_torch.obs import trace as ttrace

# benchmarks/obs_bench.py's engine
TINY = dict(name="obs-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            tie_embeddings=True, source="benchmarks/obs_bench.py")
VOCAB = TINY["vocab_size"]


@pytest.fixture(autouse=True)
def telemetry_off():
    """Both packages' global telemetry off, and restored after the test
    (a CLI's ``--telemetry-out`` installs an enabled one)."""
    prev = (ref_obs.set_telemetry(ref_obs.Telemetry(enabled=False)),
            obs.set_telemetry(obs.Telemetry(enabled=False)))
    yield
    ref_obs.set_telemetry(prev[0])
    obs.set_telemetry(prev[1])


# ---------------------------------------------------------------------------
# the reference's unit tests of obs, on the port's modules
# ---------------------------------------------------------------------------

_spec = importlib.util.spec_from_file_location(
    "_reference_test_obs", pathlib.Path(__file__).with_name("test_obs.py"))
REF_TESTS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF_TESTS)

# every global of those tests that names the JAX package's obs or Timeline
PORT_GLOBALS = dict(
    obs=obs, Timeline=Timeline, NOOP=tmetrics.NOOP,
    MetricsRegistry=tmetrics.MetricsRegistry,
    SCHEMA_VERSION=tschema.SCHEMA_VERSION, encode_record=tschema.encode_record,
    versioned=tschema.versioned, _NOOP_SPAN=ttrace._NOOP_SPAN,
    SpanTracer=ttrace.SpanTracer)

REF_UNIT_TESTS = [
    "test_metrics_labels_round_trip", "test_metrics_histogram_quantiles",
    "test_metrics_disabled_is_shared_noop", "test_metrics_kind_mismatch_raises",
    "test_tracer_nesting_and_chrome_trace_ordering",
    "test_tracer_disabled_returns_shared_noop_span",
    "test_tracer_records_exception_and_reraises", "test_tracer_cap_counts_drops",
    "test_encode_record_strict_json", "test_timeline_merged_round_trips_bitwise",
    "test_audit_log_round_trips_bitwise",
    "test_telemetry_bundle_save_and_debug_dump",
    "test_disabled_telemetry_dump_and_noop_identity"]


def _names_jax_package(obj) -> bool:
    mod = obj.__name__ if isinstance(obj, types.ModuleType) else \
        getattr(obj, "__module__", None) or type(obj).__module__
    return mod == "repro" or mod.startswith("repro.")


@pytest.mark.parametrize("name", REF_UNIT_TESTS)
def test_reference_obs_unit_test_on_the_port(name, tmp_path):
    ref = getattr(REF_TESTS, name)
    glb = {**ref.__globals__, **PORT_GLOBALS}
    used = [n for n in ref.__code__.co_names if n in glb]
    assert not [n for n in used if _names_jax_package(glb[n])], used
    fn = types.FunctionType(ref.__code__, glb, name, ref.__defaults__,
                            ref.__closure__)
    fixtures = {"tmp_path": tmp_path}  # the only fixture they take
    fn(*[fixtures[a] for a in ref.__code__.co_varnames[
        :ref.__code__.co_argcount]])


def test_schema_is_the_reference_schema():
    assert tschema.SCHEMA_VERSION == ref_obs.SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the serve engine's spans and metrics against the JAX engine's
# ---------------------------------------------------------------------------


def _ragged(mod):
    """7 requests of 5 or 8 prompt tokens and 3-8 new tokens through 3
    slots: admission and retirement interleave."""
    rng = np.random.default_rng(0)
    return [mod.Request(uid=i,
                        prompt=rng.integers(0, VOCAB, int(rng.choice([5, 8]))
                                            ).astype(np.int32),
                        max_new_tokens=int(rng.integers(3, 9)))
            for i in range(7)]


def _shared_prefix(mod):
    """Prompts over a 4-block shared prefix, two of them identical: prefix
    hits, a read-only recompute and copy-on-write."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, VOCAB, 16)
    prompts = [np.concatenate([prefix, rng.integers(0, VOCAB, n)])
               for n in (3, 5, 0, 6)] + [prefix[:10]]
    prompts[2] = prompts[0].copy()
    return [mod.Request(uid=i, prompt=p.astype(np.int32), max_new_tokens=6 + i)
            for i, p in enumerate(prompts)]


PAGED = dict(kv_layout="paged", block_size=4)
PATHS = {
    "contig": (_ragged, {}),
    "contig_bucketed": (_ragged, dict(bucket_prompts=True)),
    "paged_prefix_cow": (_shared_prefix, PAGED),
    "swap": (_shared_prefix, dict(PAGED, num_blocks=12,
                                  admission_policy="swap")),
    "spec_contig": (_ragged, dict(draft_depth=3)),
    "spec_paged": (_shared_prefix, dict(PAGED, draft_depth=3)),
    "sampled": (_ragged, dict(temperature=0.9, top_k=32, sample_seed=1)),
}


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model(JModelConfig(**TINY), impl="naive")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, build_model(ModelConfig(**TINY), impl="pallas",
                                        device="cpu"), tparams


def _serve(pkg_obs, mod, model, params, reqs, enabled, **kw):
    """One engine over ``reqs`` with ``pkg_obs``'s telemetry on or off:
    (streams, [(name, args)], metrics snapshot, engine)."""
    tel = pkg_obs.Telemetry(enabled=enabled)
    prev = pkg_obs.set_telemetry(tel)
    try:
        engine = mod.ContinuousBatchingEngine(model, params, max_batch=3,
                                              max_seq=64, **kw)
        done = engine.run(reqs(mod))
    finally:
        pkg_obs.set_telemetry(prev)
    return ({u: f.tokens for u, f in done.items()},
            [(s.name, s.args) for s in tel.tracer.spans()],
            tel.metrics.snapshot()["metrics"], engine)


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request, tiny):
    """The JAX engine with its telemetry on, the port's with it on and off,
    on one path."""
    jmodel, jparams, tmodel, tparams = tiny
    reqs, kw = PATHS[request.param]
    return dict(name=request.param,
                jax=_serve(ref_obs, jserve, jmodel, jparams, reqs, True, **kw),
                on=_serve(obs, tserve, tmodel, tparams, reqs, True, **kw),
                off=_serve(obs, tserve, tmodel, tparams, reqs, False, **kw))


def test_serve_spans_match_jax(pair):
    want, got = pair["jax"], pair["on"]
    assert got[0] == want[0], "streams differ from the JAX engine's"
    assert got[1] == want[1]
    names = collections.Counter(n for n, _ in got[1])
    st = got[3].stats()
    assert names["serve.decode"] + names["serve.spec_verify"] == \
        st["decode_steps"]
    name = pair["name"]
    if name.startswith("contig"):
        assert names["serve.prefill"] == len(got[0])
    if "paged" in name or name == "swap":
        assert names["serve.prefill_chunk"] == st["prefill_chunks"]
        assert any(a.get("readonly") for n, a in got[1]
                   if n == "serve.prefill_chunk")
    if name == "paged_prefix_cow":
        assert names["serve.cow_copy"] == st["cow_copies"] >= 1
    if name == "swap":
        assert names["serve.swap_out"] == st["swap_outs"] >= 1
        assert names["serve.swap_in"] == st["swap_ins"]
    if "spec" in name:
        assert names["serve.spec_draft"] == names["serve.spec_verify"] >= 1


def test_spec_metrics_match_jax(pair):
    want, got = pair["jax"][2], pair["on"][2]
    assert got == want
    engine = pair["on"][3]
    if "spec" not in pair["name"]:
        assert got == {}
        return
    value = {k: v["series"][0]["value"] for k, v in got.items()}
    assert value == {"spec_drafted_total": engine.spec_drafted,
                     "spec_accepted_total": engine.spec_accepted,
                     "spec_acceptance_rate": engine.spec_accepted /
                     max(1, engine.spec_drafted)}
    assert engine.spec_drafted > 0


def test_span_args_are_python_ints(pair):
    for name, args in pair["on"][1]:
        assert name.startswith("serve.")
        for k, v in args.items():
            assert type(v) is int or (k == "readonly" and v is True), \
                (name, k, type(v))


def test_telemetry_off_leaves_streams_and_records_nothing(pair):
    on, off = pair["on"], pair["off"]
    assert off[0] == on[0]
    assert off[1] == [] and off[2] == {}
    assert off[3].stats() == on[3].stats()


def _port_engine(**kw):
    model = build_model(ModelConfig(**TINY), impl="naive", device="cpu")
    return tserve.ContinuousBatchingEngine(
        model, model.init(model.generator(0)), **kw)


def test_cow_and_prefill_spans_recorded():
    tel = obs.enable()
    prompt = np.arange(3, 13, dtype=np.int32)  # partial tail block
    engine = _port_engine(max_batch=3, max_seq=32, kv_layout="paged",
                          block_size=4)
    engine.run([tserve.Request(uid=i, prompt=prompt.copy(), max_new_tokens=4)
                for i in range(3)])
    assert engine.stats()["cow_copies"] > 0
    agg = tel.tracer.by_name()
    assert agg["serve.cow_copy"]["count"] == engine.stats()["cow_copies"]
    assert agg["serve.prefill_chunk"]["count"] > 0
    assert agg["serve.decode"]["count"] == engine.decode_steps


def test_swap_spans_recorded():
    tel = obs.enable()
    engine = _port_engine(max_batch=2, max_seq=32, kv_layout="paged",
                          block_size=4, num_blocks=6,
                          admission_policy="swap", prefix_cache=False)
    engine.run([tserve.Request(uid=i, prompt=np.arange(2, 10, dtype=np.int32),
                               max_new_tokens=4) for i in range(3)])
    st = engine.stats()
    assert st["swap_outs"] >= 1
    agg = tel.tracer.by_name()
    assert agg["serve.swap_out"]["count"] == st["swap_outs"]
    assert agg["serve.swap_in"]["count"] == st["swap_ins"]


def test_checkpoint_spans_recorded(tmp_path):
    tel = obs.enable()
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": np.ones(4, np.float32)}
    mgr.save(3, state)
    step, restored = mgr.restore_latest()
    assert step == 3 and np.array_equal(np.asarray(restored["w"]), state["w"])
    agg = tel.tracer.by_name()
    assert agg["ckpt.save"]["count"] == 1
    assert agg["ckpt.restore"]["count"] == 1
    recs = {s.name: s for s in tel.tracer.spans()}
    assert recs["ckpt.save"].args == {"step": 3}


# ---------------------------------------------------------------------------
# the mixed CLI's bundle against the reference CLI's
# ---------------------------------------------------------------------------

# tests/test_obs.py::test_mixed_run_emits_complete_bundle's argv
MIXED_ARGV = ["--arch", "llama3.2-1b", "--reduced", "--ticks", "12",
              "--batch", "4", "--seq", "32", "--slots", "2",
              "--requests", "5", "--prompt-len", "8", "--gen", "6",
              "--kv-layout", "paged", "--battery-j", "200",
              "--thermal-trace", "0.3:0.25:3.0:0.5:0.4", "--quiet"]
# For the two packages' bundles to compare row for row, an upgrade patience
# above the tick count: a walk back up waits for five ticks of measured
# step times within 8% of the rung's calibration, so whether it comes in 12
# ticks follows each run's timing (the port's CPU run has walked train up
# at tick 11 where JAX's did not). Without one every decision follows the
# thermal trace.
COMPARE_ARGV = MIXED_ARGV + ["--upgrade-patience", "13"]


@pytest.fixture(scope="module")
def mixed_bundles(tmp_path_factory):
    """The port's mixed CLI (on the CPU) with the reference test's argv,
    and each package's with ``COMPARE_ARGV``: each run's bundle directory,
    merged timeline and ``--json-out`` payload."""
    out = {}
    prev = (ref_obs.get_telemetry(), obs.get_telemetry())
    try:
        for name, cli, argv in (
                ("torch", tmixed, MIXED_ARGV + ["--device", "cpu"]),
                ("torch_compare", tmixed, COMPARE_ARGV + ["--device", "cpu"]),
                ("jax", jmixed, COMPARE_ARGV)):
            d = tmp_path_factory.mktemp(f"mixed_{name}")
            cli.main(argv + [
                "--telemetry-out", str(d / "tel"),
                "--timeline-out", str(d / "merged.json"),
                "--json-out", str(d / "run.json")])
            out[name] = d
    finally:
        ref_obs.set_telemetry(prev[0])
        obs.set_telemetry(prev[1])
    return out


def _metric_families(metrics_path):
    lines = [json.loads(line) for line in open(metrics_path)]
    body = [line for line in lines if "metrics" in line]
    assert lines[0]["schema_version"] == tschema.SCHEMA_VERSION
    return body, {k.split("{")[0] for line in body for k in line["metrics"]}


def _trace_spans(outdir):
    trace = json.load(open(outdir / "trace.json"))
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def test_mixed_run_emits_complete_bundle(mixed_bundles, tmp_path):
    """The reference's assertions, on the port's mixed CLI's bundle."""
    outdir = mixed_bundles["torch"] / "tel"
    tl_out = mixed_bundles["torch"] / "merged.json"
    json_out = mixed_bundles["torch"] / "run.json"

    body, fams = _metric_families(outdir / "metrics.jsonl")
    assert len(body) >= 12
    for fam in ["serve_tokens_out", "serve_occupancy", "train_loss",
                "train_steps_total", "pool_utilization", "pool_fragmentation",
                "pool_total_cow", "prefix_hit_rate", "energy_loan_j",
                "battery_level", "thermal_temp_c", "thermal_throttled",
                "job_rung_idx", "job_step_latency_s",
                "runtime_migrations_total"]:
        assert fam in fams, f"metric family {fam} missing from the stream"

    trace = json.load(open(outdir / "trace.json"))
    json.dumps(trace, allow_nan=False)
    xs = _trace_spans(outdir)
    names = {e["name"] for e in xs}
    assert {"runtime.tick", "train.step", "serve.decode",
            "serve.prefill_chunk"} <= names
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    ticks = sorted(e["ts"] for e in xs if e["name"] == "runtime.tick")
    steps = [e for e in xs if e["name"] == "train.step"]
    assert len(ticks) == 12 and len(steps) >= 1
    assert any(e["args"].get("compile") for e in steps)

    tl = Timeline.from_json(json.load(open(tl_out)))
    assert tl.migrations, "thermal trace must force at least one migration"
    audit = obs.AuditLog.from_json(json.load(open(outdir / "audit.json")))
    commits = audit.commits()
    for m in tl.migrations:
        matches = [r for r in commits
                   if r.tick == m.step and r.job == m.job
                   and r.from_rung == m.from_rung and r.to_rung == m.to_rung]
        assert matches, f"no audit record for migration {m}"
        rec = matches[0]
        assert rec.rule == m.reason
        assert rec.scores, f"audit record for {m} carries no scores"
        assert rec.thermal is not None and rec.energy is not None
    assert any(r.event == "propose" for r in audit.records())

    payload = json.load(open(json_out))
    assert payload["schema_version"] == tschema.SCHEMA_VERSION
    assert json.load(open(tl_out))["schema_version"] == tschema.SCHEMA_VERSION

    chrome2 = tmp_path / "chrome2.json"
    rep = obs_report.main([str(outdir), "--top", "5", "--audit-limit", "5",
                           "--chrome-trace", str(chrome2)])
    assert rep["spans"][0]["name"] == "runtime.tick"
    assert rep["final_metrics"]
    doc2 = json.load(open(chrome2))
    assert {e["name"] for e in doc2["traceEvents"] if e["ph"] == "X"} == names


def test_mixed_bundle_matches_the_reference_cli(mixed_bundles):
    got, want = (mixed_bundles[k] / "tel" for k in ("torch_compare", "jax"))
    assert _metric_families(got / "metrics.jsonl")[1] == \
        _metric_families(want / "metrics.jsonl")[1]
    count = [collections.Counter(e["name"] for e in _trace_spans(d))
             for d in (got, want)]
    assert count[0] == count[1]
    assert {"serve.decode", "serve.prefill_chunk"} <= set(count[0])
    rep = [obs_report.report(str(d), top=0) for d in (got, want)]
    # durations (span times, step latencies) are the run's own; the rest
    # is the arbiter's arithmetic on the same trace, so it is equal
    assert sorted((r["name"], r["count"]) for r in rep[0]["spans"]) == \
        sorted((r["name"], r["count"]) for r in rep[1]["spans"])
    assert rep[0]["audit"] == rep[1]["audit"]
    assert set(rep[0]["final_metrics"]) == set(rep[1]["final_metrics"])
    assert [(r["job"], r["rung"], r["count"]) for r in rep[0]["rung_latency"]] \
        == [(r["job"], r["rung"], r["count"]) for r in rep[1]["rung_latency"]]


def test_obs_report_reads_the_jax_packages_bundle(mixed_bundles, tmp_path):
    outdir = str(mixed_bundles["jax"] / "tel")
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    got = obs_report.report(outdir, top=0, chrome_trace=str(a))
    want = jreport.report(outdir, top=0, chrome_trace=str(b))
    assert got == want
    assert json.load(open(a)) == json.load(open(b))


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--kv-layout", "paged",
                                        "--draft-depth", "3"]])
def test_serve_cli_writes_the_bundle(tmp_path, flags):
    tel_dir, out = tmp_path / "tel", tmp_path / "serve.json"
    done = tserve.main(["--reduced", "--batch", "2", "--requests", "4",
                        "--prompt-len", "8", "--gen", "4", "--attn-impl",
                        "pallas", "--device", "cpu", "--json-out", str(out),
                        "--telemetry-out", str(tel_dir)] + flags)
    assert sorted(done) == [0, 1, 2, 3]
    assert sorted(p.name for p in tel_dir.iterdir()) == [
        "audit.json", "metrics.jsonl", "spans.jsonl", "trace.json"]
    payload = json.loads(out.read_text())
    assert payload["schema_version"] == tschema.SCHEMA_VERSION
    assert payload["device"] == "cpu" and "kv_layout" in payload
    st = payload["stats"]
    rep = obs_report.report(str(tel_dir), top=0)
    count = {r["name"]: r["count"] for r in rep["spans"]}
    assert count.get("serve.decode", 0) + count.get("serve.spec_verify", 0) \
        == payload["steps"]
    if flags:
        assert count["serve.prefill_chunk"] == st["prefill_chunks"]
        assert count.get("serve.cow_copy", 0) == st["cow_copies"]
        final = rep["final_metrics"]
        assert final["spec_drafted_total"] == st["spec_drafted"]
        assert final["spec_accepted_total"] == st["spec_accepted"]
    else:
        assert count["serve.prefill"] == payload["requests"]
