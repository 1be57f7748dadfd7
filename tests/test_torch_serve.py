"""The port's continuous-batching engine against the JAX package's.

The scenarios of ``tests/test_serve_loop.py``, served by both engines on the
same carried-over params (reduced llama3.2-1b, f32 cache, greedy). The
streams must be token-identical, with the same retirement reasons. The port
runs both its attention paths: ``naive``, and ``pallas`` (the flash kernels'
plain versions on the CPU).
"""
import json

import jax
import numpy as np
import pytest

from repro.configs import ASSIGNED
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy_tree

CFG = ASSIGNED["llama3.2-1b"].reduced()


@pytest.fixture(scope="module")
def params():
    jparams = jax_build_model(CFG).init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _requests(seed, lens, budgets):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 64, p).astype(np.int32), n)
            for i, (p, n) in enumerate(zip(lens, budgets))]


def _serve_jax(jparams, reqs, impl="naive", **kw):
    model = jax_build_model(CFG, impl=impl)
    engine = jserve.ContinuousBatchingEngine(model, jparams, **kw)
    done = engine.run([jserve.Request(uid=u, prompt=p, max_new_tokens=n)
                       for u, p, n in reqs])
    return {u: (f.tokens, f.reason) for u, f in done.items()}, engine


def _serve_torch(tparams, reqs, impl, **kw):
    model = build_model(CFG, impl=impl, device="cpu")
    engine = tserve.ContinuousBatchingEngine(model, tparams, **kw)
    done = engine.run([tserve.Request(uid=u, prompt=p, max_new_tokens=n)
                       for u, p, n in reqs])
    return {u: (f.tokens, f.reason) for u, f in done.items()}, engine


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_ragged_requests_through_fewer_slots(params, impl):
    """3 ragged requests through 2 slots: request 2 is admitted mid-stream
    into whichever slot retires first."""
    jparams, tparams = params
    reqs = _requests(1, (5, 9, 3), (6, 3, 5))
    want, jeng = _serve_jax(jparams, reqs, max_batch=2, max_seq=32)
    got, teng = _serve_torch(tparams, reqs, impl, max_batch=2, max_seq=32)
    assert got == want
    assert teng.decode_steps == jeng.decode_steps
    assert teng.occupancy == pytest.approx(jeng.occupancy)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_eos_mid_stream_frees_the_slot(params, impl):
    jparams, tparams = params
    reqs = _requests(2, (6, 6), (8, 2))
    base, _ = _serve_jax(jparams, reqs[:1], max_batch=1, max_seq=32)
    eos = base[0][0][2]  # the token request 0 emits third
    want, _ = _serve_jax(jparams, reqs, max_batch=1, max_seq=32, eos_id=eos)
    got, _ = _serve_torch(tparams, reqs, impl, max_batch=1, max_seq=32, eos_id=eos)
    assert got == want
    assert got[0][1] == "eos" and 1 in got


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_capacity_retirement_with_an_idle_full_slot(params, impl):
    """Request 0 (P=7) fills the cache and retires at cache_len == max_seq
    while request 1 (P=3) still decodes: the batched steps after that write
    the idle slot's K/V at position max_seq (which must land nowhere) and
    pass it length max_seq + 1 (which the decode kernel clamps)."""
    jparams, tparams = params
    max_seq = 12
    reqs = _requests(4, (7, 3), (99, 99))
    want, _ = _serve_jax(jparams, reqs, impl=impl, max_batch=2, max_seq=max_seq)
    got, teng = _serve_torch(tparams, reqs, impl, max_batch=2, max_seq=max_seq)
    assert got == want
    assert [len(got[u][0]) for u in (0, 1)] == [max_seq - 7 + 1, max_seq - 3 + 1]
    assert got[0][1] == got[1][1] == "length"
    assert teng.cache_len.tolist() == [max_seq, max_seq]
    assert teng.decode_steps == max_seq - 3  # the idle slot rode along


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_bucketed_prompts(params, impl):
    jparams, tparams = params
    reqs = _requests(5, (5, 9, 3), (4, 4, 4))
    want, jeng = _serve_jax(jparams, reqs, max_batch=2, max_seq=32,
                            bucket_prompts=True)
    got, teng = _serve_torch(tparams, reqs, impl, max_batch=2, max_seq=32,
                             bucket_prompts=True)
    assert got == want
    assert teng.prefill_lengths == jeng.prefill_lengths == {8: 1, 16: 1, 4: 1}


def test_engine_contract(params):
    _, tparams = params
    model = build_model(CFG, impl="naive", device="cpu")
    engine = tserve.ContinuousBatchingEngine(model, tparams, max_batch=2, max_seq=8)
    with pytest.raises(ValueError, match="does not fit"):
        engine.submit(tserve.Request(uid=0, prompt=np.zeros(8, np.int32),
                                     max_new_tokens=1))
    assert engine.step() == [] and not engine.has_work
    st = engine.stats()
    assert st["kv_bytes"] == 2 * CFG.n_layers * 2 * 8 * CFG.n_kv_heads * \
        CFG.head_dim * 4
    assert set(st["kernel_launches"]) == {"flash_fwd", "flash_decode",
                                          "flash_decode_paged",
                                          "flash_decode_spec",
                                          "flash_decode_spec_paged",
                                          "flash_decode_mla",
                                          "flash_decode_mla_paged"}


def test_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "serve.json"
    done = tserve.main(["--reduced", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen", "3", "--attn-impl",
                        "pallas", "--device", "cpu", "--json-out", str(out)])
    assert sorted(done) == [0, 1, 2]
    payload = json.loads(out.read_text())
    assert payload["device"] == "cpu" and payload["impl"] == "pallas"
    assert payload["stats"]["kernel_launches"] == {
        "flash_fwd": 0, "flash_decode": 0, "flash_decode_paged": 0,
        "flash_decode_spec": 0, "flash_decode_spec_paged": 0,
        "flash_decode_mla": 0, "flash_decode_mla_paged": 0}
