"""The port's MLA attention against the JAX package's.

Inputs are drawn with numpy from a seed; parameters are initialised by JAX
and carried over through numpy. The JAX side's ``impl="pallas"`` runs its
Pallas decode kernels in interpret mode; the port's runs the plain versions
of ``flash_decode_mla`` and ``flash_decode_mla_paged`` (``kernels/ref.py``),
as every kernel wrapper does for a CPU tensor. Tolerances: 2e-5 at f32
(the two sides differ in the order of f32 sums only), as in
``tests/test_decode_consistency.py``.

- ``mla_decode`` and ``mla_decode_paged``, ``impl`` "pallas" against
  "naive" (``tests/test_decode_consistency.py:154``) and each against JAX,
  scalar and ragged (with a retired slot's ``max_seq``), and the updated
  latent caches; ``mla_prefill_paged`` writing and read-only;
  ``mla_forward``'s one-time ``RuntimeWarning`` under "pallas".
- The plain latent decode at deepseek-v3's real geometry (H = G 128,
  hd = r + rd = 576, hdv = r = 512, scale 1/sqrt(192)) against JAX's
  ``decode_attention_mla{,_paged}`` (``_decode_kernel`` and
  ``_decode_paged_kernel`` in interpret mode), at small B and Smax, over an
  f32 and a bf16 cache.

The whole deepseek-v3 decoder is held in ``tests/test_torch_deepseek_v3.py``.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_numpy_tree

F32 = dict(rtol=2e-5, atol=2e-5)
CFG = ASSIGNED["deepseek-v3-671b"].reduced()
FULL = ASSIGNED["deepseek-v3-671b"]
KEY = jax.random.PRNGKey(0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.fixture(scope="module")
def attn_params():
    jp = jattn.mla_params(KEY, CFG)
    return jp, from_numpy_tree(_np_tree(jp), device="cpu")


def _caches(B, Smax, seed=4):
    rng = np.random.default_rng(seed)
    lat = (rng.standard_normal((B, Smax, CFG.kv_lora_rank)) * 0.3).astype(np.float32)
    kr = (rng.standard_normal((B, Smax, CFG.qk_rope_head_dim)) * 0.3).astype(np.float32)
    return lat, kr


def _x(B, seed=1, S=1):
    return (np.random.default_rng(seed).standard_normal((B, S, CFG.d_model)) * 0.1
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# MLA decode and prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True])
def test_mla_decode_pallas_matches_naive_and_jax(attn_params, ragged):
    jp, tp = attn_params
    B, Smax = 3, 24
    x = _x(B)
    lat, kr = _caches(B, Smax)
    cl = np.array([4, 23, 2], np.int32) if ragged else 7
    jcl = jnp.asarray(cl) if ragged else jnp.int32(cl)
    want = {impl: jattn.mla_decode(jp, jnp.asarray(x), {"latent": jnp.asarray(lat),
                                                        "k_rope": jnp.asarray(kr)},
                                   jcl, CFG, impl=impl) for impl in ("naive", "pallas")}
    got = {}
    for impl in ("naive", "pallas"):
        cache = {"latent": _t(lat), "k_rope": _t(kr)}
        tcl = torch.from_numpy(cl) if ragged else cl
        got[impl] = tattn.mla_decode(tp, _t(x), cache, tcl, CFG, impl=impl)
    np.testing.assert_allclose(got["pallas"][0].numpy(), got["naive"][0].numpy(), **F32)
    for impl in ("naive", "pallas"):
        y, cache = got[impl]
        np.testing.assert_allclose(y.numpy(), np.asarray(want[impl][0]), **F32)
        for k in ("latent", "k_rope"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(want[impl][1][k]),
                                       **F32)


def _pool(B, bs, T, seed=6):
    """Pools of B*T + 1 blocks and a shuffled table over blocks 1..B*T; the
    last row is an idle slot's, every entry at null block 0."""
    rng = np.random.default_rng(seed)
    NB = B * T + 1
    lat = (rng.standard_normal((NB, bs, CFG.kv_lora_rank)) * 0.3).astype(np.float32)
    kr = (rng.standard_normal((NB, bs, CFG.qk_rope_head_dim)) * 0.3).astype(np.float32)
    table = (rng.permutation(B * T) + 1).reshape(B, T).astype(np.int32)
    table[-1] = 0
    return lat, kr, table


@pytest.mark.parametrize("ragged", [False, True])
def test_mla_decode_paged_pallas_matches_naive_and_jax(attn_params, ragged):
    jp, tp = attn_params
    B, bs, T = 3, 4, 6
    x = _x(B, seed=2)
    lat, kr, table = _pool(B, bs, T)
    # ragged: the idle last slot retired at max_seq and rides along
    cl = np.array([5, 17, T * bs], np.int32) if ragged else 9
    jcl = jnp.asarray(cl) if ragged else jnp.int32(cl)
    want = {impl: jattn.mla_decode_paged(
        jp, jnp.asarray(x), {"latent": jnp.asarray(lat), "k_rope": jnp.asarray(kr)},
        jcl, jnp.asarray(table), CFG, impl=impl) for impl in ("naive", "pallas")}
    got = {}
    for impl in ("naive", "pallas"):
        cache = {"latent": _t(lat), "k_rope": _t(kr)}
        tcl = torch.from_numpy(cl) if ragged else cl
        got[impl] = tattn.mla_decode_paged(tp, _t(x), cache, tcl, torch.from_numpy(table),
                                           CFG, impl=impl)
    live = slice(0, 2) if ragged else slice(None)  # the idle row's output is garbage
    np.testing.assert_allclose(got["pallas"][0][live].numpy(),
                               got["naive"][0][live].numpy(), **F32)
    for impl in ("naive", "pallas"):
        y, cache = got[impl]
        np.testing.assert_allclose(y[live].numpy(), np.asarray(want[impl][0])[live], **F32)
        for k in ("latent", "k_rope"):  # pools compared off the null block
            np.testing.assert_allclose(cache[k][1:].numpy(),
                                       np.asarray(want[impl][1][k])[1:], **F32)


@pytest.mark.parametrize("write", [True, False])
def test_mla_prefill_paged_matches_jax(attn_params, write):
    jp, tp = attn_params
    B, bs, T = 2, 4, 5
    x = _x(B, seed=3, S=bs)
    lat, kr, table = _pool(B + 1, bs, T, seed=7)
    table = table[:B]
    start = 2 * bs
    want_y, want_c = jattn.mla_prefill_paged(
        jp, jnp.asarray(x), {"latent": jnp.asarray(lat), "k_rope": jnp.asarray(kr)},
        jnp.int32(start), jnp.asarray(table), CFG, write=write)
    cache = {"latent": _t(lat), "k_rope": _t(kr)}
    y, cache = tattn.mla_prefill_paged(tp, _t(x), cache, start, torch.from_numpy(table),
                                       CFG, write=write)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    for k in ("latent", "k_rope"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_c[k]), **F32)
    if not write:
        assert np.array_equal(cache["latent"].numpy(), lat)


def test_mla_forward_warns_once_under_pallas_and_takes_chunked(attn_params, monkeypatch):
    jp, tp = attn_params
    x = _x(2, seed=5, S=9)
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    monkeypatch.setattr(tattn, "_MLA_PALLAS_WARNED", False)
    with pytest.warns(RuntimeWarning, match="falling back to 'chunked'"):
        y = tattn.mla_forward(tp, _t(x), CFG, positions=pos, impl="pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = tattn.mla_forward(tp, _t(x), CFG, positions=pos, impl="pallas")
    chunked = tattn.mla_forward(tp, _t(x), CFG, positions=pos, impl="chunked")
    assert torch.equal(y, chunked) and torch.equal(again, chunked)
    want = jattn.mla_forward(jp, jnp.asarray(x), CFG, positions=jnp.asarray(pos.numpy()),
                             impl="naive")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# the plain latent decode at deepseek-v3's real geometry
# ---------------------------------------------------------------------------

H, R, RD = FULL.n_heads, FULL.kv_lora_rank, FULL.qk_rope_head_dim
SCALE = 1.0 / math.sqrt(FULL.qk_nope_head_dim + FULL.qk_rope_head_dim)


def _latent_inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    q_lat = rng.standard_normal((B, 1, H, R)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, RD)).astype(np.float32)
    lat = (rng.standard_normal((B, S, R)) * 0.1).astype(np.float32)
    kr = rng.standard_normal((B, S, RD)).astype(np.float32)
    return q_lat, q_rope, lat, kr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_latent_decode_at_the_real_geometry_matches_jax(dtype):
    """B 3 over Smax 40 (not a multiple of the kernel's key tiles), lengths
    0, 1 and Smax + 1 (a retired slot)."""
    B, Smax = 3, 40
    q_lat, q_rope, lat, kr = _latent_inputs(8, B, Smax)
    lengths = np.array([0, 1, Smax + 1], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jlat, jkr = jnp.asarray(lat, jdt), jnp.asarray(kr, jdt)
    want = jops.decode_attention_mla(jnp.asarray(q_lat), jnp.asarray(q_rope), jlat, jkr,
                                     jnp.asarray(lengths), scale=SCALE)
    tdt = getattr(torch, dtype)
    got = ops.decode_attention_mla(_t(q_lat), _t(q_rope), _t(lat).to(tdt), _t(kr).to(tdt),
                                   torch.from_numpy(lengths), scale=SCALE)
    assert got.shape == (B, 1, H, R) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **F32)
    assert not got[0].any()  # length 0: zeros
    # lengths past Smax clamp: the retired row reads the whole cache
    full = ops.decode_attention_mla(_t(q_lat), _t(q_rope), _t(lat).to(tdt), _t(kr).to(tdt),
                                    torch.tensor([1, 1, Smax]), scale=SCALE)
    assert torch.equal(full[2], got[2])


def test_plain_latent_decode_paged_at_the_real_geometry_matches_jax():
    B, bs, T = 3, 8, 5
    rng = np.random.default_rng(9)
    q_lat, q_rope, _, _ = _latent_inputs(9, B, 1)
    NB = B * T + 1
    lat = (rng.standard_normal((NB, bs, R)) * 0.1).astype(np.float32)
    kr = rng.standard_normal((NB, bs, RD)).astype(np.float32)
    table = (rng.permutation(B * T) + 1).reshape(B, T).astype(np.int32)
    table[2] = 0  # an idle row at null block 0
    table[1, 3] = NB + 4  # an entry past the pool: clipped
    lengths = np.array([29, 40, 0], np.int32)
    want = jops.decode_attention_mla_paged(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(lat), jnp.asarray(kr),
        jnp.asarray(table), jnp.asarray(lengths), scale=SCALE)
    got = ops.decode_attention_mla_paged(_t(q_lat), _t(q_rope), _t(lat), _t(kr),
                                         torch.from_numpy(table), torch.from_numpy(lengths),
                                         scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_latent_decode_wrappers_refuse_what_the_kernel_does_not_take():
    q_lat, q_rope, lat, kr = (_t(a) for a in _latent_inputs(10, 1, 8))
    with pytest.raises(TypeError, match="f32 queries"):
        tfa.flash_decode_mla(q_lat[:, 0].to(torch.bfloat16), q_rope[:, 0], lat, kr, 3,
                             scale=SCALE)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_decode_mla(q_lat[:, 0], q_rope[:, 0], lat[:, :, :256], kr, 3, scale=SCALE)
    with pytest.raises(NotImplementedError, match="forward only"):
        tfa.flash_decode_mla(q_lat[:, 0].requires_grad_(), q_rope[:, 0], lat, kr, 3,
                             scale=SCALE)
    assert tfa.decode_mla_plan(64, 32, 132) == (8, 8)  # B 8 x 4 row groups, Smax 4096
    assert tfa.decode_mla_plan(1, 4, 132) == (1, 1)
