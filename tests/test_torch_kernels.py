"""The port's flash kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions
(``repro_torch/kernels/ref.py``) and the JAX kernels run in Pallas interpret
mode, as ``tests/test_kernels.py`` runs them. Inputs are drawn with numpy
from a seed and fed to both. Tolerances are those of
``tests/test_kernels.py``: 2e-5 at f32, 5e-2 with bf16 dot inputs.

The CUDA kernels themselves are held against the plain versions on a card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import backend, ops, ref
from repro_torch.kernels import flash_attention as tfa

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(torch.as_tensor(x).float().numpy()) if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32)


# --- flash forward (o and lse) ------------------------------------------------

FWD_CASES = [  # B, H, Sq, Sk, hd, causal, q_offset
    (1, 4, 16, 16, 32, True, 0),
    (2, 3, 37, 37, 16, True, 0),      # prime S: 1-row blocks in the JAX kernel
    (1, 2, 64, 64, 64, False, 0),
    (2, 2, 16, 48, 16, True, 32),     # q_offset: a query chunk at the end
    (1, 2, 61, 61, 16, False, 0),     # prime S, full attention
]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,q_offset", FWD_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_flash_fwd_lse_matches_jax(B, H, Sq, Sk, hd, causal, q_offset, lowp):
    q, k, v = _rand(Sq + Sk + hd, (B, H, Sq, hd), (B, H, Sk, hd), (B, H, Sk, hd))
    jo, jl = jfa.flash_attention_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         q_offset=q_offset, lowp=lowp)
    to, tl = tfa.flash_attention_fwd_lse(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), causal=causal,
                                         q_offset=q_offset, lowp=lowp)
    tol = BF16 if lowp else F32
    np.testing.assert_allclose(_np(to), np.asarray(jo), **tol)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)


@pytest.mark.parametrize("B,S,H,K,hd", [(1, 16, 4, 4, 32), (2, 37, 8, 4, 16),
                                        (1, 64, 8, 2, 64), (2, 29, 4, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_gqa_matches_jax(B, S, H, K, hd, causal):
    q, k, v = _rand(S * H, (B, S, H, hd), (B, S, K, hd), (B, S, K, hd))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_flash_attention_bf16_inputs_and_env_toggle(monkeypatch):
    """bf16 inputs, and REPRO_ATTN_BF16=1 read at call time by both packages."""
    q, k, v = _rand(5, (1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    monkeypatch.setenv("REPRO_ATTN_BF16", "1")
    want = jops.flash_attention(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), causal=True)
    got = ops.flash_attention(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(k).bfloat16(),
                              torch.from_numpy(v).bfloat16(), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **BF16)
    assert backend.attn_bf16() and not backend.attn_bf16(False)


# --- flash decode ---------------------------------------------------------------

DEC_CASES = [  # B, K, G, hd, hdv, Smax, lengths, scale
    (4, 2, 4, 16, 16, 32, [0, 1, 17, 33], None),   # idle row, Smax + 1
    (3, 1, 8, 32, 16, 40, [40, 5, 0], 0.3),        # hdv != hd, explicit scale
    (2, 2, 2, 64, 64, 24, [24, 25], None),
]


@pytest.mark.parametrize("B,K,G,hd,hdv,Smax,lengths,scale", DEC_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_flash_decode_matches_jax(B, K, G, hd, hdv, Smax, lengths, scale, lowp):
    q, k, v = _rand(B * Smax, (B, K, G, hd), (B, Smax, K, hd), (B, Smax, K, hdv))
    lens = np.asarray(lengths, np.int32)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), scale=scale, lowp=lowp)
    got = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lens),
                           scale=scale, lowp=lowp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **(BF16 if lowp else F32))
    idle = lens == 0
    assert not np.any(_np(got)[idle]), "a length-0 row must return zeros"


@pytest.mark.parametrize("lengths", [[3, 9, 16], 7])
def test_ops_decode_attention_matches_jax(lengths):
    B, Smax, H, K, hd = 3, 16, 8, 2, 16
    q, k, v = _rand(11, (B, 1, H, hd), (B, Smax, K, hd), (B, Smax, K, hd))
    lens = np.asarray(lengths, np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# --- the wrappers' contract -----------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v = (torch.zeros(1, 2, 8, 16) for _ in range(3))
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_fwd_lse(q, k, torch.zeros(1, 2, 8, 8))
    with pytest.raises(NotImplementedError, match="forward only"):
        tfa.flash_attention_fwd_lse(q.requires_grad_(), k, v)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfa.flash_decode(torch.zeros(1, 1, 2, 16, dtype=torch.float16),
                         torch.zeros(1, 4, 1, 16, dtype=torch.float16),
                         torch.zeros(1, 4, 1, 16, dtype=torch.float16), 2)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    tfa.reset_launches()
    q, k, v = _rand(3, (1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))
    o, lse = tfa.flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)))
    ro, rl = ref.ref_flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert tfa.launches == {"flash_fwd": 0, "flash_decode": 0}


def test_device_policy():
    assert backend.auto_attn_impl(128, device="cpu") == "naive"
    assert backend.auto_attn_impl(2048, device="cpu") == "chunked"
    assert backend.auto_attn_impl(2048, device="cuda") == "pallas"
    assert backend.auto_decode_impl(256, device="cuda") == "naive"
    assert backend.auto_decode_impl(1024, device="cpu") == "naive"
    assert backend.auto_decode_impl(1024, device="cuda") == "pallas"
    assert backend.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            backend.resolve_device("cuda")
