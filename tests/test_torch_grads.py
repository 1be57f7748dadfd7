"""Gradients of the port's attention against the JAX package's.

On the CPU the port's ``_FlashMHA`` runs the plain versions of its kernels
(``ref_flash_attention_fwd`` and ``ref_flash_attention_bwd``); the JAX side
takes ``jax.grad`` through ``flash_attention_mha``'s custom_vjp with its
Pallas kernels in interpret mode, as ``tests/test_kernel_grads.py`` runs
them. Inputs and the cotangent weights are drawn with numpy from a seed and
fed to both. Tolerances: 2e-5 at f32 (the two sides differ only in the
order of f32 sums) and 5e-2 with bf16 dot inputs (``lowp``), those of
``tests/test_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_backward as tfb
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)

# the sweep of tests/test_kernel_grads.py: B, Sq, Sk, H, K, hd
SWEEP = [
    (1, 16, 16, 4, 4, 32),     # MHA
    (2, 37, 37, 8, 4, 16),     # GQA, ragged S
    (1, 128, 128, 8, 2, 64),   # GQA at one default JAX block
    (1, 256, 256, 4, 1, 32),   # MQA, several KV tiles (causal skipping live)
    (1, 48, 112, 4, 2, 32),    # Sq != Sk
]


def _inputs(seed, B, Sq, Sk, H, K, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, w


def _jax_grads(fn, q, k, v, w):
    def loss(q, k, v):
        return (fn(q, k, v).astype(jnp.float32) * w).sum()
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_grads(fn, q, k, v, w):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(
        (out.float() * torch.from_numpy(w)).sum(), leaves)]


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", SWEEP)
@pytest.mark.parametrize("causal,lowp", [(True, False), (False, False), (True, True)])
def test_flash_attention_grads_match_jax(B, Sq, Sk, H, K, hd, causal, lowp):
    """Through the GQA broadcast into the MHA kernel's custom gradient on
    both sides; the bf16 toggle on the causal path (the training one)."""
    q, k, v, w = _inputs(Sq + Sk + H, B, Sq, Sk, H, K, hd)

    def jfn(q, k, v):
        if K != H:
            G = H // K
            k = jnp.repeat(k, G, axis=2)
            v = jnp.repeat(v, G, axis=2)
        out = jfa.flash_attention_mha(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                                      v.transpose(0, 2, 1, 3), causal=causal,
                                      lowp=lowp)
        return out.transpose(0, 2, 1, 3)

    def tfn(q, k, v):
        if K != H:  # the same broadcast as ops.flash_attention
            G = H // K
            k = k[:, :, :, None, :].expand(B, Sk, K, G, hd).reshape(B, Sk, H, hd)
            v = v[:, :, :, None, :].expand(B, Sk, K, G, hd).reshape(B, Sk, H, hd)
        out = tfa.flash_attention_mha(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal, lowp=lowp)
        return out.transpose(1, 2)

    tol = BF16 if lowp else F32
    for name, a, b in zip("qkv", _torch_grads(tfn, q, k, v, w),
                          _jax_grads(jfn, q, k, v, w)):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"d{name}")


BWD_CASES = [  # B, H, Sq, Sk, hd, causal, q_offset
    (1, 2, 16, 16, 32, True, 0),
    (2, 3, 37, 37, 16, True, 0),
    (1, 2, 64, 64, 64, False, 0),
    (2, 2, 16, 48, 16, True, 32),     # q_offset: a query chunk at the end
    # the edges of the card kernels' 64-row, 64-key tiles (tests/test_torch_cuda.py)
    (1, 1, 1, 1, 64, True, 0),        # one row, one key
    (1, 2, 63, 63, 32, True, 0),      # one below a tile
    (1, 2, 65, 65, 16, True, 0),      # one above a tile
    (1, 1, 65, 1, 128, False, 0),     # many rows, one key
    (1, 1, 1, 65, 16, True, 64),      # one row at the end of 65 keys
    (1, 2, 17, 100, 64, True, 83),    # Sq != Sk, q_offset past the first tile
]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,q_offset", BWD_CASES)
@pytest.mark.parametrize("lowp", [False, True])
def test_ref_flash_attention_bwd_matches_bwd_call(B, H, Sq, Sk, hd, causal,
                                                  q_offset, lowp):
    """The plain dq/dkv math against the reference's ``_bwd_call`` (its
    ``_dq_kernel`` and ``_dkv_kernel``), fed the same o and lse."""
    rng = np.random.default_rng(Sq * Sk + hd)
    q, do = (rng.standard_normal((B, H, Sq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, Sk, hd)).astype(np.float32) for _ in range(2))
    jo, jl = jfa.flash_attention_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, q_offset=q_offset, lowp=lowp)
    want = jfa._bwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
                         jnp.asarray(do), causal=causal, q_offset=q_offset,
                         bq=Sq, bk=Sk, interpret=True, lowp=lowp)
    got = ref.ref_flash_attention_bwd(
        *(torch.tensor(np.asarray(x)) for x in (q, k, v, jo, jl, do)),
        causal=causal, q_offset=q_offset, lowp=lowp)
    # the split entry points the kernels replace give the same numbers
    delta = torch.from_numpy(np.asarray(jo) * do).sum(-1)
    args = [torch.tensor(np.asarray(x)) for x in (q, k, v, do, jl)] + [delta]
    dq = tfb.flash_bwd_dq(*args, causal=causal, q_offset=q_offset, lowp=lowp)
    dk, dv = tfb.flash_bwd_dkv(*args, causal=causal, q_offset=q_offset, lowp=lowp)
    tol = BF16 if lowp else F32
    for name, a, s, b in zip("qkv", got, (dq, dk, dv), want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol, err_msg=f"d{name}")
        np.testing.assert_allclose(s.numpy(), a.numpy(), **F32, err_msg=f"split d{name}")


def test_gqa_broadcast_sums_dk_dv_over_the_head_group():
    """``ops.flash_attention`` broadcasts K KV heads to H query heads with
    expand/reshape; autograd's transpose of it sums dk and dv over each
    group of G query heads, as JAX's broadcast transpose does."""
    B, S, H, K, hd = 2, 24, 6, 2, 16
    q, k, v, w = _inputs(5, B, S, S, H, K, hd)
    dq, dk, dv = _torch_grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=True),
                              q, k, v, w)
    G = H // K
    mq, mk, mv = _torch_grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=True),
                              q, np.repeat(k, G, axis=2), np.repeat(v, G, axis=2), w)
    np.testing.assert_allclose(dq, mq, **F32)
    np.testing.assert_allclose(dk, mk.reshape(B, S, K, G, hd).sum(3), **F32)
    np.testing.assert_allclose(dv, mv.reshape(B, S, K, G, hd).sum(3), **F32)
    jq, jk, jv = _jax_grads(lambda a, b, c: jops.flash_attention(a, b, c, causal=True),
                            q, k, v, w)
    for a, b in ((dq, jq), (dk, jk), (dv, jv)):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", [(2, 37, 37, 8, 4, 16), (1, 48, 112, 4, 2, 32)])
def test_attention_impl_grads_match_jax(impl, B, Sq, Sk, H, K, hd):
    q, k, v, w = _inputs(11 + Sq, B, Sq, Sk, H, K, hd)
    kw = dict(causal=True, impl=impl, chunk=16)
    got = _torch_grads(lambda a, b, c: tattn.attention_impl(a, b, c, **kw), q, k, v, w)
    want = _jax_grads(lambda a, b, c: jattn.attention_impl(a, b, c, **kw), q, k, v, w)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, **F32, err_msg=f"{impl} d{name}")


def test_forward_only_wrappers_refuse_grad():
    x = torch.zeros(1, 2, 4, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        tfa.flash_attention_fwd_lse(x, x, x)
    with pytest.raises(NotImplementedError, match="forward only"):
        tfa.flash_decode(torch.zeros(1, 1, 2, 16, requires_grad=True),
                         torch.zeros(1, 4, 1, 16), torch.zeros(1, 4, 1, 16), 2)
    with torch.no_grad():
        tfa.flash_attention_fwd_lse(x, x, x)
