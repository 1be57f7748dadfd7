"""The two numerical facts the attention backward's tensor-core kernels
(``src/repro_torch/csrc/flash_bwd.cu``) rest on, held against the JAX
package on the CPU.

(a) With ``lowp`` the wrapper rounds f32 inputs to bf16 with
    ``Tensor.to(torch.bfloat16)``; the reference rounds its dot inputs with
    ``astype(jnp.bfloat16)``. The two must agree bit for bit, ties included.
(b) With bf16 inputs and no ``lowp`` the kernels keep p and ds f32 by
    splitting each into hi = bf16(x) and lo = bf16(x - hi) and issuing the
    product twice. A plain torch emulation of that rule must match the
    f32 gradients of the JAX ``_flash_mha`` backward (its Pallas kernels in
    interpret mode) within the bound the source states: 2^-16 sum |x||y|
    per output (times scale for dq and dk), beside the f32 summation noise
    of n terms, n u sum |x||y| with u = 2^-24, on each side. The rounding
    that ``lowp`` does (hi alone) must not fit that bound for any of dq, dk
    and dv.

Inputs are drawn with numpy from a seed and fed to both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels.backend import divisor_block

U = 2.0 ** -24      # f32 unit roundoff
SPLIT = 2.0 ** -16  # what the hi/lo split leaves of each element


# ---------------------------------------------------------------------------
# (a) f32 -> bf16 rounding
# ---------------------------------------------------------------------------


def _f32_cases(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "normal":  # values over many binades
        return (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    if kind == "ties":    # exactly halfway between two bf16 values, even and odd
        sign = rng.integers(0, 2, 4096, dtype=np.uint32)
        exponent = rng.integers(1, 255, 4096, dtype=np.uint32)
        mantissa = rng.integers(0, 128, 4096, dtype=np.uint32)
        upper = (sign << 15) | (exponent << 7) | mantissa
        return ((upper << 16) | np.uint32(0x8000)).view(np.float32)
    # edges: zeros, subnormals, the largest finite values (round to inf),
    # infinities and values one f32 ulp either side of a tie
    bits = np.array([0x00000000, 0x80000000, 0x00000001, 0x00008000, 0x00018000,
                     0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
                     0x7F800000, 0xFF800000, 0x3F808000, 0x3F808001, 0x3F807FFF,
                     0x3F818000, 0xBF818000], dtype=np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "edges"])
def test_torch_bf16_cast_matches_jax_bit_for_bit(kind):
    x = _f32_cases(kind)
    got = torch.from_numpy(x.copy()).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (b) the split products against the JAX backward
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_bwd(q, k, v, do, o, lse, causal: bool, q_offset: int, split: bool):
    """dq, dk, dv as the tensor-core kernels compute them for bf16 inputs
    without lowp (``split``), or with p and ds rounded once (hi only); plus
    the sums of |x||y| that bound each output."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    Sq, Sk = q.shape[2], k.shape[2]
    s = scale * (q @ k.transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    if causal:
        keep = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + q_offset
        p = torch.where(keep, p, torch.zeros_like(p))
    delta = (do * o).sum(-1)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    (ds_hi, ds_lo), (p_hi, p_lo) = _split(ds), _split(p)
    if not split:
        ds_lo, p_lo = torch.zeros_like(ds), torch.zeros_like(p)
    dq = scale * (ds_hi @ k + ds_lo @ k)
    dk = scale * (ds_hi.transpose(-1, -2) @ q + ds_lo.transpose(-1, -2) @ q)
    dv = p_hi.transpose(-1, -2) @ do + p_lo.transpose(-1, -2) @ do
    mag = (scale * (ds.abs() @ k.abs()), scale * (ds.abs().transpose(-1, -2) @ q.abs()),
           p.abs().transpose(-1, -2) @ do.abs())
    return (dq, dk, dv), mag


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,q_offset", [
    (1, 2, 64, 64, 32, True, 0),
    (2, 2, 37, 37, 16, True, 0),     # ragged S: JAX takes 37-row blocks
    (1, 3, 48, 80, 64, False, 0),    # Sq != Sk
    (1, 2, 24, 56, 32, True, 32),    # q_offset: a query chunk at the end
])
def test_split_products_match_jax_within_the_stated_bound(B, H, Sq, Sk, hd, causal,
                                                          q_offset):
    rng = np.random.default_rng(Sq + Sk + hd)
    q, do = (rng.standard_normal((B, H, Sq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, Sk, hd)).astype(np.float32) for _ in range(2))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    bq, bk = divisor_block(Sq, 128), divisor_block(Sk, 128)
    o, (_, _, _, _, lse) = jfa._flash_mha_fwd(jq, jk, jv, causal, q_offset, bq, bk,
                                              True, False)
    # the f32 gradients of _flash_mha's backward, before its cast to bf16
    want = [np.asarray(g) for g in jfa._bwd_call(
        jq, jk, jv, o, lse, jdo, causal=causal, q_offset=q_offset, bq=bq, bk=bk,
        interpret=True, lowp=False)]

    as_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))  # noqa: E731
    args = (as_t(jq), as_t(jk), as_t(jv), as_t(jdo), as_t(o), as_t(lse))
    got, mag = _split_bwd(*args, causal, q_offset, split=True)
    hi_only, _ = _split_bwd(*args, causal, q_offset, split=False)
    # n terms in each output's sum (twice for the split), on each side
    n = {"dq": 2 * Sk, "dk": 2 * Sq, "dv": 2 * Sq}
    lowp_fits = []
    for name, g, h, m, w in zip(("dq", "dk", "dv"), got, hi_only, mag, want):
        bound = (SPLIT + 2 * n[name] * U) * m.numpy()
        err = np.abs(g.numpy() - w)
        assert (err <= bound).all(), (
            f"{name}: {int((err > bound).sum())} elements past the bound; "
            f"worst err / bound {float((err / np.maximum(bound, 1e-30)).max()):.3g}")
        lowp_fits.append(bool((np.abs(h.numpy() - w) <= bound).all()))
    assert not any(lowp_fits), f"lowp rounding fits the bound (dq, dk, dv): {lowp_fits}"
