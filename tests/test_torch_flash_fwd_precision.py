"""The numerical contract of the attention forward's tensor-core kernel
(``src/repro_torch/csrc/flash_fwd.cu``, bf16 inputs), held against the JAX
package's ``_fwd_call`` (its Pallas kernel in interpret mode) on the CPU.

A plain torch emulation of the kernel's arithmetic (64-key tiles, an online
softmax with f32 m, l and accumulator) is run beside the JAX kernel, which
is given the same 64-key tiles (``bk = 64``; a ragged causal S is padded
with keys no row sees) and f32 arrays, so that its o comes back in f32.

(a) ``lowp``: the product's A operand is bf16(q * scale), p goes into P V
    rounded to bf16 and l sums the unrounded f32 p. The emulation matches
    JAX within f32 summation noise: lse within 3 ds + (2n + 8) u (1 + |lse|),
    with ds the f32 error bound of each side's s = q.k (2 (hd + 2) u
    sum |a||k|) and u = 2^-24; o within (2 (n + 8) u + 2 ds) sum p|v| / l,
    plus one bf16 unit (2^-7 p|v| / l) for each p whose bf16 rounding that
    noise can flip (p within (2 ds + 8 u) p of a rounding boundary).
(b) bf16 inputs without ``lowp``: q.k unscaled, scale applied to s in f32,
    p split into hi = bf16(p) and lo = bf16(p - hi) with P V issued twice.
    The emulation matches JAX's f32 route within the bound the source
    states, 2^-16 sum p|v| / l, beside the f32 noise of 2n terms and the
    s bound above. Rounding p alone (``lowp``'s rule) does not fit it.
(c) ``lowp`` at hd 32 and 128, where scale is not a power of two, with an
    f32 q: two wrong routes miss (a)'s lse bound, so the test sees the
    rounding point. One is the no-``lowp`` route (bf16 q.k unscaled, then
    scale on s); the other rounds the f32 q to bf16 before scaling it.

(d) The f32 FFMA kernel (f32 inputs, with and without ``lowp``): a torch
    emulation of its decomposition (64-row blocks in the launch order of
    ``fwd_block``, the heaviest causal tiles first; one or two groups of
    warps taking the KV tiles alternately and merging at the end; an online
    softmax in the log2 domain, p = 2^(s log2 e - m log2 e)) matches JAX's
    f32 route within ``F32`` (2e-5), and its ``lowp`` route within (a)'s
    bounds. The host plan helpers (``fwd_block``, ``fwd_groups``) are
    checked on their own.

Inputs are drawn with numpy from a seed and fed to both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels.backend import divisor_block
from repro_torch.kernels import flash_attention as tfa

U = 2.0 ** -24      # f32 unit roundoff
SPLIT = 2.0 ** -16  # what the hi/lo split leaves of each element
BF16_UNIT = 2.0 ** -7  # one bf16 unit in the last place, relative, at most
TILE = 64           # keys per tile of the kernel
NEG_INF = -1e30

CASES = [  # Sq, Sk, hd, causal, q_offset
    (64, 64, 64, True, 0),
    (128, 128, 32, False, 0),
    (130, 130, 16, True, 0),    # ragged: the kernel masks the tail tile
    (64, 128, 128, True, 64),   # q_offset: a query chunk at the end
]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _operands(q, k, v, lowp: bool, route: str):
    """(A, K, V, s_mul): the operands of s = A K^T and P V, and the factor
    the kernel applies to s, for the kernel's route or a wrong one."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not lowp:
        return q, k, v, scale
    kc, vc = _bf16(k), _bf16(v)
    if route == "kernel":
        return _bf16(q * scale), kc, vc, 1.0
    if route == "unscaled":        # the no-lowp route on lowp's operands
        return _bf16(q), kc, vc, scale
    assert route == "round_q_first"
    return _bf16(_bf16(q) * scale), kc, vc, 1.0


def _emulate(q, k, v, *, causal: bool, q_offset: int, lowp: bool,
             route: str = "kernel", split: bool = True):
    """(o f32, lse, bounds) as flash_fwd_tc computes them: 64-key tiles, an
    online softmax, p into P V rounded to bf16 under lowp, else split into a
    hi/lo bf16 pair (``split``) or rounded once (``split=False``). ``bounds``
    holds the per-row sums the tolerances need."""
    a, kc, vc, s_mul = _operands(q, k, v, lowp, route)
    Sq, Sk = q.shape[2], k.shape[2]
    s = a @ kc.transpose(-1, -2)
    if s_mul != 1.0:
        s = s * s_mul
    if causal:
        seen = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + q_offset
        s = torch.where(seen, s, torch.full_like(s, -math.inf))
    # ds: the f32 error bound of each side's s
    ds = 2 * (q.shape[-1] + 2) * U * s_mul * (a.abs() @ kc.abs().transpose(-1, -2)).amax(-1)
    eps = (2 * ds + 8 * U)[..., None]
    m = torch.full(s.shape[:-1], NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], v.shape[-1])
    flippable = []  # p whose bf16 rounding the noise in s can move
    for t0 in range(0, Sk, TILE):
        st, vt = s[..., t0:t0 + TILE], vc[..., t0:t0 + TILE, :]
        mn = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - mn)
        p = torch.exp(st - mn[..., None])
        l = l * corr + p.sum(-1)
        hi = _bf16(p)
        flippable.append(_bf16(p * (1 - eps)) != _bf16(p * (1 + eps)))
        pv = hi @ vt
        if not lowp and split:
            pv = pv + _bf16(p - hi) @ vt
        acc = acc * corr[..., None] + pv
        m = mn
    lc = l.clamp_min(1e-30)
    o, lse = acc / lc[..., None], m + torch.log(lc)
    w = torch.exp(s - lse[..., None])  # softmax weights p / l
    flip = torch.where(torch.cat(flippable, -1), w, torch.zeros_like(w))
    bounds = {"mag": w @ vc.abs(), "flips": flip @ vc.abs(), "ds": ds, "n": Sk}
    return o, lse, bounds


def _jax_fwd(q, k, v, *, causal: bool, q_offset: int, lowp: bool):
    """JAX's ``_fwd_call`` on f32 arrays (o in f32) with the kernel's 64-key
    tiles; a causal Sk that 64 does not divide is padded with keys that no
    row sees."""
    Sq, Sk = q.shape[2], k.shape[2]
    pad = -Sk % TILE
    if pad:
        assert causal and Sk == Sq + q_offset, "padding is hidden only by the causal mask"
        k, v = (np.concatenate([x, np.zeros(x.shape[:2] + (pad, x.shape[3]), np.float32)],
                               axis=2) for x in (k, v))
    o, lse = jfa._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           q_offset=q_offset, bq=divisor_block(Sq, 128), bk=TILE,
                           interpret=True, lowp=lowp)
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))


def _inputs(seed, Sq, Sk, hd, bf16_q: bool = True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 2, Sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, Sk, hd)).astype(np.float32) for _ in range(2))
    as_bf16 = lambda x: _bf16(torch.from_numpy(x)).numpy()  # noqa: E731
    k, v = as_bf16(k), as_bf16(v)
    return (as_bf16(q) if bf16_q else q), k, v


def _lse_bound(lse, b):
    return 3 * b["ds"] + (2 * b["n"] + 8) * U * (1 + lse.abs())


def _lowp_o_bound(b):
    return (2 * (b["n"] + 8) * U + 2 * b["ds"][..., None]) * b["mag"] + BF16_UNIT * b["flips"]


def _split_o_bound(b):
    return (SPLIT + 2 * (2 * b["n"] + 8) * U + 2 * b["ds"][..., None]) * b["mag"]


def _check(name, err, bound):
    bad = err > bound
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {err.numel()} past the bound; worst err / "
        f"bound {float((err / bound.clamp_min(1e-30)).max()):.3g}")


@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", CASES)
def test_lowp_emulation_matches_jax(Sq, Sk, hd, causal, q_offset):
    q, k, v = _inputs(Sq + Sk + hd, Sq, Sk, hd)
    jo, jl = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, lowp=True)
    o, lse, b = _emulate(*map(torch.from_numpy, (q, k, v)), causal=causal,
                         q_offset=q_offset, lowp=True)
    _check("lse", (lse - jl).abs(), _lse_bound(lse, b))
    _check("o", (o - jo).abs(), _lowp_o_bound(b))


@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", CASES)
def test_split_emulation_matches_jax_within_the_stated_bound(Sq, Sk, hd, causal, q_offset):
    q, k, v = _inputs(Sq + Sk + hd + 1, Sq, Sk, hd)
    jo, jl = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, lowp=False)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    o, lse, b = _emulate(*args, causal=causal, q_offset=q_offset, lowp=False)
    bound = _split_o_bound(b)
    _check("lse", (lse - jl).abs(), _lse_bound(lse, b))
    _check("o", (o - jo).abs(), bound)
    hi_only, _, _ = _emulate(*args, causal=causal, q_offset=q_offset, lowp=False,
                             split=False)
    assert bool(((hi_only - jo).abs() > bound).any()), \
        "rounding p to bf16 alone fits the split's bound"


@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", [(128, 128, 32, False, 0),
                                                      (64, 128, 128, True, 64)])
def test_lowp_rounding_point_is_visible(Sq, Sk, hd, causal, q_offset):
    q, k, v = _inputs(Sq + Sk + hd + 2, Sq, Sk, hd, bf16_q=False)
    _, jl = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, lowp=True)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    kw = dict(causal=causal, q_offset=q_offset, lowp=True)
    _, lse, b = _emulate(*args, **kw)
    bound = _lse_bound(lse, b)
    _check("lse", (lse - jl).abs(), bound)
    for route in ("unscaled", "round_q_first"):
        _, wrong, _ = _emulate(*args, route=route, **kw)
        assert bool(((wrong - jl).abs() > bound).any()), f"route {route} fits the bound"


# ---------------------------------------------------------------------------
# (d) the f32 FFMA kernel
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
F32 = dict(rtol=2e-5, atol=2e-5)


def _emulate_ffma(q, k, v, *, causal: bool, q_offset: int, lowp: bool, groups: int):
    """(o, lse) as flash_fwd_ffma computes them: a block of 64 query rows at
    a time in launch order; group g of ``groups`` takes KV tiles g, g +
    groups, ... with its own online softmax (f32 m, l, acc; p = 2^(s log2 e
    - m log2 e), masked keys -inf, p into P V rounded to bf16 under lowp);
    the groups merge in order at the end."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    a = q.reshape(B * H, Sq, hd) * (1.0 / math.sqrt(hd))
    kc, vc = k.reshape(B * H, Sk, hd), v.reshape(B * H, Sk, hd)
    if lowp:
        a, kc, vc = _bf16(a), _bf16(kc), _bf16(vc)
    n_q, BH = -(-Sq // TILE), B * H
    o = torch.empty(BH, Sq, hd)
    lse = torch.empty(BH, Sq)
    for block in range(n_q * BH):
        tile, bh = tfa.fwd_block(block, n_q, BH)
        r0, r1 = tile * TILE, min(tile * TILE + TILE, Sq)
        n_kv = -(-Sk // TILE)
        if causal:
            last = r1 - 1 + q_offset
            n_kv = 0 if last < 0 else min(n_kv, last // TILE + 1)
        rows = torch.arange(r0, r1)[:, None]
        states = []
        for grp in range(groups):
            m = torch.full((r1 - r0,), NEG_INF)
            l = torch.zeros(r1 - r0)
            acc = torch.zeros(r1 - r0, hd)
            for j in range(grp, n_kv, groups):
                keys = torch.arange(j * TILE, min(j * TILE + TILE, Sk))
                s = a[bh, r0:r1] @ kc[bh, keys].T
                if causal:
                    s = torch.where(keys[None, :] <= rows + q_offset, s,
                                    torch.full_like(s, -math.inf))
                mn = torch.maximum(m, s.amax(-1))
                corr = torch.exp2((m - mn) * LOG2E)
                p = torch.exp2(s * LOG2E - (mn * LOG2E)[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + (_bf16(p) if lowp else p) @ vc[bh, keys]
                m = mn
            states.append((m, l, acc))
        m, l, acc = states[0]
        for m1, l1, acc1 in states[1:]:
            mn = torch.maximum(m, m1)
            c0, c1 = torch.exp2((m - mn) * LOG2E), torch.exp2((m1 - mn) * LOG2E)
            l, acc, m = l * c0 + l1 * c1, acc * c0[:, None] + acc1 * c1[:, None], mn
        lc = l.clamp_min(1e-30)
        o[bh, r0:r1] = acc / lc[:, None]
        lse[bh, r0:r1] = m + torch.log(lc)
    return o.reshape(B, H, Sq, hd), lse.reshape(B, H, Sq)


def _f32_inputs(seed, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 2, Sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, Sk, hd)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", CASES)
def test_ffma_emulation_matches_jax(Sq, Sk, hd, causal, q_offset, groups):
    q, k, v = _f32_inputs(Sq + Sk + hd + 3, Sq, Sk, hd)
    jo, jl = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, lowp=False)
    o, lse = _emulate_ffma(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           q_offset=q_offset, lowp=False, groups=groups)
    torch.testing.assert_close(o, jo, **F32)
    torch.testing.assert_close(lse, jl, **F32)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", CASES)
def test_ffma_lowp_emulation_matches_jax(Sq, Sk, hd, causal, q_offset, groups):
    """Under lowp one group of warps keeps the tensor-core kernel's rounding
    points on f32 inputs, so (a)'s bounds hold for it. Two groups round p
    against each group's own running max, as JAX would with other tiles: o
    within one bf16 unit of p |v| / l (the BF16 tolerance, 5e-2, of
    tests/test_kernels.py), lse, which sums the unrounded p, within (a)'s."""
    q, k, v = _inputs(Sq + Sk + hd + 4, Sq, Sk, hd, bf16_q=False)
    jo, jl = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, lowp=True)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    o, lse = _emulate_ffma(*args, causal=causal, q_offset=q_offset, lowp=True, groups=groups)
    _, _, b = _emulate(*args, causal=causal, q_offset=q_offset, lowp=True)
    _check("lse", (lse - jl).abs(), _lse_bound(lse, b))
    if groups == 1:
        _check("o", (o - jo).abs(), _lowp_o_bound(b))
    else:
        torch.testing.assert_close(o, jo, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("n_q,BH", [(1, 1), (8, 32), (8, 128), (3, 5), (1, 65536)])
def test_fwd_block_order_is_heaviest_first(n_q, BH):
    """Every (query tile, b*h) exactly once, and no causal block with more KV
    tiles launches after one with fewer."""
    blocks = [tfa.fwd_block(b, n_q, BH) for b in range(n_q * BH)]
    assert sorted(blocks) == [(t, h) for t in range(n_q) for h in range(BH)]
    tiles = [t for t, _ in blocks]  # a causal block of tile t has t + 1 KV tiles
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("blocks,hd,sms,want", [
    (96, 64, 132, 2),     # B1 H32 S 192: the serve prefills
    (160, 64, 132, 2),    # S 320
    (256, 64, 132, 2),    # S 512: 256 blocks, 264 slots of two an SM
    (264, 64, 132, 1),
    (1024, 64, 132, 1),   # the train step, B4 S512
    (96, 128, 132, 1),    # hd 128: two groups' rings do not fit
    (4, 16, 132, 2),
])
def test_fwd_groups(blocks, hd, sms, want):
    assert tfa.fwd_groups(blocks, hd, sms) == want
