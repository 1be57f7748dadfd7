"""The speculative verify kernels' split of the keys across blocks
(``src/repro_torch/csrc/flash_decode_spec.cu``), held against the JAX
package's ``flash_decode_spec`` and ``flash_decode_spec_paged`` (their
Pallas kernels in interpret mode) on the CPU.

A torch emulation follows the kernel's order of operations: the wrapper's
plan (``spec_plan``) cuts each (b, kv head)'s R = S*G rows into row blocks
of ``SPEC_ROWS`` rows and its keys into splits of whole table
entries (pool blocks, or 64-position blocks of the contiguous cache); a
block's range ends at its row block's last causal limit and is staged in
chunks of up to 64 positions (whole pool blocks where bs <= 64); each of
four warps keeps its own online softmax per row in the log2 domain
(p = 2^(s log2 e - m log2 e)) over its 16 keys of every chunk, each row
masked at its own limit min(base + qi + 1, capacity); the warps merge at the
end of the split, and the splits' f32 partials merge in split order (on the
card, in the last of the row block's blocks to finish). Groups of 4 rows
change only the order in which a warp visits its rows, not any sum.
Against JAX: 2e-5 in f32 (summation order only), 5e-2 under ``lowp`` (bf16
dot inputs, the tolerance of ``tests/test_kernels.py``). The plan helpers
are checked on their own.

Inputs are drawn with numpy from a seed and fed to both packages.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa

LOG2E = 1.4426950408889634
NEG_INF = -1e30
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
WARPS, WARP_KEYS = 4, 16


def _dot(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if lowp else x


def _online(state, s, v, lowp):
    """One warp's step of the online softmax over its keys: s (rows, n) with
    masked entries at -inf, v (n, hdv)."""
    m, l, acc = state
    mn = torch.maximum(m, s.amax(-1))
    corr = torch.exp2((m - mn) * LOG2E)
    p = torch.exp2(s * LOG2E - (mn * LOG2E)[:, None])  # masked: 2^-inf = 0
    return mn, l * corr + p.sum(-1), acc * corr[:, None] + _dot(p, lowp) @ v


def _merge(states):
    """Merge (m, l, acc) partials in order."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(li * torch.exp2((m - mx) * LOG2E) for m, li, _ in states)
    acc = sum(a * torch.exp2((m - mx) * LOG2E)[:, None] for m, _, a in states)
    return mx, l, acc


def _emulate(q, k, v, table, lengths, *, scale, lowp, sms):
    """(out, (row blocks, splits)) as flash_decode_spec (``table`` None) or
    flash_decode_spec_paged computes them on a card of ``sms`` SMs."""
    B, K, S, G, hd = q.shape
    hdv, R = v.shape[-1], S * G
    if table is None:
        cap = k.shape[1]
        T, bs = -(-cap // tfa.DECODE_CHUNK), tfa.DECODE_CHUNK
        rows_of = [torch.arange(cap) for _ in range(B)]  # sequence b's own rows
        kc, vc = _dot(k, lowp), _dot(v, lowp)
    else:
        NB, bs, T = k.shape[0], k.shape[1], table.shape[1]
        cap = T * bs
        table = table.clamp(0, NB - 1)
        pos = torch.arange(cap)
        rows_of = [table[b, pos // bs] * bs + pos % bs for b in range(B)]  # pool rows
        kc = _dot(k, lowp).reshape(1, NB * bs, K, hd).expand(B, -1, -1, -1)
        vc = _dot(v, lowp).reshape(1, NB * bs, K, hdv).expand(B, -1, -1, -1)
    n_rb, splits, bps = tfa.spec_plan(B, K, R, T, bs, sms)
    RB = tfa.SPEC_ROWS
    ch = (tfa.DECODE_CHUNK // bs) * bs if bs <= tfa.DECODE_CHUNK else tfa.DECODE_CHUNK
    span = bps * bs
    qs = _dot(q.reshape(B, K, R, hd) * scale, lowp)
    out = torch.zeros(B, K, R, hdv)
    for b in range(B):
        base = min(max(int(lengths[b]), 0), cap)
        lim = torch.clamp(base + torch.arange(R) // G + 1, max=cap)  # each row's limit
        for kh in range(K):
            krows, vrows = kc[b, rows_of[b], kh], vc[b, rows_of[b], kh]
            for rb in range(n_rb):
                r0, r1 = rb * RB, min((rb + 1) * RB, R)
                rl = lim[r0:r1]
                end = int(rl[-1])
                partials = []
                for split in range(splits):
                    p0, p1 = split * span, min((split + 1) * span, end)
                    if p0 >= p1:
                        continue
                    n = r1 - r0
                    warps = [(torch.full((n,), NEG_INF), torch.zeros(n), torch.zeros(n, hdv))
                             for _ in range(WARPS)]
                    for c0 in range(p0, p1, ch):
                        c1 = min(c0 + ch, p1)
                        for w in range(WARPS):
                            k0, k1 = c0 + w * WARP_KEYS, min(c0 + (w + 1) * WARP_KEYS, c1)
                            if k0 < k1:
                                s = qs[b, kh, r0:r1] @ krows[k0:k1].T
                                s = torch.where(torch.arange(k0, k1)[None] < rl[:, None], s,
                                                torch.tensor(-math.inf))
                                warps[w] = _online(warps[w], s, vrows[k0:k1], lowp)
                    partials.append(_merge(warps))
                _, l, acc = _merge(partials)
                out[b, kh, r0:r1] = acc / l.clamp_min(1e-30)[:, None]
    return out.reshape(B, K, S, G, hdv), (n_rb, splits)


CASES = [  # layout, B, K, S, G, hd, hdv, bs (paged), capacity, base lengths
    ("contig", 4, 2, 5, 4, 64, 64, None, 640, [0, 1, 300, 640]),  # the serve shape's S, G; idle slot
    ("contig", 3, 1, 17, 4, 16, 16, None, 200, [0, 150, 190]),    # R = 68: 3 row blocks; past cap
    ("contig", 2, 2, 2, 8, 32, 128, None, 130, [5, 129]),         # hdv 128
    ("contig", 3, 2, 1, 1, 128, 16, None, 100, [0, 37, 100]),
    ("paged", 4, 2, 5, 4, 64, 64, 16, 640, [0, 1, 300, 640]),
    ("paged", 3, 1, 17, 4, 16, 16, 5, 200, [0, 150, 190]),        # bs 5: 60-position chunks
    ("paged", 3, 2, 2, 8, 32, 128, 4, 132, [5, 131, 132]),
    ("paged", 3, 2, 1, 1, 128, 16, 16, 112, [0, 37, 112]),
]


@functools.cache
def _case(i: int, lowp: bool):
    """Case ``i``'s numpy inputs and the JAX kernel's output."""
    layout, B, K, S, G, hd, hdv, bs, cap, lengths = CASES[i]
    rng = np.random.default_rng(100 + i)
    q = rng.standard_normal((B, K, S, G, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    if layout == "contig":
        k = rng.standard_normal((B, cap, K, hd)).astype(np.float32)
        v = rng.standard_normal((B, cap, K, hdv)).astype(np.float32)
        arrays = (q, k, v, None, lens)
        want = jfa.flash_decode_spec(*map(jnp.asarray, (q, k, v, lens)), lowp=lowp)
    else:
        T = cap // bs
        NB = B * T + 2
        k = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
        v = rng.standard_normal((NB, bs, K, hdv)).astype(np.float32)
        table = rng.integers(-2, NB + 2, (B, T)).astype(np.int32)  # clamped by both
        arrays = (q, k, v, table, lens)
        want = jfa.flash_decode_spec_paged(*map(jnp.asarray, (q, k, v, table, lens)),
                                           lowp=lowp)
    return arrays, np.asarray(want)


@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-S{c[3]}G{c[4]}hd{c[5]}hdv{c[6]}" for c in CASES])
def test_split_emulation_matches_jax(i, lowp, sms):
    (q, k, v, table, lens), want = _case(i, lowp)
    hd = q.shape[-1]
    got, (n_rb, splits) = _emulate(
        *(None if a is None else torch.from_numpy(a) for a in (q, k, v, table, lens)),
        scale=1.0 / math.sqrt(hd), lowp=lowp, sms=sms)
    S, G, cap = q.shape[2], q.shape[3], CASES[i][8]
    assert n_rb == -(-S * G // tfa.SPEC_ROWS)
    if sms == 132 and cap >= 640:
        assert splits > 2
    np.testing.assert_allclose(got.numpy(), want, **(BF16 if lowp else F32))


@pytest.mark.parametrize("B,K,R,T,bs,want", [
    (8, 8, 20, 16, 64, (1, 8, 2)),     # the contiguous serve run: Smax 1024, 8 splits of 128
    (8, 8, 20, 64, 16, (1, 8, 8)),     # the paged serve run: 64 blocks of 16
    (8, 8, 20, 128, 64, (1, 9, 15)),   # contiguous Smax 8192
    (8, 8, 68, 16, 64, (3, 3, 6)),     # R = 68: three row blocks, fewer splits
    (8, 8, 24, 16, 64, (1, 8, 2)),     # a full row block
    (8, 8, 25, 16, 64, (2, 4, 4)),     # one row past it
    (65536, 1, 4, 2, 4, (1, 1, 2)),    # rows enough to fill the card
])
def test_spec_plan(B, K, R, T, bs, want):
    assert tfa.spec_plan(B, K, R, T, bs, 132) == want


@pytest.mark.parametrize("Smax", [1, 5, 63, 64, 65, 200, 1024, 8191])
def test_contiguous_plan_covers_each_position_once(Smax):
    """The contiguous cache as a table of ceil(Smax / 64) blocks of 64
    positions: for every row count, the splits' ranges, cut at Smax, cover
    each position exactly once, and the last split is live."""
    T = -(-Smax // tfa.DECODE_CHUNK)
    for rows in (1, 7, 64, 528, 100000):
        splits, bps = tfa.decode_paged_plan(T, tfa.DECODE_CHUNK, rows, 132)
        span = bps * tfa.DECODE_CHUNK
        covered = np.zeros(Smax, np.int64)
        for s in range(splits):
            covered[s * span:min((s + 1) * span, Smax)] += 1
        assert (covered == 1).all(), (Smax, rows, splits, bps)
        assert (splits - 1) * span < Smax
