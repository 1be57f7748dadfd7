"""The decode kernel's split of the keys across blocks
(``src/repro_torch/csrc/flash_decode_paged.cu``, both address maps), held
against the JAX package's ``flash_decode_paged`` and ``flash_decode`` (their
Pallas kernels in interpret mode) on the CPU.

A torch emulation follows the kernel's order of operations: the wrapper's
plan (``decode_paged_plan``; ``decode_plan`` for the contiguous cache, read
as a table of 64-position blocks) cuts each row's table into splits of
whole table entries; a split stages its positions in chunks of up to 64
(whole pool blocks where bs <= 64); each of four warps keeps its own online
softmax in the log2 domain (p = 2^(s log2 e - m log2 e)) over its 16 keys
of every chunk; the warps merge at the end of the split, and the splits'
f32 partials merge in split order (on the card, in the last of the row's
blocks to finish).
Against JAX: 2e-5 in f32 (summation order only), 5e-2 under ``lowp`` (bf16
dot inputs, the tolerance of ``tests/test_kernels.py``). The plan helpers
are checked on their own.

Inputs are drawn with numpy from a seed and fed to both packages.
"""
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
    """One warp's step of the online softmax over its keys: s (G, n), v (n, hdv)."""
    m, l, acc = state
    mn = torch.maximum(m, s.amax(-1))
    corr = torch.exp2((m - mn) * LOG2E)
    p = torch.exp2(s * LOG2E - (mn * LOG2E)[:, None])
    return mn, l * corr + p.sum(-1), acc * corr[:, None] + _dot(p, lowp) @ v


def _merge(states):
    """Merge (m, l, acc) partials in order."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(li * torch.exp2((m - mx) * LOG2E) for m, li, _ in states)
    acc = sum(a * torch.exp2((m - mx) * LOG2E)[:, None] for m, _, a in states)
    return mx, l, acc


def _split_rows(qs, krows, vrows, n, splits, span, ch, lowp):
    """One (b, kv head): the online softmax of its G rows ``qs`` over the
    first ``n`` of ``krows``/``vrows`` (the row's cache in position order),
    cut into ``splits`` of ``span`` positions, each staged in chunks of
    ``ch``, four warps of 16 keys a chunk; the warps, then the live splits,
    merged in order. Returns (G, hdv), zeros for n = 0."""
    G, hdv = qs.shape[0], vrows.shape[-1]
    partials = []
    for split in range(splits):
        p0, p1 = split * span, min((split + 1) * span, n)
        if p0 >= p1:
            continue
        warps = [(torch.full((G,), NEG_INF), torch.zeros(G), torch.zeros(G, hdv))
                 for _ in range(WARPS)]
        for c0 in range(p0, p1, ch):
            c1 = min(c0 + ch, p1)
            for w in range(WARPS):
                k0, k1 = c0 + w * WARP_KEYS, min(c0 + (w + 1) * WARP_KEYS, c1)
                if k0 < k1:
                    s = qs @ krows[k0:k1].T
                    warps[w] = _online(warps[w], s, vrows[k0:k1], lowp)
        partials.append(_merge(warps))
    if not partials:
        return torch.zeros(G, hdv)
    _, l, acc = _merge(partials)
    return acc / l.clamp_min(1e-30)[:, None]


def _emulate(q, kp, vp, table, lengths, *, scale, lowp, sms):
    """(out, splits) as flash_decode_paged computes them on a card of
    ``sms`` SMs."""
    B, K, G, hd = q.shape
    NB, bs, hdv, T = kp.shape[0], kp.shape[1], vp.shape[-1], table.shape[1]
    rows = B * K * -(-G // tfa.DECODE_ROWS)
    splits, bps = tfa.decode_paged_plan(T, bs, rows, sms)
    ch = (tfa.DECODE_CHUNK // bs) * bs if bs <= tfa.DECODE_CHUNK else tfa.DECODE_CHUNK
    table = table.clamp(0, NB - 1)
    lengths = lengths.clamp(0, T * bs)
    qs = _dot(q * scale, lowp)
    kc, vc = _dot(kp, lowp), _dot(vp, lowp)
    out = torch.zeros(B, K, G, hdv)
    for b in range(B):
        n = int(lengths[b])
        pos = torch.arange(n)
        phys = table[b, pos // bs] * bs + pos % bs  # pool row of each position
        for kh in range(K):
            out[b, kh] = _split_rows(qs[b, kh], kc.reshape(NB * bs, K, hd)[phys, kh],
                                     vc.reshape(NB * bs, K, hdv)[phys, kh], n, splits,
                                     bps * bs, ch, lowp)
    return out, splits


def _emulate_contiguous(q, k, v, lengths, *, scale, lowp, sms):
    """(out, splits) as flash_decode computes them on a card of ``sms``
    SMs: the (B, Smax) cache read as a table of 64-position blocks, row b's
    position p at cache row p (no table), lengths clamped to Smax."""
    B, K, G, hd = q.shape
    Smax = k.shape[1]
    splits, bps = tfa.decode_plan(Smax, B * K * -(-G // tfa.DECODE_ROWS), sms)
    lengths = lengths.clamp(0, Smax)
    qs, kc, vc = _dot(q * scale, lowp), _dot(k, lowp), _dot(v, lowp)
    out = torch.zeros(B, K, G, v.shape[-1])
    for b in range(B):
        for kh in range(K):
            out[b, kh] = _split_rows(qs[b, kh], kc[b, :, kh], vc[b, :, kh],
                                     int(lengths[b]), splits, bps * tfa.DECODE_CHUNK,
                                     tfa.DECODE_CHUNK, lowp)
    return out, splits


CASES = [  # B, K, G, hd, hdv, bs, T, lengths (the last rows past the capacity)
    (4, 2, 4, 16, 16, 16, 12, [0, 1, 64, 200]),
    (5, 1, 4, 32, 16, 5, 40, [0, 1, 60, 61, 240]),
    (3, 2, 6, 16, 32, 5, 30, [59, 150, 151]),
    (2, 2, 4, 16, 16, 16, 1, [0, 17]),         # T = 1: one split
]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("B,K,G,hd,hdv,bs,T,lengths", CASES)
def test_split_emulation_matches_jax(B, K, G, hd, hdv, bs, T, lengths, lowp, sms):
    rng = np.random.default_rng(B * T + bs)
    NB = B * T + 2
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, bs, K, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, K, hdv)).astype(np.float32)
    table = rng.integers(-2, NB + 2, (B, T)).astype(np.int32)  # clamped by both
    lens = np.asarray(lengths, np.int32)
    want = jfa.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, table, lens)), lowp=lowp)
    got, splits = _emulate(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                           scale=1.0 / math.sqrt(hd), lowp=lowp, sms=sms)
    if sms == 132 and T > 1:
        assert splits > 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(BF16 if lowp else F32))
    assert not got[torch.from_numpy(lens) == 0].any(), "a length-0 row returns zeros"


@pytest.mark.parametrize("T,bs,rows,sms,want", [
    (64, 16, 64, 132, (8, 8)),       # the paged serve run: 8 splits of 128 positions
    (512, 16, 64, 132, (9, 60)),
    (512, 5, 42, 132, (11, 48)),     # bs 5: splits of 4 chunks of 60 positions
    (1, 16, 64, 132, (1, 1)),        # T = 1
    (9, 5, 10, 132, (1, 9)),         # one chunk holds the whole table
    (64, 16, 65536, 132, (1, 64)),   # rows enough to fill the card
    (3, 100, 2, 132, (3, 1)),        # bs > 64: one pool block a split
])
def test_decode_paged_plan(T, bs, rows, sms, want):
    assert tfa.decode_paged_plan(T, bs, rows, sms) == want


@pytest.mark.parametrize("bs", [1, 5, 16, 64, 100])
def test_decode_paged_plan_covers_each_table_once(bs):
    """For every table length and row count: the splits cover the table
    exactly (the last one live), a split is whole chunks of whole pool
    blocks unless it is the whole table, and a table of one chunk takes one
    split."""
    per_chunk = max(1, tfa.DECODE_CHUNK // bs)
    for T in (1, 2, 3, 7, 12, 13, 64, 100, 513):
        for rows in (1, 7, 64, 528, 100000):
            splits, bps = tfa.decode_paged_plan(T, bs, rows, 132)
            assert splits * bps >= T and (splits - 1) * bps < T
            assert bps % per_chunk == 0 or bps == T
            if T <= per_chunk:
                assert splits == 1


CONTIG_CASES = [  # B, K, G, hd, hdv, Smax, lengths (0, 1, and past Smax)
    (4, 2, 4, 16, 16, 200, [0, 1, 130, 201]),
    (3, 1, 1, 32, 16, 1030, [1, 1024, 1031]),   # G 1, a 6-position last chunk
    (3, 2, 6, 16, 32, 200, [0, 65, 200]),       # G 6: two row groups, hdv > hd
    (2, 1, 4, 16, 16, 64, [0, 70]),             # one chunk: one split
]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("B,K,G,hd,hdv,Smax,lengths", CONTIG_CASES)
def test_contiguous_split_emulation_matches_jax(B, K, G, hd, hdv, Smax, lengths, lowp,
                                                sms):
    rng = np.random.default_rng(B * Smax + G)
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, K, hdv)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    scale = 0.3 if G == 6 else None  # an explicit scale is honoured
    want = jfa.flash_decode(*map(jnp.asarray, (q, k, v, lens)), scale=scale, lowp=lowp)
    got, splits = _emulate_contiguous(
        *map(torch.from_numpy, (q, k, v, lens)),
        scale=1.0 / math.sqrt(hd) if scale is None else scale, lowp=lowp, sms=sms)
    if sms == 132 and Smax > tfa.DECODE_CHUNK:
        assert splits > 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(BF16 if lowp else F32))
    assert not got[torch.from_numpy(lens) == 0].any(), "a length-0 row returns zeros"


@pytest.mark.parametrize("Smax,rows,want", [
    (1024, 64, (8, 2)),      # the serve shape: 8 splits of 128 positions
    (8192, 64, (9, 15)),     # the long cache: 9 splits of 960
    (200, 6, (4, 1)),        # Smax not a multiple of 64: a short last chunk
    (64, 64, (1, 1)),        # one chunk: one split, no partials
    (1024, 65536, (1, 16)),  # rows enough to fill the card
])
def test_decode_plan(Smax, rows, want):
    assert tfa.decode_plan(Smax, rows, 132) == want


def test_decode_plan_covers_each_position_once():
    """For every cache length and row count, the splits the kernel takes
    (split s: positions [s * bps * 64, (s + 1) * bps * 64) of the row,
    cut at Smax) cover positions 0..Smax-1 exactly once, the last split
    live."""
    for Smax in (1, 63, 64, 65, 200, 1024, 1030, 8192, 8193):
        for rows in (1, 7, 64, 528, 100000):
            splits, bps = tfa.decode_plan(Smax, rows, 132)
            seen = np.zeros(Smax, np.int64)
            for split in range(splits):
                p0 = split * bps * tfa.DECODE_CHUNK
                p1 = min(p0 + bps * tfa.DECODE_CHUNK, Smax)
                assert p0 < p1, "every split holds positions"
                seen[p0:p1] += 1
            assert (seen == 1).all()
