"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips itself unless a CUDA device of compute
capability 9.0 is there (the libraries hold sm_90a code only). This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 at f32, 5e-2 with
bf16 dot inputs; the attention kernels with bf16 inputs and f32 dot inputs
(no ``lowp``) are held to 1e-3 (``SPLIT``), and the forward's bf16 output
in that mode to 1e-3 of the plain version's f32 output beside its own
rounding to bf16 (half a bf16 unit).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_backward as fb
from repro_torch.kernels import ref

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
CASES = [(torch.float32, False), (torch.bfloat16, True)]
# bf16 without lowp: the split leaves each output within 2^-16 sum |x||y| of
# the f32 product (csrc/flash_bwd.cu, csrc/flash_fwd.cu), about 1e-5
# relative; the plain version's f32 sums and exp differ by less, so 1e-3
# holds with room
SPLIT = dict(rtol=1e-3, atol=1e-3)
# the forward's modes: f32 without and with lowp (FFMA kernel), bf16 with
# lowp and bf16 without it (tensor-core kernel, p split into bf16 pairs)
FWD_MODES = CASES + [(torch.bfloat16, False), (torch.float32, True)]
FWD_CASES = [(64, 64, True, 0), (67, 64, True, 0), (37, 16, False, 0), (29, 32, True, 40),
             (70, 128, True, 0)]  # S, hd, causal, q_offset


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a GPU of compute capability 9.0: the kernels are sm_90a code")
    return torch.device("cuda")


def _assert_bf16_out_close(got, want, tol):
    """``got`` (bf16) within ``tol`` of ``want`` (f32) beside half a bf16 unit:
    the kernel rounds its f32 result to bf16 once, so two f32 values within
    ``tol`` may round to neighbouring bf16 values."""
    got, want = got.float(), want.float()
    eps = tol["atol"] + tol["rtol"] * want.abs()
    _, e = torch.frexp(want.abs() + eps)  # |want| + eps in [2^(e-1), 2^e)
    half_unit = torch.ldexp(torch.ones_like(want), e - 9)
    err = (got - want).abs()
    bad = err > eps + half_unit
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {err.numel()} elements past the bound; max err "
        f"{float(err.max()):.3g}")


def _check_fwd(dtype, lowp, B, H, Sq, hd, causal, q_offset, seed, Sk=None):
    """flash_fwd against the plain version on one seeded input, launched once;
    Sk defaults to Sq + q_offset."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, Sq, hd, generator=g, device=dev).to(dtype)
    Sk = Sq + q_offset if Sk is None else Sk
    k, v = (torch.randn(B, H, Sk, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = fa.launches["flash_fwd"]
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, q_offset=q_offset,
                                        lowp=lowp)
    assert fa.launches["flash_fwd"] == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16 and not lowp:
        # the plain version's f32 result, before its cast of o to bf16
        ro, rl = ref.ref_flash_attention_fwd(q.float(), k.float(), v.float(),
                                             causal=causal, q_offset=q_offset)
        _assert_bf16_out_close(o, ro, SPLIT)
        torch.testing.assert_close(lse, rl, **SPLIT)
        return
    ro, rl = ref.ref_flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                         lowp=lowp)
    tol = BF16 if lowp else F32
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rl, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", FWD_MODES)
@pytest.mark.parametrize("S,hd,causal,q_offset", FWD_CASES)
def test_flash_fwd_matches_plain(dtype, lowp, S, hd, causal, q_offset):
    _check_fwd(dtype, lowp, 2, 3, S, hd, causal, q_offset, seed=S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", FWD_MODES)
def test_flash_fwd_matches_plain_at_the_train_shape(dtype, lowp):
    """The train step's attention: B4 H32 S512 hd64, causal."""
    _check_fwd(dtype, lowp, 4, 32, 512, 64, True, 0, seed=512)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", FWD_MODES)
def test_flash_fwd_past_65535_heads(dtype, lowp):
    """B*H = 65536 runs in every mode and matches the plain version: both
    kernels' 1-D grids over (query tile, b*h) take it in one launch."""
    _check_fwd(dtype, lowp, 1, 65536, 5, 16, True, 0, seed=65536)


# the edges of the FFMA forward's tiles: 64 rows a block and keys a tile, 16
# rows a warp, 32 keys an exchange round; the last is the serve prefill's
FWD_EDGE_CASES = [  # Sq, Sk, causal, q_offset
    (1, 1, True, 0),
    (63, 63, True, 0),
    (65, 65, False, 0),
    (127, 127, True, 0),
    (509, 509, True, 0),
    (512, 512, False, 0),
    (17, 100, True, 83),    # Sq != Sk, q_offset past the first tile
    (33, 200, True, 167),
    (65, 130, False, 0),
    (256, 256, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,groups", [(16, 1), (16, 2), (32, 1), (32, 2), (64, 1), (64, 2),
                                       (128, 1)])
@pytest.mark.parametrize("Sq,Sk,causal,q_offset", FWD_EDGE_CASES)
def test_flash_fwd_f32_at_the_tile_edges(hd, groups, Sq, Sk, causal, q_offset, monkeypatch):
    """The f32 FFMA kernel at the edges of its tiles, in every head dim, with
    one group of warps a block and with two (hd <= 64), whatever the grid's
    size would choose."""
    monkeypatch.setattr(fa, "fwd_groups", lambda *a: groups)
    _check_fwd(torch.float32, False, 1, 3, Sq, hd, causal, q_offset, seed=Sq + hd, Sk=Sk)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,lowp", [(4, 32, 512, False), (1, 32, 256, False),
                                        (1, 32, 509, True)])
def test_flash_fwd_f32_is_deterministic(B, H, S, lowp):
    """Two calls on the same inputs give the same bits: every sum runs in a
    fixed order in one thread, and two groups merge in a fixed order."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(B, H, S, 64, generator=g, device=dev) for _ in range(3))
    first = fa.flash_attention_fwd_lse(q, k, v, causal=True, lowp=lowp)
    second = fa.flash_attention_fwd_lse(q, k, v, causal=True, lowp=lowp)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [True, False])
def test_flash_fwd_bf16_launch_failure_raises(lowp, monkeypatch):
    """A bf16 call whose tensor map cannot be encoded (a base 2 bytes off the
    16-byte alignment TMA needs, past the wrapper's own check) raises the
    launch error: the FFMA kernel, which would take it, does not run."""
    dev = _device()
    x = torch.zeros(2 * 8 * 16 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 2, 8, 16)
    monkeypatch.setattr(fa, "_check_aligned", lambda *a: None)
    before = dict(fa.launches)
    with pytest.raises(RuntimeError, match="flash_fwd failed"):
        fa.flash_attention_fwd_lse(x, x, x, lowp=lowp)
    assert fa.launches == before


@pytest.mark.cuda
def test_flash_fwd_refuses_a_misaligned_bf16_input():
    dev = _device()
    x = torch.zeros(2 * 8 * 16 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 2, 8, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_fwd_lse(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("lowp", [True, False])
def test_flash_attention_mha_bf16_matches_the_plain_versions(lowp):
    """autograd through ``_FlashMHA`` with bf16 inputs on the card (the
    tensor-core forward and backward) against the same function on CPU
    copies, where it runs the plain versions with the same rounding points.
    bf16 outputs and gradients without lowp: 1e-2, one bf16 unit (up to
    2^-7 relative) on each side of the final casts, beside SPLIT."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(2, 3, 70, 64, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    w = torch.randn(2, 3, 70, 64, generator=g, device=dev).to(torch.bfloat16).float()

    def run(device):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_mha(*leaves, causal=True, lowp=lowp)
        grads = torch.autograd.grad((out.float() * w.to(device)).sum(), leaves)
        return [t.cpu() for t in (out, *grads)]

    before = fa.all_launches()
    got = run(dev)
    after = fa.all_launches()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    want = run("cpu")
    tol = BF16 if lowp else dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("K,G,hd,hdv,scale", [(2, 4, 64, 64, None), (1, 8, 32, 16, 0.3),
                                              (2, 12, 16, 128, None)])
def test_flash_decode_matches_plain(dtype, lowp, K, G, hd, hdv, scale):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(G)
    B, Smax = 5, 300
    q = torch.randn(B, K, G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Smax, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Smax, K, hdv, generator=g, device=dev).to(dtype)
    lens = torch.tensor([0, 1, 33, Smax, Smax + 1], dtype=torch.int32, device=dev)
    out = fa.flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    want = ref.ref_flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert not out[0].any(), "a length-0 row must return zeros"


def _check_decode(dtype, lowp, B, K, G, hd, hdv, Smax, lens, seed, scale=None):
    """flash_decode against the plain version on one seeded input, launched
    once (one count, whatever its split); returns the inputs and the
    output."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, K, G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Smax, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Smax, K, hdv, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fa.launches["flash_decode"]
    out = fa.flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    assert fa.launches["flash_decode"] == before + 1
    want = ref.ref_flash_decode(q, k, v, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert not out[lens == 0].any(), "a length-0 row must return zeros"
    return (q, k, v, lens), out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("K,G,hd,hdv,Smax", [(8, 4, 64, 64, 8192), (8, 4, 64, 64, 1024),
                                             (2, 12, 16, 128, 4100), (2, 5, 32, 16, 1030),
                                             (8, 4, 64, 64, 64)])
def test_flash_decode_with_many_splits(dtype, lowp, K, G, hd, hdv, Smax):
    """The contiguous cache cut into many splits (Smax 8192: 268 MB of f32
    cache at the serve shape; 4100 and 1030: a short last chunk) and into
    one (Smax 64, no partials), at lengths 0, 1, one below, at and one past
    a split edge, at Smax and past it."""
    B = 7
    splits, bps = fa.decode_plan(Smax, B * K * -(-G // fa.DECODE_ROWS),
                                 torch.cuda.get_device_properties(_device()).multi_processor_count)
    assert (splits > 1) == (Smax > fa.DECODE_CHUNK)
    edge = min(bps * fa.DECODE_CHUNK, Smax)
    lens = [0, 1, edge - 1, edge, min(edge + 1, Smax), Smax, Smax + 9]
    _check_decode(dtype, lowp, B, K, G, hd, hdv, Smax, lens, seed=Smax + G)


@pytest.mark.cuda
@pytest.mark.parametrize("Smax", [1024, 8192])
def test_flash_decode_is_deterministic(Smax):
    """Two calls give the same bits: each split sums in a fixed order, and
    the merge takes the splits in order."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(Smax)
    lens = torch.randint(0, Smax + 2, (8,), generator=g, device=dev, dtype=torch.int32)
    args, first = _check_decode(torch.float32, False, 8, 8, 4, 64, 64, Smax,
                                lens.tolist(), seed=Smax)
    assert torch.equal(first, fa.flash_decode(*args))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _device()
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 8, 24, device=dev)
        fa.flash_attention_fwd_lse(x, x, x)
    with pytest.raises(ValueError, match="hdv <= 128"):
        fa.flash_decode(torch.zeros(1, 1, 2, 16, device=dev),
                        torch.zeros(1, 4, 1, 16, device=dev),
                        torch.zeros(1, 4, 1, 256, device=dev), 2)


def _pool_and_table(g, dev, dtype, B, K, hd, hdv, bs, T):
    """Pools of NB = B*T + 3 blocks and a shuffled (B, T) table with entries
    outside [0, NB-1], which wrapper and kernel clamp."""
    NB = B * T + 3
    kp = torch.randn(NB, bs, K, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(NB, bs, K, hdv, generator=g, device=dev).to(dtype)
    table = torch.randperm(B * T, generator=g, device=dev).reshape(B, T) + 1
    table[0, -1], table[-1, 0] = -5, NB + 7
    return kp, vp, table.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("K,G,hd,hdv,bs,scale", [(2, 4, 64, 64, 16, None),
                                                 (1, 1, 32, 16, 8, 0.3),
                                                 (2, 12, 16, 128, 5, None)])
def test_flash_decode_paged_matches_plain(dtype, lowp, K, G, hd, hdv, bs, scale):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(G + bs)
    B, T = 5, 9
    q = torch.randn(B, K, G, hd, generator=g, device=dev).to(dtype)
    kp, vp, table = _pool_and_table(g, dev, dtype, B, K, hd, hdv, bs, T)
    lens = torch.tensor([0, 1, 2 * bs + 3, T * bs, T * bs + 9], dtype=torch.int32,
                        device=dev)
    before = fa.launches["flash_decode_paged"]
    out = fa.flash_decode_paged(q, kp, vp, table, lens, scale=scale, lowp=lowp)
    want = ref.ref_flash_decode_paged(q, kp, vp, table, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert not out[0].any(), "a length-0 row must return zeros"
    assert fa.launches["flash_decode_paged"] == before + 1


def _check_decode_paged(dtype, lowp, B, K, G, hd, hdv, bs, T, lens, seed, scale=None):
    """flash_decode_paged against the plain version on one seeded input,
    launched once (one count, whatever its split); returns the output."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, K, G, hd, generator=g, device=dev).to(dtype)
    kp, vp, table = _pool_and_table(g, dev, dtype, B, K, hd, hdv, bs, T)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fa.launches["flash_decode_paged"]
    out = fa.flash_decode_paged(q, kp, vp, table, lens, scale=scale, lowp=lowp)
    assert fa.launches["flash_decode_paged"] == before + 1
    want = ref.ref_flash_decode_paged(q, kp, vp, table, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert not out[lens == 0].any(), "a length-0 row must return zeros"
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
def test_flash_decode_paged_at_the_serve_shape(dtype, lowp):
    """The paged serve run's shape: B8 K8 G4 hd64, 64 blocks of 16 a row,
    ragged lengths from 0 to past the capacity, split across blocks."""
    bs, T = 16, 64
    assert fa.decode_paged_plan(T, bs, 8 * 8, 132)[0] > 1
    _check_decode_paged(dtype, lowp, 8, 8, 4, 64, 64, bs, T,
                        [0, 1, 193, 300, 511, 700, 1024, 1030], seed=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("K,G,hd,hdv,bs,T", [(8, 4, 64, 64, 16, 512),
                                             (2, 12, 16, 128, 5, 512),
                                             (2, 5, 32, 16, 5, 97),
                                             (8, 4, 64, 64, 16, 1)])
def test_flash_decode_paged_with_many_splits(dtype, lowp, K, G, hd, hdv, bs, T):
    """Long tables cut into many splits (bs 5: a 60-position chunk that no
    64-wide tile would align with), and T = 1 (one split, no partials), at
    lengths 0, 1, one below, at and one past a split edge, at the capacity
    and past it."""
    dev = _device()
    B, cap = 7, bs * T
    splits, bps = fa.decode_paged_plan(T, bs, B * K * -(-G // fa.DECODE_ROWS),
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (splits > 1) == (T > 1)
    edge = min(bps * bs, cap)
    lens = [0, 1, edge - 1, edge, min(edge + 1, cap), cap, cap + 9]
    _check_decode_paged(dtype, lowp, B, K, G, hd, hdv, bs, T, lens, seed=T + bs)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 512])
def test_flash_decode_paged_is_deterministic(T):
    """Two calls give the same bits: each split sums in a fixed order, and
    the merge takes the splits in order (the atomic count of arrivals picks
    which block merges, not the order)."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(T)
    B, K, G, hd, bs = 8, 8, 4, 64, 16
    q = torch.randn(B, K, G, hd, generator=g, device=dev)
    kp, vp, table = _pool_and_table(g, dev, torch.float32, B, K, hd, hd, bs, T)
    lens = torch.randint(0, bs * T + 2, (B,), generator=g, device=dev, dtype=torch.int32)
    first = fa.flash_decode_paged(q, kp, vp, table, lens)
    assert torch.equal(first, fa.flash_decode_paged(q, kp, vp, table, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("K,S,G,hd,hdv,bs,T", [(2, 2, 4, 64, 64, 16, 6), (2, 5, 4, 64, 64, 16, 6),
                                               (1, 3, 1, 32, 16, 16, 6),
                                               (2, 16, 4, 64, 64, 16, 6),   # S*G = 64
                                               (1, 4, 3, 16, 128, 16, 6),
                                               (2, 17, 4, 64, 64, 16, 6),   # S*G = 68
                                               (2, 9, 8, 32, 32, 5, 20),    # S*G = 72, bs 5
                                               (2, 5, 4, 64, 64, 16, 512)])  # a long cache
def test_flash_decode_spec_matches_plain(dtype, lowp, paged, K, S, G, hd, hdv, bs, T):
    """Both verify kernels against their plain versions, launched once a
    call, past the parent's 64-row ceiling (several row blocks) and over a
    long cache (many splits); a second call gives the same bits."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(S * G + hd + T)
    B = 5
    cap = bs * T
    q = torch.randn(B, K, S, G, hd, generator=g, device=dev).to(dtype)
    # base 0, ragged, a window past the capacity, and an idle slot at it
    lens = torch.tensor([0, 7, 40, cap - 2, cap], dtype=torch.int32, device=dev)
    tol = BF16 if lowp else F32
    if paged:
        kp, vp, table = _pool_and_table(g, dev, dtype, B, K, hd, hdv, bs, T)
        args = (q, kp, vp, table, lens)
    else:
        k = torch.randn(B, cap, K, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, cap, K, hdv, generator=g, device=dev).to(dtype)
        args = (q, k, v, lens)
    name = "flash_decode_spec_paged" if paged else "flash_decode_spec"
    before = fa.launches[name]
    out = getattr(fa, name)(*args, lowp=lowp)
    assert fa.launches[name] == before + 1
    want = getattr(ref, f"ref_{name}")(*args, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert torch.equal(out, getattr(fa, name)(*args, lowp=lowp))


# nemotron-4-15b's decode geometry: 48 query heads over 8 KV heads (G = 6,
# a KV head's second row group of 4 half full), head dim 128; a depth-4
# verify window of S = 5 gives S*G = 30 rows (two row blocks of 24)
NEMOTRON_DECODE = dict(B=4, K=8, G=6, hd=128, bs=16, T=32, S=5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES + [(torch.bfloat16, False)])
@pytest.mark.parametrize("kernel", ["flash_decode", "flash_decode_paged",
                                    "flash_decode_spec", "flash_decode_spec_paged"])
def test_decode_kernels_at_the_nemotron_geometry(kernel, dtype, lowp):
    """The four decode kernels at K8 G6 hd128 over 512 positions (32 blocks
    of 16 a row), at the serve run's ragged lengths, 0 and the capacity,
    launched once a call, against their plain versions; bf16 without lowp
    (bf16 weights and cache: the serve path's mode) against the plain
    version's f32 result on the same bf16 values, beside half a bf16 unit
    for the kernel's rounding of its f32 result."""
    dev = _device()
    c = NEMOTRON_DECODE
    B, K, G, hd, bs, T = c["B"], c["K"], c["G"], c["hd"], c["bs"], c["T"]
    g = torch.Generator(device=dev).manual_seed(G * hd)
    spec = "spec" in kernel
    qshape = (B, K, c["S"], G, hd) if spec else (B, K, G, hd)
    q = torch.randn(*qshape, generator=g, device=dev).to(dtype)
    cap = bs * T
    lens = torch.tensor([0, 193, 320, cap - c["S"] if spec else cap],
                        dtype=torch.int32, device=dev)
    if "paged" in kernel:
        kp, vp, table = _pool_and_table(g, dev, dtype, B, K, hd, hd, bs, T)
        args = (q, kp, vp, table, lens)
    else:
        args = (q, *(torch.randn(B, cap, K, hd, generator=g, device=dev).to(dtype)
                     for _ in range(2)), lens)
    before = fa.launches[kernel]
    out = getattr(fa, kernel)(*args, lowp=lowp)
    assert fa.launches[kernel] == before + 1
    assert out.shape == qshape and out.dtype == dtype
    plain = getattr(ref, f"ref_{kernel}")
    if dtype == torch.bfloat16 and not lowp:
        want = plain(*(a.float() if a.is_floating_point() else a for a in args))
        _assert_bf16_out_close(out, want, F32)
    else:
        want = plain(*args, lowp=lowp)
        torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    if not spec:
        assert not out[0].any(), "a length-0 row must return zeros"


@pytest.mark.cuda
def test_split_decode_kernels_share_the_arrival_counts():
    """flash_decode_paged and flash_decode_spec_paged run back to back on one
    stream, both split, share the stream's arrival counts: each gives the
    bits it gives alone, and the counts are zero after them."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(7)
    B, K, G, S, hd, bs, T = 8, 8, 4, 5, 64, 16, 64
    assert fa.decode_paged_plan(T, bs, B * K, 132)[0] > 1
    q1 = torch.randn(B, K, G, hd, generator=g, device=dev)
    q2 = torch.randn(B, K, S, G, hd, generator=g, device=dev)
    kp, vp, table = _pool_and_table(g, dev, torch.float32, B, K, hd, hd, bs, T)
    lens = torch.tensor([0, 1, 193, 300, 511, 700, 1019, 1024], dtype=torch.int32,
                        device=dev)
    alone_dec = fa.flash_decode_paged(q1, kp, vp, table, lens)
    torch.cuda.synchronize()
    alone_spec = fa.flash_decode_spec_paged(q2, kp, vp, table, lens)
    torch.cuda.synchronize()
    for _ in range(3):
        dec = fa.flash_decode_paged(q1, kp, vp, table, lens)
        spec = fa.flash_decode_spec_paged(q2, kp, vp, table, lens)
    assert torch.equal(dec, alone_dec) and torch.equal(spec, alone_spec)
    device, stream = dev.index or torch.cuda.current_device(), \
        torch.cuda.current_stream(dev).cuda_stream
    assert not fa._ARRIVALS[(device, stream)].any()


@pytest.mark.cuda
def test_contiguous_and_paged_split_kernels_share_the_arrival_counts():
    """flash_decode, flash_decode_paged and flash_decode_spec run back to
    back on one stream, all split, share the stream's arrival counts: each
    gives the bits it gives alone, and the counts are zero after them."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(11)
    B, K, G, S, hd, bs, T = 8, 8, 4, 5, 64, 16, 64
    Smax = bs * T
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fa.decode_plan(Smax, B * K, sms)[0] > 1
    assert fa.decode_paged_plan(T, bs, B * K, sms)[0] > 1
    q1 = torch.randn(B, K, G, hd, generator=g, device=dev)
    q2 = torch.randn(B, K, S, G, hd, generator=g, device=dev)
    k, v = (torch.randn(B, Smax, K, hd, generator=g, device=dev) for _ in range(2))
    kp, vp, table = _pool_and_table(g, dev, torch.float32, B, K, hd, hd, bs, T)
    lens = torch.tensor([0, 1, 193, 300, 511, 700, 1019, 1024], dtype=torch.int32,
                        device=dev)
    calls = [lambda: fa.flash_decode(q1, k, v, lens),
             lambda: fa.flash_decode_paged(q1, kp, vp, table, lens),
             lambda: fa.flash_decode_spec(q2, k, v, lens)]
    alone = []
    for call in calls:
        alone.append(call())
        torch.cuda.synchronize()
    for _ in range(3):
        together = [call() for call in calls]
    assert all(torch.equal(a, b) for a, b in zip(together, alone))
    device, stream = dev.index or torch.cuda.current_device(), \
        torch.cuda.current_stream(dev).cuda_stream
    assert not fa._ARRIVALS[(device, stream)].any()


@pytest.mark.cuda
def test_decode_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _device()
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    pool = torch.zeros(3, 4, 1, 16, device=dev)
    with pytest.raises(ValueError, match="hdv <= 128"):
        fa.flash_decode_paged(torch.zeros(1, 1, 2, 16, device=dev), pool,
                              torch.zeros(3, 4, 1, 256, device=dev), table, 2)
    with pytest.raises(ValueError, match="hdv <= 128"):
        fa.flash_decode_spec_paged(torch.zeros(1, 1, 2, 2, 16, device=dev), pool,
                                   torch.zeros(3, 4, 1, 256, device=dev), table, 2)
    misaligned = torch.zeros(3 * 4 * 16 + 1, device=dev)[1:].view(3, 4, 1, 16)
    for call in (lambda: fa.flash_decode_paged(torch.zeros(1, 1, 2, 16, device=dev),
                                               misaligned, pool, table, 2),
                 lambda: fa.flash_decode_spec_paged(
                     torch.zeros(1, 1, 2, 2, 16, device=dev), misaligned, pool,
                     table, 2)):
        with pytest.raises(ValueError, match="aligned to 4 elements"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", CASES)
@pytest.mark.parametrize("kernel", ["flash_decode", "flash_decode_paged",
                                    "flash_decode_spec", "flash_decode_spec_paged"])
def test_decode_kernels_past_65535_rows(kernel, dtype, lowp):
    """B = 65536 with a short cache runs and matches the plain version:
    every decode and verify kernel has a 1-D grid, past what grid.y would
    hold. One launch is counted per call."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(65536)
    B, K, G, hd, bs, T, S = 65536, 1, 2, 16, 4, 2, 2
    cap = bs * T
    lens = torch.randint(0, cap + 2, (B,), generator=g, device=dev, dtype=torch.int32)
    spec = "spec" in kernel
    q = torch.randn(B, K, *((S,) if spec else ()), G, hd, generator=g, device=dev).to(dtype)
    if "paged" in kernel:
        kp, vp, table = _pool_and_table(g, dev, dtype, B, K, hd, hd, bs, T)
        args = (q, kp, vp, table, lens)
    else:
        k, v = (torch.randn(B, cap, K, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        args = (q, k, v, lens)
    before = fa.launches[kernel]
    out = getattr(fa, kernel)(*args, lowp=lowp)
    want = getattr(ref, f"ref_{kernel}")(*args, lowp=lowp)
    torch.testing.assert_close(out.float(), want.float(), **(BF16 if lowp else F32))
    assert fa.launches[kernel] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout,depth", [("paged", 0), ("contig", 3), ("paged", 3),
                                          ("contig", 32), ("paged", 32)])
def test_serve_paged_and_speculative_on_the_card(layout, depth):
    """The reduced llama3.2-1b served paged and/or speculative through the
    kernels: the same streams as the plain attention on the card, and the
    path's kernel launched. At draft depth 32 (G = 2 at the reduced size) a
    verify pass scores S = 33 positions, R = 66 rows, past the parent's
    64-row ceiling: ``max_seq`` and the budget leave the engine room to
    draft all 32."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = get_config("llama3.2-1b").reduced()
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 9, 3, 5)]
    prompts[2] = prompts[0]  # identical: a full-prompt hit and a COW copy
    kernel = "flash_decode_paged" if depth == 0 else \
        "flash_decode_spec_paged" if layout == "paged" else "flash_decode_spec"
    max_seq, gen = (96, 40) if depth == 32 else (48, 10)
    streams = {}
    for impl in ("pallas", "naive"):
        model = build_model(cfg, impl=impl, device=dev)
        params = model.init(model.generator(0))
        engine = serve.ContinuousBatchingEngine(
            model, params, max_batch=3, max_seq=max_seq, kv_layout=layout,
            block_size=4, draft_depth=depth)
        depths = []
        spec_k = engine._spec_k
        engine._spec_k = lambda active: depths.append(spec_k(active)) or depths[-1]
        before = fa.launches[kernel]
        done = engine.run([serve.Request(uid=u, prompt=p.astype(np.int32),
                                         max_new_tokens=gen)
                           for u, p in enumerate(prompts)])
        streams[impl] = {u: f.tokens for u, f in done.items()}
        launched = fa.launches[kernel] - before
        assert (launched > 0) == (impl == "pallas"), (impl, launched)
        assert max(depths) == depth, depths
    assert cfg.n_heads // cfg.n_kv_heads == 2
    assert streams["pallas"] == streams["naive"]


BWD_CASES = [  # Sq, Sk, hd, causal, q_offset
    (64, 64, 64, True, 0),
    (67, 67, 64, True, 0),       # ragged tails of rows and keys
    (37, 37, 16, False, 0),
    (29, 69, 32, True, 40),      # q_offset: a query chunk at the end
    (130, 130, 128, True, 0),
    (48, 112, 32, False, 0),     # Sq != Sk
    (300, 300, 64, False, 0),
]


# the backward's three numeric modes: f32 (FFMA kernels), lowp (bf16 tensor
# cores; an f32 call is rounded to bf16 first) and bf16 without lowp (tensor
# cores with p and ds split into bf16 pairs, held to SPLIT)
BWD_MODES = CASES + [(torch.float32, True), (torch.bfloat16, False)]


def _bwd_tol(dtype, lowp):
    if lowp:
        return BF16
    return F32 if dtype == torch.float32 else SPLIT


def _check_bwd(dtype, lowp, B, H, Sq, Sk, hd, causal, q_offset):
    """Both backward kernels against the plain version on one seeded input;
    each kernel launched once."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(Sq + Sk)
    q, do = (torch.randn(B, H, Sq, hd, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Sk, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    o, lse = ref.ref_flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset, lowp=lowp)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fb.launches)
    dq = fb.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                         q_offset=q_offset, lowp=lowp)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                              q_offset=q_offset, lowp=lowp)
    want_dq, want_dk, want_dv = ref.ref_flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, q_offset=q_offset, lowp=lowp)
    tol = _bwd_tol(dtype, lowp)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name}: {m}")
    assert fb.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert fb.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", BWD_MODES)
@pytest.mark.parametrize("Sq,Sk,hd,causal,q_offset", BWD_CASES)
def test_flash_bwd_matches_plain(dtype, lowp, Sq, Sk, hd, causal, q_offset):
    """Tolerances: 2e-5 in f32, 5e-2 under lowp, and 1e-3 for bf16 inputs
    without lowp (``SPLIT``: the split products' bound, with room for the
    plain version's own f32 rounding)."""
    _check_bwd(dtype, lowp, 2, 3, Sq, Sk, hd, causal, q_offset)


# the edges of the f32 kernels' tiles: 64 rows (dq) or keys (dkv) a block
# and a streamed tile, 16 (8 for dkv at hd 128) a warp, 32 an exchange round
BWD_EDGE_CASES = [  # Sq, Sk, causal, q_offset
    (1, 1, True, 0),        # one row, one key
    (63, 63, True, 0),      # one below a tile
    (65, 65, True, 0),      # one above a tile
    (65, 1, False, 0),      # many rows, one key
    (1, 65, True, 64),      # one row at the end of 65 keys
    (63, 65, False, 0),
    (129, 127, True, 0),    # three row tiles against two key tiles
    (17, 100, True, 83),    # Sq != Sk, q_offset past the first tile
    (33, 200, True, 167),
]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("Sq,Sk,causal,q_offset", BWD_EDGE_CASES)
def test_flash_bwd_f32_at_the_tile_edges(hd, Sq, Sk, causal, q_offset):
    """The f32 FFMA kernels at the edges of their tiles, in every head dim."""
    _check_bwd(torch.float32, False, 1, 3, Sq, Sk, hd, causal, q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", [(4, 32, 512, 512, 64, True),
                                                 (2, 4, 300, 373, 128, False)])
def test_flash_bwd_f32_is_deterministic(B, H, Sq, Sk, hd, causal):
    """Two calls on the same inputs give the same bits: every f32 output is
    summed by one thread in a fixed order, with no atomics."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(Sq)
    q, do = (torch.randn(B, H, Sq, hd, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(B, H, Sk, hd, generator=g, device=dev) for _ in range(2))
    o, lse = ref.ref_flash_attention_fwd(q, k, v, causal=causal)
    delta = (do * o).sum(-1)
    first = (fb.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
             *fb.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    second = (fb.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
              *fb.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", BWD_MODES)
def test_flash_bwd_matches_plain_at_the_train_shape(dtype, lowp):
    """The train step's attention: B4 H32 S512 hd64, causal."""
    _check_bwd(dtype, lowp, 4, 32, 512, 512, 64, True, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", BWD_MODES)
def test_flash_bwd_matches_plain_at_the_moe_train_shape(dtype, lowp):
    """deepseek-moe-16b's train step: B4 H16 S512 hd128, causal."""
    _check_bwd(dtype, lowp, 4, 16, 512, 512, 128, True, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_flash_bwd_bf16_launch_failure_raises(kernel, monkeypatch):
    """A bf16 call whose tensor maps cannot be encoded (a base 2 bytes off
    the 16-byte alignment TMA needs, past the wrapper's own check) raises
    the launch error: no result from the FFMA kernel or the plain version."""
    dev = _device()
    x = torch.zeros(2 * 8 * 16 + 1, device=dev, dtype=torch.bfloat16)[1:].view(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8, device=dev)
    monkeypatch.setattr(fb, "_check_aligned", lambda *a: None)
    before = dict(fb.launches)
    with pytest.raises(RuntimeError, match=f"{kernel} failed"):
        getattr(fb, kernel)(x, x, x, x, lse, lse)
    assert fb.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lowp", BWD_MODES)
def test_flash_bwd_past_65535_heads(dtype, lowp):
    """B*H = 65536 runs and matches the plain version in every mode: every
    backward grid puts b*h on grid.y, so the launch goes in two chunks of
    heads (the tensor-core kernels' tensor maps encoded per chunk), one
    launch counted per call."""
    _check_bwd(dtype, lowp, 1, 65536, 5, 7, 16, True, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mha_grad_goes_through_the_kernels(dtype):
    """autograd through the GQA broadcast and ``_FlashMHA`` on the card, held
    against autograd through the plain attention on the same inputs."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import naive_attention
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(2, 70, 8, 64, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, 70, 2, 64, generator=g, device=dev).to(dtype)
            for _ in range(2))
    w = torch.randn(2, 70, 8, 64, generator=g, device=dev)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * w).sum(), leaves)

    before = fa.all_launches()
    got = grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=True))
    after = fa.all_launches()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    want = grads(lambda a, b, c: naive_attention(a, b, c, causal=True))
    tol = F32 if dtype == torch.float32 else BF16
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
def test_flash_bwd_refuses_a_misaligned_input():
    dev = _device()
    x = torch.zeros(1 * 2 * 8 * 16 + 1, device=dev)[1:].view(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fb.flash_bwd_dq(x, x, x, x, lse, lse)


@pytest.mark.cuda
def test_train_step_on_the_card_goes_through_the_kernels():
    """Two adam steps of the reduced llama3.2-1b through the kernels, held
    against the same steps through the plain attention on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import adam
    dev = _device()
    cfg = get_config("llama3.2-1b").reduced()
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 67)).astype(np.int32)
    losses = {}
    for impl in ("pallas", "naive"):
        model = build_model(cfg, impl=impl, device=dev)
        state = init_train_state(model, adam(), model.generator(0))
        step = build_train_step(model, adam(), microbatch=2, lr=1e-3)
        before = fa.all_launches()
        losses[impl] = []
        for _ in range(2):
            state, metrics = step(state, {"tokens": tokens})
            losses[impl].append(float(metrics["loss"]))
        after = fa.all_launches()
        n = cfg.n_layers * 2 * 2 if impl == "pallas" else 0  # layers x microbatches x steps
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert after[name] - before[name] == n, (impl, name)
    np.testing.assert_allclose(losses["pallas"], losses["naive"], rtol=1e-5)


# ---------------------------------------------------------------------------
# depthwise conv and RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kh,kw", [((2, 8, 8, 16), 3, 3), ((1, 13, 11, 58), 3, 3),
                                         ((2, 16, 16, 116), 5, 5), ((1, 7, 9, 232), 3, 5),
                                         ((1, 3, 2, 33), 7, 1), ((2, 32, 32, 192), 3, 3)])
def test_depthwise_conv_matches_plain(dtype, shape, kh, kw):
    from repro_torch.kernels import depthwise_conv as dw
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    w = torch.randn(kh, kw, shape[-1], generator=g, device=dev).to(dtype)
    before = dw.launches["depthwise_conv"]
    got = dw.depthwise_conv(x, w)
    want = ref.ref_depthwise_conv(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))
    assert dw.launches["depthwise_conv"] == before + 1


# every stride-1 depthwise layer of MobileNetV2 and ShuffleNetV2, (H, W, C) 3x3
CNN_DW_LAYERS = [(32, 32, 192), (16, 16, 144), (8, 8, 192), (4, 4, 384), (4, 4, 576),
                 (2, 2, 960), (16, 16, 58), (8, 8, 116), (4, 4, 232)]


def _check_depthwise(x, kh, kw, seed):
    """The kernel against its plain version on x, one launch."""
    from repro_torch.kernels import depthwise_conv as dw
    g = torch.Generator(device=x.device).manual_seed(seed)
    w = torch.randn(kh, kw, x.shape[-1], generator=g, device=x.device).to(x.dtype)
    before = dw.launches["depthwise_conv"]
    got = dw.depthwise_conv(x, w)
    want = ref.ref_depthwise_conv(x, w)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(BF16 if x.dtype == torch.bfloat16 else F32))
    assert dw.launches["depthwise_conv"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc", CNN_DW_LAYERS)
def test_depthwise_conv_matches_plain_at_the_cnn_layers(dtype, hwc):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(sum(hwc))
    x = torch.randn(16, *hwc, generator=g, device=dev).to(dtype)
    _check_depthwise(x, 3, 3, seed=hwc[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kh,kw", [
    ((3, 9, 7, 1), 3, 3), ((3, 9, 7, 33), 3, 3),          # pitches off 16 bytes
    ((3, 9, 7, 58), 3, 3), ((3, 9, 7, 116), 3, 3), ((3, 9, 7, 232), 3, 3),
    ((4, 1, 1, 64), 3, 3), ((4, 2, 2, 40), 3, 3), ((4, 3, 2, 24), 3, 3),  # below a tile
    ((1, 32, 32, 192), 3, 3), ((1, 40, 70, 24), 3, 3),   # batch 1; column tiles
    ((2, 12, 12, 40), 5, 3), ((2, 12, 12, 40), 5, 5), ((2, 12, 12, 40), 3, 7),
    ((2, 12, 12, 40), 9, 1), ((2, 12, 12, 40), 7, 7), ((2, 12, 12, 40), 1, 1)])
def test_depthwise_conv_matches_plain_at_edge_shapes(dtype, shape, kh, kw):
    """Widths whose pitch is not a multiple of 16 bytes (cp.async or plain
    loads), images smaller than one tile, batch 1, images wider than a tile,
    and every kernel width with register and shared-memory weights."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(sum(shape) + kh * kw)
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    _check_depthwise(x, kh, kw, seed=kh * 10 + kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 2),
                                          (torch.bfloat16, 2), (torch.bfloat16, 1)])
def test_depthwise_conv_matches_plain_off_16_byte_alignment(dtype, offset):
    """x's base ``offset`` elements past a 16-byte boundary (4 or 8 bytes in
    f32, 4 or 2 in bf16): TMA is out, cp.async copies what lines up, plain
    loads the rest."""
    dev = _device()
    shape = (2, 16, 16, 64)
    g = torch.Generator(device=dev).manual_seed(offset)
    n = 2 * 16 * 16 * 64
    x = torch.randn(n + offset, generator=g, device=dev).to(dtype)[offset:].view(shape)
    assert x.data_ptr() % 16 != 0
    _check_depthwise(x, 3, 3, seed=offset)


@pytest.mark.cuda
def test_depthwise_conv_backward_raises_on_the_card():
    from repro_torch.kernels import depthwise_conv as dw
    dev = _device()
    x = torch.randn(1, 6, 6, 8, device=dev, requires_grad=True)
    w = torch.randn(3, 3, 8, device=dev)
    out = dw.depthwise_conv(x, w)
    with pytest.raises(NotImplementedError, match="no custom_vjp"):
        out.sum().backward()
    with pytest.raises(ValueError, match="kernel widths"):
        dw.depthwise_conv(x.detach(), torch.randn(3, 9, 8, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(7, 64), (12, 96), (51, 256), (300, 2048), (9, 100),
                                    (5, 1)])
def test_rmsnorm_fwd_bwd_match_plain(dtype, rows, d):
    from repro_torch.kernels import rmsnorm as rn
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(rows * d)
    x, cot = (torch.randn(rows, d, generator=g, device=dev).to(dtype) for _ in range(2))
    s = torch.randn(d, generator=g, device=dev).to(dtype)
    tol = BF16 if dtype == torch.bfloat16 else F32
    before = dict(rn.launches)
    y = rn.rmsnorm_fwd(x, s)
    dx, ds = rn.rmsnorm_bwd(x, s, cot)
    want_dx, want_ds = ref.ref_rmsnorm_bwd(x, s, cot)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), ref.ref_rmsnorm(x, s).float(), **tol)
    torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
    # dscale sums over the rows: the partials add in another order
    torch.testing.assert_close(ds.float(), want_ds.float(),
                               **(tol if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)))
    assert rn.launches == {"rmsnorm_fwd": before["rmsnorm_fwd"] + 1,
                           "rmsnorm_bwd": before["rmsnorm_bwd"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 1), (37, 96), (37, 100), (37, 2048), (11, 4096),
                                    (11, 8192), (11, 12288), (5, 2049), (3, 20000)])
def test_rmsnorm_fwd_matches_plain_at_each_row_split(dtype, rows, d):
    """Row counts that fill no block evenly, at each of the forward's row
    splits: several rows a warp (1, 96, 100), a block a row with 1-16
    vectors a thread (2048-12288; 2049 with scalar loads), a row read twice
    (20000)."""
    from repro_torch.kernels import rmsnorm as rn
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(rows * d)
    x = torch.randn(rows, d, generator=g, device=dev).to(dtype)
    s = torch.randn(d, generator=g, device=dev).to(dtype)
    before = rn.launches["rmsnorm_fwd"]
    y = rn.rmsnorm_fwd(x, s)
    torch.testing.assert_close(y.float(), ref.ref_rmsnorm(x, s).float(),
                               **(BF16 if dtype == torch.bfloat16 else F32))
    assert rn.launches["rmsnorm_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sdtype", [(torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_fwd_scale_dtypes_and_an_unaligned_view(dtype, sdtype, offset):
    """scale in another dtype than x (read as it is for f32 and bf16, cast
    for the rest), and x a view ``offset`` elements into its storage (scalar
    loads when not 4-element aligned)."""
    from repro_torch.kernels import rmsnorm as rn
    dev = _device()
    rows, d = 19, 512
    g = torch.Generator(device=dev).manual_seed(offset)
    x = torch.randn(rows * d + offset, generator=g, device=dev).to(dtype)[offset:].view(rows, d)
    s = torch.randn(d, generator=g, device=dev).to(sdtype)
    y = rn.rmsnorm_fwd(x, s)
    torch.testing.assert_close(y.float(), ref.ref_rmsnorm(x, s).float(),
                               **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sdtype,rows,d,offset", [
    (torch.float32, torch.float32, 4097, 2048, 0),   # a block a row, 2 vectors a thread
    (torch.bfloat16, torch.bfloat16, 4097, 2048, 0),
    (torch.float32, torch.bfloat16, 4097, 512, 0),   # a warp a row, bf16 scale read as is
    (torch.bfloat16, torch.float32, 4097, 96, 0),    # several rows a warp
    (torch.float32, torch.float32, 4097, 96, 0),
    (torch.float32, torch.float32, 301, 512, 1),     # an unaligned view: scalar loads
    (torch.bfloat16, torch.bfloat16, 301, 2048, 3),
    (torch.float32, torch.float16, 33, 8192, 0),     # 8 vectors a thread, scale cast
    (torch.float32, torch.float32, 33, 20000, 0),    # a row read twice
])
def test_rmsnorm_bwd_is_deterministic_at_each_row_split(dtype, sdtype, rows, d, offset):
    """rmsnorm_bwd against the plain version at each of its row splits,
    with rows that fill no grid evenly (4097), on views ``offset`` elements
    into their storage, with scale in another dtype than x; a second call
    gives the same bits (each block's partials, and their sum, in a fixed
    order)."""
    from repro_torch.kernels import rmsnorm as rn
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(rows + d + offset)

    def view():
        flat = torch.randn(rows * d + offset, generator=g, device=dev).to(dtype)
        return flat[offset:].view(rows, d)

    x, cot = view(), view()
    s = torch.randn(d, generator=g, device=dev).to(sdtype)
    before = rn.launches["rmsnorm_bwd"]
    dx, ds = rn.rmsnorm_bwd(x, s, cot)
    assert rn.launches["rmsnorm_bwd"] == before + 1
    assert dx.dtype == dtype and ds.dtype == sdtype
    want_dx, want_ds = ref.ref_rmsnorm_bwd(x, s, cot)
    tol = F32 if dtype == sdtype == torch.float32 else BF16
    torch.testing.assert_close(dx.float(), want_dx.float(), **tol)
    # dscale sums the rows in another order: relative to its largest element
    top = float(want_ds.float().abs().max())
    torch.testing.assert_close(ds.float() / top, want_ds.float() / top, **tol)
    dx2, ds2 = rn.rmsnorm_bwd(x, s, cot)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
def test_rmsnorm_autograd_goes_through_both_kernels():
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    dev = _device()
    x = torch.randn(4, 3, 96, device=dev, requires_grad=True)
    s = torch.randn(96, device=dev, requires_grad=True)
    before = dict(rn.launches)
    ops.rmsnorm(x, s).square().sum().backward()
    xr, sr = x.detach().clone().requires_grad_(), s.detach().clone().requires_grad_()
    ref.ref_rmsnorm(xr, sr).square().sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s.grad, sr.grad, rtol=1e-4, atol=1e-4)
    assert rn.launches["rmsnorm_fwd"] == before["rmsnorm_fwd"] + 1
    assert rn.launches["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mobilenet-v2", "shufflenet-v2"])
def test_cnn_forward_on_the_card_goes_through_the_kernel(arch):
    """The reduced CNNs' logits through the depthwise kernel against the
    plain path on the card (TF32 off for the convs)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_cnn_batch
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.models import build_model
    dev = _device()
    cfg = dataclasses.replace(get_config(arch).reduced(), cnn_stages=(2, 2, 2) if
                              arch == "shufflenet-v2" else (1, 2, 3, 4, 3, 3, 1))
    b = synthetic_cnn_batch(np.random.default_rng(0), 8, cfg.image_size,
                            cfg.in_channels, cfg.n_classes)
    b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_model(cfg, impl="pallas", device=dev)
        params = model.init(model.generator(0))
        before = dw.launches["depthwise_conv"]
        with torch.no_grad():
            got = model.forward(params, b)
            n = dw.launches["depthwise_conv"] - before
            want = build_model(cfg, impl="naive", device=dev).forward(params, b)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert n == (13 if arch == "mobilenet-v2" else 3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# compiled steps: CUDA graphs captured and replayed (launch/steps.CompiledStep)
# ---------------------------------------------------------------------------


@pytest.fixture
def freed():
    """Memory freed before and after a test that holds a full-width state and
    graphs: a graph's pool keeps what its capture used reserved."""
    _free()
    yield
    _free()


def _llama(width):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    return cfg.reduced() if width == "reduced" else cfg


def _serve_requests(cfg, gen):
    """10 requests: five share a 12-token prefix, two are identical (a
    full-prompt hit and a copy-on-write), prompts of 13 to 29 tokens."""
    import numpy as np
    from repro_torch.launch import serve
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([prefix if u < 5 else rng.integers(0, cfg.vocab_size, 12),
                               rng.integers(0, cfg.vocab_size, 1 + 2 * u)])
               for u in range(10)]
    prompts[1] = prompts[0]
    return [serve.Request(uid=u, prompt=p.astype(np.int32), max_new_tokens=gen)
            for u, p in enumerate(prompts)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("layout,policy,depth", [
    ("contig", "serialize", 0), ("paged", "serialize", 0), ("paged", "swap", 0),
    ("contig", "serialize", 4), ("paged", "serialize", 4),
    ("contig", "serialize", 32), ("paged", "serialize", 32)])
def test_compiled_serve_matches_eager(freed, width, layout, policy, depth):
    """8 slots served with the steps captured (the default) and eagerly
    (``jit=False``): token-identical streams, the same launch counts, and
    each step replayed. Paged runs hold a copy-on-write; the swap policy's
    pool is cut so that residents go to the host and come back; draft depth
    4 verifies windows of S = 5 down to 2 (the clamp at the end of each
    budget), depth 32 windows of S = 33."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = _llama(width)
    gen = 40 if depth == 32 else 12
    max_seq = 96 if depth == 32 else 64
    model = build_model(cfg, impl="pallas", device=dev)
    params = model.init(model.generator(0))
    kw = dict(max_batch=8, max_seq=max_seq, kv_layout=layout, block_size=4,
              draft_depth=depth, admission_policy=policy)
    if policy == "swap":
        kw["num_blocks"] = 40  # 8 residents need up to 8 x 11 blocks
    runs = {}
    for jit in (False, True):
        engine = serve.ContinuousBatchingEngine(model, params, jit=jit, **kw)
        depths = []
        spec_k = engine._spec_k
        engine._spec_k = lambda active: depths.append(spec_k(active)) or depths[-1]
        fa.reset_launches()
        done = engine.run(_serve_requests(cfg, gen))
        del engine._spec_k, spec_k  # no cycle keeps the engine alive
        step = engine._spec_decode if depth else engine._decode
        # each graph's signature: the params' and cache's leaves, then the
        # window of tokens (B, S)
        n_state = len(tree_leaves_(params)) + len(tree_leaves_(engine.cache))
        runs[jit] = dict(
            streams={u: f.tokens for u, f in done.items()},
            launches=fa.all_launches(), stats=engine.stats(),
            depths=sorted(set(depths)),
            step={k: getattr(step, k, None) for k in ("captures", "replays",
                                                      "last_call")},
            windows={sig[1][n_state][1][1] for sig in getattr(step, "_graphs", ())})
        del engine, step
    e, j = runs[False], runs[True]
    assert j["streams"] == e["streams"]
    assert j["launches"] == e["launches"] and sum(j["launches"].values()) > 0
    assert j["depths"] == e["depths"]
    if layout == "paged":
        assert j["stats"]["cow_copies"] >= 1
    if policy == "swap":
        assert j["stats"]["swap_outs"] > 0
        assert j["stats"]["swap_ins"] == j["stats"]["swap_outs"]
    if depth:
        want = {4: {1, 2, 3, 4}, 32: {32}}[depth]
        assert want <= set(j["depths"]), j["depths"]
        assert {k + 1 for k in want} <= j["windows"], j["windows"]
    assert j["step"]["captures"] >= 1
    assert j["step"]["replays"] > j["step"]["captures"]
    assert j["step"]["last_call"] == "replay"


@pytest.mark.cuda
@pytest.mark.parametrize("layout,policy,depth", [
    ("contig", "serialize", 0), ("paged", "serialize", 0), ("paged", "swap", 0),
    ("contig", "serialize", 4), ("paged", "serialize", 4)])
def test_compiled_sampled_serve_matches_eager(freed, monkeypatch, layout, policy,
                                              depth):
    """Sampled serving (temperature 0.9, top-k 32) at the reduced width, with
    the steps captured and eagerly: token-identical streams and launch
    counts, each step replayed, the decode graphs taking the (8, 2) int64
    keys as an input, and no (B, V) logits brought to the host
    (``Tensor.cpu`` watched). Temperature 5 with top-k 1 gives the greedy
    streams, captured."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = _llama("reduced")
    model = build_model(cfg, impl="pallas", device=dev)
    params = model.init(model.generator(0))
    kw = dict(max_batch=8, max_seq=64, kv_layout=layout, block_size=4,
              draft_depth=depth, admission_policy=policy)
    if policy == "swap":
        kw["num_blocks"] = 40
    moved, real_cpu = [], torch.Tensor.cpu

    def cpu(self, *a, **k):
        moved.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    runs = {}
    for name, jit, sample in (("eager", False, dict(temperature=0.9, top_k=32)),
                              ("captured", True, dict(temperature=0.9, top_k=32)),
                              ("greedy", True, {}),
                              ("top1", True, dict(temperature=5.0, top_k=1))):
        engine = serve.ContinuousBatchingEngine(model, params, jit=jit,
                                                sample_seed=1, **sample, **kw)
        fa.reset_launches()
        done = engine.run(_serve_requests(cfg, 12))
        step = engine._spec_decode if depth else engine._decode
        runs[name] = dict(streams={u: f.tokens for u, f in done.items()},
                          launches=fa.all_launches(), stats=engine.stats(),
                          captures=getattr(step, "captures", None),
                          replays=getattr(step, "replays", None),
                          sigs=list(getattr(engine._decode, "_graphs", ())))
        del engine, step
    e, j = runs["eager"], runs["captured"]
    assert j["streams"] == e["streams"] != runs["greedy"]["streams"]
    assert runs["top1"]["streams"] == runs["greedy"]["streams"]
    assert j["launches"] == e["launches"] and sum(j["launches"].values()) > 0
    assert j["captures"] >= 1 and j["replays"] > j["captures"]
    if not depth:  # the sampled decode graph's keys input
        assert any(k[:3] == ("tensor", (8, 2), torch.int64)
                   for sig in j["sigs"] for k in sig[1]), j["sigs"]
    if policy == "swap":
        assert j["stats"]["swap_outs"] > 0
    assert not [s for s in moved if s and s[-1] == cfg.vocab_size], moved


class _CountingStep:
    """A compiled step's calls counted by how each ran (``last_call``:
    warmup, capture or replay); every other attribute is the step's."""

    def __init__(self, step):
        import collections
        self.step, self.calls = step, collections.Counter()

    def __call__(self, *args):
        out = self.step(*args)
        self.calls[self.step.last_call] += 1
        return out

    def __getattr__(self, name):
        return getattr(self.step, name)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,depth", [("contig", 0), ("paged", 0),
                                          ("contig", 4), ("paged", 4)])
def test_serve_spans_around_captured_steps(freed, layout, depth):
    """llama3.2-1b reduced, 8 slots, the decode and verify steps captured:
    a span wraps the engine's call of a step from the host, so
    ``serve.decode`` counts every decode call and ``serve.spec_verify``
    every verify round, whether the call ran eagerly, captured or replayed;
    every span argument is a Python int; the speculation counters equal the
    engine's; and the streams with telemetry on are those with it off."""
    import collections
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = _llama("reduced")
    model = build_model(cfg, impl="pallas", device=dev)
    params = model.init(model.generator(0))
    runs = {}
    for enabled in (False, True):
        tel = obs.Telemetry(enabled=enabled)
        prev = obs.set_telemetry(tel)
        try:
            engine = serve.ContinuousBatchingEngine(
                model, params, max_batch=8, max_seq=64, kv_layout=layout,
                block_size=4, draft_depth=depth)
            engine._decode = decode = _CountingStep(engine._decode)
            engine._spec_decode = verify = _CountingStep(engine._spec_decode)
            done = engine.run(_serve_requests(cfg, 12))
        finally:
            obs.set_telemetry(prev)
        runs[enabled] = dict(
            streams={u: f.tokens for u, f in done.items()},
            spans=[(s.name, s.args) for s in tel.tracer.spans()],
            metrics={k: v["series"][0]["value"] for k, v in
                     tel.metrics.snapshot()["metrics"].items()},
            decode=decode.calls, verify=verify.calls, stats=engine.stats())
        del engine, decode, verify
    on, off = runs[True], runs[False]
    assert on["streams"] == off["streams"] and off["spans"] == []
    names = collections.Counter(n for n, _ in on["spans"])
    assert names["serve.decode"] == sum(on["decode"].values())
    assert names["serve.spec_verify"] == sum(on["verify"].values())
    assert names["serve.decode"] + names["serve.spec_verify"] == \
        on["stats"]["decode_steps"]
    ran = on["verify"] if depth else on["decode"]
    assert {"warmup", "capture", "replay"} <= set(ran), ran
    for name, args in on["spans"]:
        for k, v in args.items():
            assert type(v) is int or (k == "readonly" and v is True), \
                (name, k, type(v))
    if layout == "paged":
        assert names["serve.prefill_chunk"] == on["stats"]["prefill_chunks"]
        assert names["serve.cow_copy"] == on["stats"]["cow_copies"] >= 1
    else:
        assert names["serve.prefill"] == len(on["streams"])
    if depth:
        assert names["serve.spec_draft"] == names["serve.spec_verify"]
        assert on["metrics"]["spec_drafted_total"] == on["stats"]["spec_drafted"]
        assert on["metrics"]["spec_accepted_total"] == \
            on["stats"]["spec_accepted"]


@pytest.mark.cuda
def test_prng_on_the_card_matches_the_cpu():
    """(8, 128256) random bits and uniforms on the card equal the CPU's from
    the same keys, bit for bit; Gumbel noise within 1e-6."""
    import numpy as np
    from repro_torch import prng
    dev = _device()
    keys = torch.as_tensor(prng.fold_in(prng.fold_in(prng.PRNGKey(3), np.arange(8)),
                                        np.arange(8) * 7))
    V = 128256
    assert torch.equal(prng.random_bits(keys.to(dev), (V,)).cpu(),
                       prng.random_bits(keys, (V,)))
    assert torch.equal(prng.uniform(keys.to(dev), (V,)).cpu(),
                       prng.uniform(keys, (V,)))
    torch.testing.assert_close(prng.gumbel(keys.to(dev), (V,)).cpu(),
                               prng.gumbel(keys, (V,)), rtol=1e-6, atol=1e-6)


def _recording_optimizer():
    """An optimizer that copies each step's gradients into its state and
    updates nothing: a captured train step's gradients, read back."""
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.tree import tree_map

    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        tree_map(lambda s, g: s.copy_(g), state, grads)
        return tree_map(lambda g: g.new_zeros(()), grads), state  # broadcast 0

    return Optimizer("record_grads", init, update, 4)


def _train_runs(width, microbatch, jit, steps, migrate=False, remat="none"):
    """``steps`` adam steps of llama3.2-1b (``width``) at batch 4 x 64 through
    ``Rung.jitted_step``; with ``migrate``, steps 2-3 on a bf16 rung at
    microbatch 4 and the rest back on f32 (full -> lean -> full, the
    parameters cast each way; the old parameters are kept, so the cast
    ones lie elsewhere). Returns (losses, first-step gradients, the full
    rung's compiled step's captures, replays and last call, the launches of
    each step). The gradients are those of the third call of a step that
    records them: a replay when ``jit``. ``remat`` sets the full rung's
    activation checkpointing."""
    import numpy as np
    from repro_torch.engine.rungs import Rung
    from repro_torch.launch.steps import cast_params, init_train_state
    from repro_torch.optim.optimizers import adam
    dev = _device()
    cfg = _llama(width)
    full = Rung(name="full", microbatch=microbatch, attn_impl="pallas",
                remat=remat)
    lean = Rung(name="lean", microbatch=4, attn_impl="pallas",
                param_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)}
               for _ in range(steps)]
    model = full.build_model(cfg, dev)
    record = _recording_optimizer()
    state = init_train_state(model, record, model.generator(0))
    for _ in range(3):
        state, _ = full.jitted_step(cfg, record, device=dev, jit=jit)(
            state, batches[0])
    grads = tree_leaves_(state["opt"])
    del state
    full.invalidate()
    state = init_train_state(model, adam(), model.generator(0))
    losses, counts, kept = [], [], []
    for i in range(steps):
        rung = lean if migrate and i in (2, 3) else full
        if migrate and i in (2, 4):
            kept.append(state["params"])
            state = dict(state, params=cast_params(state["params"], rung.dtype))
        before = fa.all_launches()
        state, metrics = rung.jitted_step(cfg, adam(), lr=1e-4, device=dev,
                                          jit=jit)(state, batches[i])
        losses.append(float(metrics["loss"]))
        after = fa.all_launches()
        counts.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
    assert int(state["step"]) == steps and int(state["opt"]["t"]) == steps
    step = full.jitted_step(cfg, adam(), lr=1e-4, device=dev, jit=jit)
    calls = tuple(getattr(step, k, None) for k in ("captures", "replays", "last_call"))
    del state, kept, step
    full.invalidate()
    lean.invalidate()
    _free()
    return losses, grads, calls, counts


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def tree_leaves_(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _rel(a, b):
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / den) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_compiled_train_step_matches_eager(freed, width, microbatch):
    """4 adam steps captured and eager: losses within 1e-3, first-step
    gradients within 1e-4 (norm-wise), the same launches every step, and
    the calls warm-up, capture, replay, replay."""
    import numpy as np
    got = _train_runs(width, microbatch, True, 4)
    want = _train_runs(width, microbatch, False, 4)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert _rel(got[1], want[1]) <= 1e-4
    assert got[3] == want[3]
    assert got[2] == (1, 3, "replay")  # captures, replays, the last call


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_compiled_remat_train_step_matches_eager_and_none(freed, width, remat):
    """A remat rung's step captured: its recomputation runs inside the CUDA
    graph. 4 adam steps captured and eager, and without remat: losses
    within 1e-3, first-step gradients within 1e-4 (norm-wise) of both, the
    same launches captured and eager, the calls warm-up, capture, replay,
    replay; the recomputed forward launches flash_fwd a second time in
    every layer, the backward kernels once."""
    import numpy as np
    from repro_torch.configs import get_config
    got = _train_runs(width, 1, True, 4, remat=remat)
    eager = _train_runs(width, 1, False, 4, remat=remat)
    none = _train_runs(width, 1, True, 4)
    for want in (eager, none):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
        assert _rel(got[1], want[1]) <= 1e-4
    assert got[3] == eager[3]
    assert got[2] == (1, 3, "replay")
    n = get_config("llama3.2-1b").n_layers if width == "full" else \
        get_config("llama3.2-1b").reduced().n_layers
    for counts, base in zip(got[3], none[3]):
        assert counts["flash_fwd"] == 2 * base["flash_fwd"] == 2 * n
        assert counts["flash_bwd_dq"] == base["flash_bwd_dq"] == n
        assert counts["flash_bwd_dkv"] == base["flash_bwd_dkv"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_compiled_train_migration_recaptures(freed, width):
    """full -> lean (bf16) -> full: the full rung's graph sees its
    parameters at new addresses and captures again; losses stay within 1e-3
    of the eager run's, the launch counts equal its."""
    import numpy as np
    got = _train_runs(width, 1, True, 6, migrate=True)
    want = _train_runs(width, 1, False, 6, migrate=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert got[3] == want[3]
    assert got[2][0] == 2 and got[2][2] == "replay"  # captured again, replayed


@pytest.mark.cuda
def test_replay_launches_no_wrapper(freed, monkeypatch):
    """After the warm-up call and the capture, a call runs no wrapper: with
    every launch entry made to raise, the decode step and the train step
    still run, their results equal eager ones, and the launch counts rise
    by what one eager call adds."""
    import numpy as np
    from repro_torch.engine.rungs import Rung
    from repro_torch.launch.steps import build_decode_step, init_train_state
    from repro_torch.optim.optimizers import adam
    dev = _device()
    cfg = _llama("reduced")
    model = Rung(name="r", attn_impl="pallas").build_model(cfg, dev)
    params = model.init(model.generator(0))
    cache = model.init_cache(4, 64, torch.float32)
    tokens = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
    cache_len = torch.tensor([3, 0, 17, 40], dtype=torch.int32, device=dev)
    step, eager = build_decode_step(model), build_decode_step(model, jit=False)
    for _ in range(2):
        step(params, cache, tokens, cache_len)
    rung = Rung(name="r", attn_impl="pallas")
    state = init_train_state(model, adam(), model.generator(0))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)}
    train = rung.jitted_step(cfg, adam(), device=dev)
    for _ in range(2):
        train(state, batch)
    before_cache = {k: v.clone() for k, v in cache.items()}

    def refuse(*a, **k):
        raise AssertionError("a replay called a kernel wrapper")

    for mod, name in ((fa, "_decode_launch"), (fa, "_fwd_lse"), (fb, "flash_bwd_dq"),
                      (fb, "flash_bwd_dkv")):
        monkeypatch.setattr(mod, name, refuse)
    before = fa.all_launches()
    tok, _, _ = step(params, cache, tokens, cache_len)
    _, metrics = train(state, batch)
    after = fa.all_launches()
    assert step.last_call == "replay" and train.last_call == "replay"
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "flash_decode": cfg.n_layers, "flash_fwd": cfg.n_layers,
        "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
    assert bool(torch.isfinite(metrics["loss"]))
    monkeypatch.undo()
    want, _, _ = eager(params, before_cache, tokens, cache_len)
    assert torch.equal(tok, want)
    for k in cache:
        torch.testing.assert_close(cache[k], before_cache[k], rtol=0, atol=0)


@pytest.mark.cuda
def test_capture_of_a_step_that_syncs_raises():
    """A step that reads a value back to the host runs eagerly on its first
    call and raises, naming the step, when the second call captures it;
    the card goes on working after."""
    from repro_torch.launch.steps import CompiledStep
    dev = _device()

    def syncing(state, x):
        state["w"].add_(x)
        return float(state["w"].sum())  # a device-to-host read

    step = CompiledStep(syncing, "syncing_step", state_argnums=(0,))
    state = {"w": torch.zeros(8, device=dev)}
    x = torch.ones(8, device=dev)
    assert step(state, x) == 8.0 and step.last_call == "warmup"
    with pytest.raises(RuntimeError, match="syncing_step"):
        step(state, x)
    assert step.captures == 0
    y = torch.ones(8, device=dev) * 2
    assert float(y.sum()) == 16.0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_arrival_counts_do_not_grow_during_capture():
    """The split kernels' arrival counts are sized by the eager first call
    on the capture stream; a buffer replaced by a larger one stays
    allocated, since a graph may address it."""
    dev = _device()
    side = torch.cuda.Stream(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.stream(side):
        small = fa._arrivals(index, side.cuda_stream, 8)
        big = fa._arrivals(index, side.cuda_stream, 64)
    assert big.numel() >= 64 and any(b is small for b in fa._RETIRED)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g, stream=side):
            fa._arrivals(index, side.cuda_stream, 128)


# ---------------------------------------------------------------------------
# the measured rung profiler (core/profiler.profile_rung)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_profile_rung_times_replays_on_the_card(freed):
    """The default ladder at reduced width, batch 4 x 64, one state carried
    from rung to rung: each rung's first two calls are its eager step and
    its capture, the timed ones replays (at least three); latency positive,
    peak memory non-zero and within the card's, power read by nvidia-smi;
    the steps train (the state's step counter counts them all)."""
    import numpy as np
    from repro_torch.core.profiler import profile_rung
    from repro_torch.engine.rungs import default_rung_ladder
    from repro_torch.launch.steps import init_train_state
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import adam
    dev = _device()
    cfg = _llama("reduced")
    rungs = default_rung_ladder(batch=4, attn_impl="pallas")
    model = rungs[0].build_model(cfg, dev)
    state = init_train_state(model, adam(), model.generator(0))
    batch_fn = make_batch_fn(cfg, 4, 64)
    step = 0
    for i, rung in enumerate(rungs):
        before = fa.all_launches()["flash_fwd"]
        prof, state = profile_rung(rung, cfg, state, optimizer=adam(), batch_fn=batch_fn,
                                   start=step, lr=1e-4, position=i, n=len(rungs),
                                   device=dev)
        step += prof.meta["steps"]
        calls = prof.meta["calls"]
        assert calls[:2] == ["warmup", "capture"] and len(calls) >= 5
        assert set(calls[2:]) == {"replay"} and len(prof.meta["step_s"]) == len(calls) - 2
        assert prof.latency_s > 0 and prof.latency_s == float(np.median(prof.meta["step_s"]))
        assert 0 < prof.memory_bytes <= torch.cuda.get_device_properties(dev).total_memory
        assert prof.power_w > 0 and prof.meta["power"].startswith("nvidia-smi")
        assert prof.energy_j == prof.power_w * prof.latency_s
        assert prof.cost_key == (len(rungs) - i,) and prof.choice is rung
        assert all(np.isfinite(prof.meta["losses"]))
        assert fa.all_launches()["flash_fwd"] - before == \
            cfg.n_layers * rung.microbatch * len(calls)
        assert rung._step is None  # the graphs were dropped
        assert state["params"]["embed"].dtype == rung.dtype
    assert int(state["step"]) == step


# ---------------------------------------------------------------------------
# a KV cache in a dtype other than the queries' (the serve-lean rung)
# ---------------------------------------------------------------------------

MIXED_PAIRS = [(torch.float32, torch.bfloat16, False), (torch.float32, torch.bfloat16, True),
               (torch.bfloat16, torch.float32, False), (torch.bfloat16, torch.float32, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt,lowp", MIXED_PAIRS)
@pytest.mark.parametrize("name", ["flash_decode", "flash_decode_paged", "flash_decode_spec",
                                  "flash_decode_spec_paged"])
@pytest.mark.parametrize("T", [6, 64])
def test_mixed_dtype_decode_matches_plain(name, qdt, kvdt, lowp, T):
    """Each decode kernel with q and the cache in two dtypes, against the
    plain version at ragged lengths including 0, the capacity and past it
    (bs 16, T 6 or 64 table entries: one split or several; speculative S =
    5); launched once a call, counted as its mixed-dtype instantiation, and
    the output in q's dtype: f32 q to 2e-5 (bf16 cache values are exact in
    f32), a bf16 output to 2e-5 of the plain version's f32 result beside its
    own rounding; with lowp, 5e-2."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(T + 3 * lowp)
    B, K, G, hd, bs, S = 5, 2, 4, 64, 16, 5
    cap = bs * T
    spec, paged = "spec" in name, name.endswith("paged")
    q = torch.randn((B, K) + ((S,) if spec else ()) + (G, hd), generator=g,
                    device=dev).to(qdt)
    lens = torch.tensor([0, 7, cap // 2 + 3, cap, cap + 1], dtype=torch.int32, device=dev)
    if paged:
        kp, vp, table = _pool_and_table(g, dev, kvdt, B, K, hd, hd, bs, T)
        args = (q, kp, vp, table, lens)
    else:
        k, v = (torch.randn(B, cap, K, hd, generator=g, device=dev).to(kvdt) for _ in range(2))
        args = (q, k, v, lens)
    key = f"{name}:{str(qdt)[6:]}:{str(kvdt)[6:]}"
    before, mixed = fa.launches[name], fa.mixed_launches[key]
    out = getattr(fa, name)(*args, lowp=lowp)
    assert fa.launches[name] == before + 1 and fa.mixed_launches[key] == mixed + 1
    assert out.dtype == qdt
    plain = getattr(ref, f"ref_{name}")
    if lowp:
        torch.testing.assert_close(out.float(), plain(*args, lowp=True).float(), **BF16)
    elif qdt == torch.bfloat16:
        _assert_bf16_out_close(out, plain(q.float(), *args[1:]), F32)
    else:
        torch.testing.assert_close(out, plain(*args), **F32)
    if not spec:
        assert not out[0].any(), "a length-0 row must return zeros"
    assert torch.equal(out, getattr(fa, name)(*args, lowp=lowp))


@pytest.mark.cuda
def test_set_kv_dtype_round_trips_on_a_captured_engine(freed):
    """An engine walked f32 -> bf16 -> f32 twice while it decodes, through
    ServeJob's migrations on the default serve ladder: each cache dtype's
    decode graph is captured once (the walk back replays it), the second
    walk allocates nothing (peak and reserved memory unchanged), the cache
    is back in f32 at the top rung, and the streams finish."""
    from repro_torch.engine.jobs import ServeJob, default_serve_ladder
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = _llama("reduced")
    model = build_model(cfg, impl="pallas", device=dev)
    params = model.init(model.generator(0))
    engine = serve.ContinuousBatchingEngine(model, params, max_batch=8, max_seq=96)
    reqs = [serve.Request(uid=u, prompt=r.prompt, max_new_tokens=60)
            for u, r in enumerate(_serve_requests(cfg, 60)[:8])]
    job = ServeJob(engine, reqs, rungs=default_serve_ladder(8), adaptive=False)
    job.prepare()
    tick = 0

    def run(n):
        nonlocal tick
        for _ in range(n):
            job.step(tick)
            tick += 1

    run(3)  # eager, capture, replay at serve-full
    torch.cuda.synchronize()
    marks = []
    for walk in range(2):
        for direction in ("down", "down", "up", "up"):
            job.migrate(direction, "test", tick)
            run(3)
        torch.cuda.synchronize()
        marks.append((torch.cuda.max_memory_allocated(dev), torch.cuda.memory_reserved(dev),
                      engine._decode.captures))
    assert job.active_rung.name == "serve-full" and engine.cache["k"].dtype == torch.float32
    assert set(engine._kv_store) == {torch.float32, torch.bfloat16}
    assert marks[0][2] == marks[1][2] == 2, marks  # one capture per cache dtype
    assert marks[1][:2] == marks[0][:2], marks  # the second walk allocated nothing
    assert fa.mixed_launches["flash_decode:float32:bfloat16"] > 0
    engine.run([])
    assert sorted(engine.finished) == list(range(8))


@pytest.mark.cuda
def test_mixed_cli_on_the_card(freed, tmp_path):
    """``launch.mixed.main`` at the reduced size on the card: training and
    serving under one arbiter, the shared thermal trace forcing a
    downgrade, the serve job's decode steps captured and replayed."""
    import json

    import numpy as np
    from repro_torch.engine.timeline import Timeline
    from repro_torch.launch import mixed
    _device()
    out = str(tmp_path / "merged.json")
    fa.reset_launches()
    res = mixed.main(["--arch", "llama3.2-1b", "--reduced", "--ticks", "16",
                      "--batch", "8", "--seq", "64", "--attn-impl", "pallas",
                      "--slots", "4", "--requests", "8", "--prompt-len", "16",
                      "--gen", "12", "--max-seq", "512", "--thermal-trace",
                      "0.5:0.3:4.0", "--quiet", "--timeline-out", out])
    with open(out) as f:
        tl = Timeline.from_json(json.load(f))
    assert set(tl.jobs()) == {"train", "serve"}
    assert any(m.reason in ("interference", "arbitration") for m in tl.migrations)
    assert len(res.jobs["train"].result().losses) == 16
    assert all(np.isfinite(res.jobs["train"].result().losses))
    serve_job = res.jobs["serve"]
    assert serve_job.result()
    steps = serve_job.engine.compiled_steps()
    assert sum(f.captures for f in steps) >= 1 and sum(f.replays for f in steps) > 0
    launches = fa.all_launches()
    assert launches["flash_decode"] > 0 and launches["flash_fwd"] > 0
    assert launches["flash_bwd_dq"] > 0


# ---------------------------------------------------------------------------
# federated learning: the real FedAvg cohort (fl/real.py)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_run_real_on_the_card(freed, monkeypatch):
    """``fl.real.run_real`` at the reduced ResNet34, 2 clients x 2 rounds x 2
    local steps: captured against eager from the same seeded parameters
    (losses to 1e-3 relative), one capture for the whole cohort, and each
    round's fedavg on the card within 1e-6 of each leaf's largest magnitude
    of a float64 host mean of the same deltas. On deterministic cuDNN
    algorithms: the default conv backward sums with atomics, so two runs of
    the same steps differ, and sgd steps amplify it."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.fl.real import run_real
    _device()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = get_config("resnet34").reduced()
    errs = []

    def check(rnd, glob, deltas, new):
        for g, n, *ds in zip(*(tree_leaves_(t) for t in [glob, new] + deltas)):
            want = g.double().cpu().numpy() + np.mean(
                np.stack([d.double().cpu().numpy() for d in ds]), 0)
            got = n.double().cpu().numpy()
            assert n.device == g.device and n.dtype == g.dtype
            errs.append(float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))

    sizes = dict(n_clients=2, rounds=2, local_steps=2)
    cap = run_real(cfg, jit=True, on_aggregate=check, **sizes)
    eager = run_real(cfg, jit=False, **sizes)
    assert cap.captures == 1 and eager.captures == 0
    assert all(np.isfinite(cap.losses)) and all(np.isfinite(eager.losses))
    np.testing.assert_allclose(cap.losses, eager.losses, rtol=1e-3)
    assert errs and max(errs) <= 1e-6, max(errs)
    assert all(p.is_cuda for p in tree_leaves_(cap.params))


# ---------------------------------------------------------------------------
# the deepseek family: the MLA latent decode kernel (csrc/flash_decode_mla.cu)
# and the moe engines
# ---------------------------------------------------------------------------

# deepseek-v3's latent geometry: H = G = 128 query rows over one latent
# head, keys [latent | k_rope] of 512 + 64, values the 512-wide latent, scale
# 1/sqrt(128 + 64); and an odd one (H not a multiple of the 32-row groups)
MLA_GEOMETRIES = {"deepseek-v3": (128, 512, 64), "odd": (40, 64, 16)}


def _mla_inputs(g, dev, dtype, B, H, r, rd, n, paged):
    """Queries (f32), caches of ``n`` positions a row (or pools of B * T + 1
    blocks of 16 and a shuffled table, the first row an idle slot's at null
    block 0), in ``dtype``."""
    q_lat = torch.randn(B, H, r, generator=g, device=dev)
    q_rope = torch.randn(B, H, rd, generator=g, device=dev)
    if not paged:
        return q_lat, q_rope, (torch.randn(B, n, r, generator=g, device=dev) * 0.3).to(dtype), \
            torch.randn(B, n, rd, generator=g, device=dev).to(dtype)
    bs, T = 16, -(-n // 16)
    NB = B * T + 1
    lat = (torch.randn(NB, bs, r, generator=g, device=dev) * 0.3).to(dtype)
    kr = torch.randn(NB, bs, rd, generator=g, device=dev).to(dtype)
    table = (torch.randperm(B * T, generator=g, device=dev) + 1).reshape(B, T)
    table[0] = 0
    table[2, T - 1] = NB + 5  # past the pool: clamped
    return q_lat, q_rope, lat, kr, table.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype,lowp", [(torch.float32, False), (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("geometry", sorted(MLA_GEOMETRIES))
def test_mla_decode_kernel_matches_plain(geometry, dtype, lowp, paged):
    """flash_decode_mla(_paged) against its plain version: f32 q over a bf16
    and an f32 cache of 1000 positions a row (a multiple of neither key tile,
    32 and 16 positions, nor of the 64-position table entries), lengths 0,
    1, past the capacity (a retired slot), and ragged; one launch a call,
    two calls the same bits, the arrival counts zero after."""
    dev = _device()
    H, r, rd = MLA_GEOMETRIES[geometry]
    B, n = 6, 1000
    g = torch.Generator(device=dev).manual_seed(H + r)
    args = _mla_inputs(g, dev, dtype, B, H, r, rd, n, paged)
    cap = n if not paged else 16 * args[-1].shape[1]
    lens = torch.tensor([0, 1, cap + 1, 37, 517, n - 1], dtype=torch.int32, device=dev)
    scale = 1.0 / (192 ** 0.5)
    name = "flash_decode_mla_paged" if paged else "flash_decode_mla"
    kernel, plain = getattr(fa, name), getattr(ref, "ref_" + name)
    tab = (args[-1].clamp(0, args[2].shape[0] - 1),) if paged else ()
    before = fa.launches[name]
    out = kernel(*args, lens, scale=scale, lowp=lowp)
    assert fa.launches[name] == before + 1
    assert out.shape == (B, H, r) and out.dtype == torch.float32
    want = plain(*args[:4], *tab, lens, scale=scale, lowp=lowp)
    torch.testing.assert_close(out, want, **(BF16 if lowp else F32))
    assert not out[0].any(), "a length-0 row must return zeros"
    assert torch.equal(out, kernel(*args, lens, scale=scale, lowp=lowp))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = fa._ARRIVALS.get((dev.index or torch.cuda.current_device(), stream))
    assert buf is None or not buf.any()


@pytest.mark.cuda
def test_mla_decode_wrappers_refuse_what_the_kernel_does_not_take():
    dev = _device()
    q_lat, q_rope = torch.zeros(1, 4, 520, device=dev), torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(RuntimeError, match="8 <= r <= 512"):
        fa.flash_decode_mla(q_lat, q_rope, torch.zeros(1, 8, 520, device=dev),
                            torch.zeros(1, 8, 64, device=dev), 3, scale=0.1)
    with pytest.raises(RuntimeError, match="flash_decode_mla failed.*multiples of 8"):
        fa.flash_decode_mla(q_lat[..., :20], q_rope, torch.zeros(1, 8, 20, device=dev),
                            torch.zeros(1, 8, 64, device=dev), 3, scale=0.1)


def _deepseek(name):
    """deepseek-v3-671b cut to 4 layers (3 dense MLA layers, 1 MLA + MoE
    layer) with 16 of its 256 routed experts, at full width otherwise; or
    deepseek-moe-16b cut to 4 layers (1 dense, 3 MoE) at full width: f32
    states of 18 and 9 GB."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if name == "deepseek-v3-671b":
        return dataclasses.replace(cfg, n_layers=4, n_experts=16)
    return dataclasses.replace(cfg, n_layers=4)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,depth", [("contig", 0), ("paged", 0), ("contig", 3)])
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "deepseek-moe-16b"])
def test_deepseek_engine_streams_kernel_against_plain(freed, name, layout, depth):
    """Greedy streams of ``attn_impl="pallas"`` (the MLA latent decode, or
    the GQA decode and verify kernels at G 1 hd 128; captured steps) equal
    the plain path's (``naive``), f32 weights and cache: 4 slots, 6 requests
    of 20-44 tokens, 8 new tokens (slots retire and ride along idle). MLA
    has no verify step, so its draft depth decodes one token a step."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = _device()
    cfg = _deepseek(name)
    rng = np.random.default_rng(2)
    reqs = [serve.Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, 20 + 5 * u
                                                      ).astype(np.int32),
                          max_new_tokens=8 - u % 3) for u in range(6)]
    kw = dict(max_batch=4, max_seq=64, kv_layout=layout, block_size=16, draft_depth=depth)
    model = build_model(cfg, impl="pallas", device=dev)
    params = model.init(model.generator(0))
    streams, counts = {}, {}
    for impl in ("naive", "pallas"):
        m = model if impl == "pallas" else build_model(cfg, impl="naive", device=dev)
        fa.reset_launches()
        engine = serve.ContinuousBatchingEngine(m, params, **kw)
        done = engine.run([serve.Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.max_new_tokens) for r in reqs])
        streams[impl] = {u: f.tokens for u, f in done.items()}
        counts[impl] = fa.all_launches()
        if impl == "pallas":
            step = engine._spec_decode if depth and not cfg.use_mla else engine._decode
            assert step.replays > 0
        del engine
    assert streams["pallas"] == streams["naive"]
    assert not any(counts["naive"].values())
    mla = cfg.use_mla
    kname = ("flash_decode_mla" if mla else
             "flash_decode_spec" if depth else "flash_decode") + \
        ("_paged" if layout == "paged" and not (depth and not mla) else "")
    assert counts["pallas"][kname] > 0, counts["pallas"]
    assert counts["pallas"]["flash_fwd"] == (0 if mla or layout == "paged" else
                                             len(reqs) * cfg.n_layers)


def _moe16b(n_layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=n_layers)


@pytest.mark.cuda
def test_moe_backward_gives_the_same_bits_twice(freed):
    """The MoE layer at deepseek-moe-16b's full-width shape (T 2048 = B4 x
    S512, E 64, top-6, d 2048, ff 1408, two shared experts), forward and
    backward twice on the same inputs and cotangent: every gradient the
    same bits. The dispatch gather's backward sums each token's rows with an
    accumulating ``index_put_``."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves
    dev = _device()
    cfg = _moe16b(2)
    g = torch.Generator(device=dev).manual_seed(23)
    p = moe.moe_params(g, cfg)
    x = torch.randn(4, 512, cfg.d_model, generator=g, device=dev)
    dy = torch.randn(x.shape, generator=g, device=dev)
    leaves = [x.requires_grad_()] + [w.requires_grad_() for w in tree_leaves(p)]

    def run():
        y, aux = moe.apply_moe(p, x, cfg)
        return torch.autograd.grad((y * dy).sum() + aux, leaves)

    first, second = run(), run()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


@pytest.mark.cuda
def test_compiled_moe_train_step_matches_eager(freed):
    """deepseek-moe-16b at full width cut to 2 layers (the dense one and a
    MoE layer), batch 2 x 128, 4 adam steps captured and eager: losses
    within 1e-3, first-step gradients (a replay's) within 1e-4 norm-wise, the
    same launches every step (flash_fwd, dq and dkv once a layer), the calls
    warm-up, capture, replay, replay."""
    import numpy as np
    from repro_torch.engine.rungs import Rung
    from repro_torch.launch.steps import init_train_state
    from repro_torch.optim.optimizers import adam
    dev = _device()
    cfg = _moe16b(2)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)}
               for _ in range(4)]
    runs = {}
    for jit in (True, False):
        rung = Rung(name="full", attn_impl="pallas")
        model = rung.build_model(cfg, dev)
        record = _recording_optimizer()
        state = init_train_state(model, record, model.generator(0))
        for _ in range(3):
            state, _ = rung.jitted_step(cfg, record, device=dev, jit=jit)(state, batches[0])
        grads = tree_leaves_(state["opt"])
        del state
        rung.invalidate()
        state = init_train_state(model, adam(), model.generator(0))
        losses, counts = [], []
        step = rung.jitted_step(cfg, adam(), lr=1e-4, device=dev, jit=jit)
        for b in batches:
            before = fa.all_launches()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            after = fa.all_launches()
            counts.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        calls = tuple(getattr(step, k, None) for k in ("captures", "replays", "last_call"))
        runs[jit] = (losses, grads, calls, counts)
        del state, step
        rung.invalidate()
        _free()
    got, want = runs[True], runs[False]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert _rel(got[1], want[1]) <= 1e-4
    assert got[3] == want[3]
    assert all(c == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2} for c in got[3])
    assert got[2] == (1, 3, "replay")
