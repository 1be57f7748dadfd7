"""Flash-attention wrappers around the hand-written Hopper kernels.

  flash_fwd                csrc/flash_fwd.cu           replaces _fwd_kernel    (prefill, training forward)
  flash_decode             csrc/flash_decode_paged.cu  replaces _decode_kernel (contiguous decode)
  flash_decode_paged       csrc/flash_decode_paged.cu  replaces _decode_paged_kernel (paged decode)
  flash_decode_spec        csrc/flash_decode_spec.cu   replaces _spec_decode_kernel (speculative verify)
  flash_decode_spec_paged  csrc/flash_decode_spec.cu   replaces _spec_decode_paged_kernel (paged verify)

and ``kernels/flash_backward.py`` wraps the training backward's two,
``flash_bwd_dq`` and ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``).

Each wrapper checks its inputs, and then runs the plain PyTorch version
(``kernels/ref.py``) for tensors on the CPU, or launches the CUDA kernel for
tensors on a CUDA device. There is no fallback between the two: a CUDA
tensor either launches the kernel or raises. Outputs are allocated here with
``torch.empty``; the kernels allocate nothing and run on PyTorch's current
stream.

``launches`` counts kernel launches (plain integers, one per wrapper), so a
caller can show that a run really went through the kernels; the backward
kernels count in ``flash_backward.launches``, and ``all_launches`` merges the
two. Plain-version calls on the CPU do not count.

The decode wrappers take the cache in a dtype of its own (f32 or bf16, q
likewise): each of the four pairs is an instantiation of its kernel, which
stages the cache in its own type and computes in f32 (bf16 dot inputs under
``lowp``); the output is in q's dtype.

On the card the dtype and ``lowp`` choose ``flash_fwd``'s numeric mode, as
the reference's ``cdt`` does: bf16 inputs run the tensor-core kernel (TMA,
``wgmma``), with ``lowp`` on bf16(q * scale) and bf16 p, without it with p
kept f32 as a split pair of bf16 products; f32 inputs, with or without
``lowp``, run the f32 FFMA kernel. None of them falls back to another.

Launch plans are made here on the host, from shapes and the card's SM
count only (``fwd_groups``, ``decode_plan``, ``decode_paged_plan``,
``spec_plan``), so that no launch reads a tensor back: the FFMA forward's
groups of warps a block, and the split of each row's keys across blocks in
both decode kernels and the speculative verify (which also cuts its S*G
rows into row blocks).

``flash_attention_mha`` is differentiable: ``_FlashMHA`` is the
counterpart of the JAX package's ``_flash_mha`` custom_vjp. Its forward runs
``flash_fwd`` and saves q, k, v, o and lse; its backward is
``flash_backward.flash_attention_bwd``. ``flash_attention_fwd_lse`` and the
decode wrappers are forward only, as in the reference, and raise on an
input that requires grad. The decode wrappers drop the reference's
``block_k`` and ``interpret`` (TPU tiling and Pallas interpret mode).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.backend import (attn_bf16, check_device, check_launch,
                                         load_library, sm_count, stream_args)
from repro_torch.kernels.ref import (ref_flash_attention_fwd, ref_flash_decode,
                                     ref_flash_decode_paged,
                                     ref_flash_decode_spec,
                                     ref_flash_decode_spec_paged)

launches = {"flash_fwd": 0, "flash_decode": 0, "flash_decode_paged": 0,
            "flash_decode_spec": 0, "flash_decode_spec_paged": 0}
# the decode kernels' launches whose query and cache dtypes differ, by
# "<kernel>:<q dtype>:<cache dtype>" (counted beside ``launches``): a bf16
# cache under f32 queries is the bottom serving rung's
DECODE_KERNELS = ("flash_decode", "flash_decode_paged", "flash_decode_spec",
                  "flash_decode_spec_paged")
mixed_launches = {f"{k}:{q}:{kv}": 0 for k in DECODE_KERNELS
                  for q, kv in (("float32", "bfloat16"), ("bfloat16", "float32"))}

FWD_HEAD_DIMS = (16, 32, 64, 128)  # head dims flash_{fwd,bwd}.cu are instantiated for
FWD_ROWS = 64      # query rows of a flash_fwd block, and keys of its tiles
DECODE_CHUNK = 64  # positions a decode block stages at once
DECODE_ROWS = 4    # query rows of a decode block (a row group)
SPEC_ROWS = 24     # query rows of a flash_decode_spec block (a row block)
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    """Zero the launch counts of every flash kernel, the backward's and the
    mixed-dtype decode counts too."""
    from repro_torch.kernels import flash_backward
    for counts in (launches, mixed_launches, flash_backward.launches):
        for name in counts:
            counts[name] = 0


def all_launches() -> dict:
    """Launch counts of every flash kernel: this module's and
    ``flash_backward``'s."""
    from repro_torch.kernels import flash_backward
    return {**launches, **flash_backward.launches}


@functools.cache
def _fwd_lib():
    lib = load_library("flash_fwd")
    lib.flash_fwd.argtypes = [_P, _P, _P, _P, _P] + [_I] * 7 + \
        [ctypes.c_float, _I, _I, _I, _I, _P]
    lib.flash_fwd.restype = _I
    return lib


@functools.cache
def _decode_lib():
    """Both decode kernels' library: the contiguous and the paged entry."""
    lib = load_library("flash_decode_paged")
    lib.flash_decode.argtypes = [_P] * 8 + [_I] * 6 + \
        [ctypes.c_float] + [_I] * 6 + [_P]
    lib.flash_decode.restype = _I
    lib.flash_decode_paged.argtypes = [_P] * 9 + [_I] * 8 + \
        [ctypes.c_float] + [_I] * 6 + [_P]
    lib.flash_decode_paged.restype = _I
    lib.flash_decode_smem_bytes.argtypes = [_I] * 4
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_max_smem_bytes.argtypes = []
    lib.flash_decode_max_smem_bytes.restype = _I
    return lib


@functools.cache
def _spec_lib():
    lib = load_library("flash_decode_spec")
    lib.flash_decode_spec.argtypes = [_P] * 7 + [_I] * 7 + \
        [ctypes.c_float] + [_I] * 7 + [_P]
    lib.flash_decode_spec.restype = _I
    lib.flash_decode_spec_paged.argtypes = [_P] * 8 + [_I] * 9 + \
        [ctypes.c_float] + [_I] * 7 + [_P]
    lib.flash_decode_spec_paged.restype = _I
    lib.flash_decode_spec_smem_bytes.argtypes = [_I] * 3
    lib.flash_decode_spec_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_spec_max_smem_bytes.argtypes = []
    lib.flash_decode_spec_max_smem_bytes.restype = _I
    return lib


def fwd_block(block: int, n_q: int, BH: int) -> tuple:
    """(query tile, b*h) of block ``block`` of the FFMA forward's 1-D grid of
    ``n_q * BH`` blocks, as the kernel computes it: every head's last query
    tile first, then the one before, so that the causal tiles with the most
    KV tiles start first and the light ones fill in behind them."""
    return n_q - 1 - block // BH, block % BH


def fwd_groups(blocks: int, hd: int, sms: int) -> int:
    """Groups of 4 warps in each block of the FFMA forward: 2, taking the
    block's KV tiles alternately, for a grid that cannot give each SM two
    blocks (and hd <= 64, where two groups' rings fit); else 1."""
    return 2 if hd <= 64 and blocks < 2 * sms else 1


def decode_paged_plan(T: int, bs: int, rows: int, sms: int) -> tuple:
    """(splits, bps): each of ``rows`` (B*K*row groups) block rows of the
    paged decode is cut into ``splits`` blocks of ``bps`` table entries, so
    that a full cache gives each SM about four blocks. A block stages whole
    pool blocks in chunks of ``DECODE_CHUNK`` positions, so a split holds a
    whole number of chunks (where bs <= 64), and never less than one; a
    table of one chunk, or enough rows, take one split (no partials)."""
    per_chunk = max(1, DECODE_CHUNK // bs)  # pool blocks a chunk holds
    n_chunks = -(-T // per_chunk)
    splits = max(1, min(n_chunks, -(-4 * sms // max(rows, 1))))
    bps = min(T, per_chunk * -(-n_chunks // splits))
    return -(-T // bps), bps


def decode_plan(Smax: int, rows: int, sms: int) -> tuple:
    """(splits, bps) of the contiguous decode: the cache of ``Smax``
    positions read as a table of ``ceil(Smax / 64)`` blocks of
    ``DECODE_CHUNK`` positions, cut as ``decode_paged_plan`` cuts a table
    (``rows``: B*K*row groups)."""
    return decode_paged_plan(-(-Smax // DECODE_CHUNK), DECODE_CHUNK, rows, sms)


def spec_plan(B: int, K: int, R: int, T: int, bs: int, sms: int) -> tuple:
    """(row blocks, splits, bps) of a speculative verify of ``R`` = S*G rows
    a (b, kv head): the rows cut into row blocks of ``SPEC_ROWS``, and the
    keys of each into ``decode_paged_plan``'s splits of ``bps`` table
    entries. The paged cache passes its table (T entries of ``bs``
    positions); the contiguous cache of Smax positions is read as a table of
    ``ceil(Smax / 64)`` blocks of ``DECODE_CHUNK`` positions."""
    n_rb = -(-R // SPEC_ROWS)
    return (n_rb,) + decode_paged_plan(T, bs, B * K * n_rb, sms)


# per (device, stream): the split decode kernels' arrival counts, zero
# between calls; and every buffer a larger one replaced, which a captured
# CUDA graph may still address
_ARRIVALS: dict = {}
_RETIRED: list = []


def _arrivals(device: int, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counts for the split blocks of both
    decode kernels and the speculative verify: zero when made, and each
    call's last block of a row resets its own, so calls of all of them on
    one stream share the buffer in turn, and a CUDA graph that captured
    calls finds it zero at every replay. Kept per stream, so that calls on
    two streams never share one.

    A buffer grows by a new allocation, never during a capture (it would
    land in the graph's memory and be zeroed only there): a compiled step
    (``launch/steps.CompiledStep``) runs each shape signature eagerly on its
    capture stream first, which sizes the buffer for it. The buffer it
    replaces stays allocated, since a graph captured before may address it.
    """
    buf = _ARRIVALS.get((device, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the split kernels' arrival counts on stream {stream:#x} "
                f"would grow to {n} during a CUDA graph capture: run the "
                f"step once on the capture stream first")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=torch.device("cuda", device))
        _ARRIVALS[(device, stream)] = buf
    return buf


def _check_no_grad(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is forward only: it has no gradient in the reference "
            f"either (flash_attention_mha is the differentiable attention)")


def _check_aligned(name: str, *tensors) -> None:
    """The kernels load rows 16 bytes at a time (TMA: 16-byte aligned
    bases)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} reads rows 16 bytes at a time: its "
                             f"inputs must be 16-byte aligned")


def _check_dtype(*tensors) -> None:
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"flash kernels take f32 or bf16 inputs of one dtype, "
                        f"got {[t.dtype for t in tensors]}")


# ---------------------------------------------------------------------------
# prefill / training forward
# ---------------------------------------------------------------------------


def _check_mha(q, k, v) -> None:
    if q.shape[-1] != k.shape[-1] or q.shape[-1] != v.shape[-1]:
        # the kernel assumes one head dim throughout (MLA prefill has
        # qk_dim != v_dim and must take the 'chunked' impl)
        raise ValueError(
            f"flash_attention_mha needs matching q/k/v head dims, got "
            f"q={q.shape[-1]} k={k.shape[-1]} v={v.shape[-1]}; use the "
            f"'chunked' impl for asymmetric-head attention (e.g. MLA prefill)")
    B, H, Sq, hd = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[2] == 0:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} must share (B, H, ., hd) "
                         f"with at least one key")
    _check_dtype(q, k, v)


def _fwd_lse(q, k, v, causal: bool, q_offset: int, lowp: bool):
    """The forward kernel (its plain version on the CPU), no autograd."""
    B, H, Sq, hd = q.shape
    if check_device(q, k, v) == "cpu":
        return ref_flash_attention_fwd(q, k, v, causal=causal,
                                       q_offset=int(q_offset), lowp=lowp)
    if hd not in FWD_HEAD_DIMS:
        raise ValueError(f"flash_fwd is built for head dims {FWD_HEAD_DIMS}, "
                         f"got {hd}")
    Sk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's tensor maps
        _check_aligned("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _fwd_lib()
    device, stream = stream_args(q)
    groups = fwd_groups(-(-Sq // FWD_ROWS) * B * H, hd, sm_count(device))
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), B, H, Sq, Sk, hd, int(bool(causal)),
                       int(q_offset), 1.0 / math.sqrt(hd),
                       int(q.dtype == torch.bfloat16), int(lowp), groups,
                       device, stream)
    check_launch(lib, rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True, q_offset: int = 0,
                            lowp: Optional[bool] = None):
    """q, k, v: (B,H,S,hd) with one head count. Returns (o (B,H,Sq,hd) in q's
    dtype, lse (B,H,Sq) f32), the log-sum-exp rows the backward reuses.

    ``lowp`` (default: ``REPRO_ATTN_BF16``) feeds the dots bf16 inputs while
    the softmax statistics and the accumulator stay f32.
    """
    _check_mha(q, k, v)
    _check_no_grad("flash_attention_fwd_lse", q, k, v)
    return _fwd_lse(q, k, v, causal, int(q_offset), attn_bf16(lowp))


# ---------------------------------------------------------------------------
# differentiable attention (training)
# ---------------------------------------------------------------------------


class _FlashMHA(torch.autograd.Function):
    """Flash attention with the hand-written backward: the counterpart of
    the reference's ``_flash_mha`` custom_vjp. Gradients come back in the
    inputs' dtypes, cast from the kernels' f32 as ``_flash_mha_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, lowp: bool):
        # save the contiguous copies the kernels read, not the strided views
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fwd_lse(q, k, v, causal, q_offset, lowp)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset, ctx.lowp = causal, q_offset, lowp
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_backward import flash_attention_bwd
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(q.dtype),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset, lowp=ctx.lowp)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention_mha(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        lowp: Optional[bool] = None):
    """q, k, v: (B,H,S,hd) with one head count. Returns (B,H,Sq,hd);
    differentiable through ``_FlashMHA``."""
    _check_mha(q, k, v)
    lowp = attn_bf16(lowp)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMHA.apply(q, k, v, bool(causal), int(q_offset), lowp)
    return _fwd_lse(q, k, v, causal, int(q_offset), lowp)[0]


# ---------------------------------------------------------------------------
# decode: single query token or a window of draft positions, per-sequence
# valid lengths, over a contiguous or a paged cache
# ---------------------------------------------------------------------------


def _lengths(lengths, B: int, device) -> torch.Tensor:
    """(B,) int32 lengths on ``device`` from an int scalar or a (B,) vector."""
    lengths = torch.as_tensor(lengths, device=device)
    if lengths.dim() > 1 or lengths.dtype.is_floating_point:
        raise ValueError("lengths must be an int scalar or a (B,) vector")
    return lengths.to(torch.int32).expand(B).contiguous()


def _table(block_table, B: int, device) -> torch.Tensor:
    """(B, T) int32 block table on ``device``. The reference clips it to
    [0, num_blocks-1]; the plain versions need that done first, the paged
    kernels clip each entry they read."""
    table = torch.as_tensor(block_table, device=device)
    if table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1 or \
            table.dtype.is_floating_point:
        raise ValueError(f"block_table must be a (B={B}, T) int table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return table.to(torch.int32).contiguous()


def _check_decode_dtype(q, k, v) -> None:
    """The decode kernels take q and the cache each in f32 or bf16, as the
    reference casts both to the dots' type inside its kernels; k and v share
    one dtype."""
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"flash decode kernels take an f32 or bf16 q and an "
                        f"f32 or bf16 cache whose k and v share one dtype, got "
                        f"q {q.dtype}, k {k.dtype}, v {v.dtype}")


def _check_decode_inputs(what: str, q, k, v) -> None:
    _check_no_grad(what, q, k, v)
    _check_decode_dtype(q, k, v)
    check_device(q, k, v)


def _check_kernel_geometry(what: str, need: int, limit: int, hd: int, hdv: int,
                           k: torch.Tensor, extra: str = "") -> None:
    """Refuse what the decode kernels do not take: hd not a multiple of 4,
    hdv above 128, more shared memory than a block may use (the MLA latent
    geometry, G=H, hd=576, hdv=512, needs another tiling), or a K cache not
    aligned to the kernels' 4-element loads."""
    if hd % 4 or hdv > 128 or need > limit:
        raise ValueError(f"{what} takes hd % 4 == 0, hdv <= 128 and at most "
                         f"{limit} bytes of shared memory; got hd={hd}, "
                         f"hdv={hdv}{extra} ({need} bytes)")
    if k.data_ptr() % (4 * k.element_size()):
        raise ValueError(f"{what} reads K rows 4 elements at a time: the "
                         f"cache must be aligned to 4 elements")


def _decode_launch(what: str, q, k, v, table, lengths, scale: float,
                   lowp: bool) -> torch.Tensor:
    """Launch ``flash_decode`` (``table`` None: k, v a contiguous cache) or
    ``flash_decode_paged`` on CUDA tensors: its plan, the splits' f32
    workspace and the arrival counts. Returns (B, K, G, hdv)."""
    B, K, G, hd = q.shape
    hdv = v.shape[-1]
    paged = table is not None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, K, G, hdv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _decode_lib()
    device, stream = stream_args(q)
    rows = B * K * -(-G // DECODE_ROWS)  # block rows: (b, kv head, row group)
    if paged:
        T, bs = table.shape[1], k.shape[1]
        splits, bps = decode_paged_plan(T, bs, rows, sm_count(device))
        extra = f", T={T}"
    else:
        splits, bps = decode_plan(k.shape[1], rows, sm_count(device))
        extra = ""
    _check_kernel_geometry(
        what, lib.flash_decode_smem_bytes(hd, hdv, bps if paged else 0, k.element_size()),
        lib.flash_decode_max_smem_bytes(), hd, hdv, k, extra)
    # the splits' f32 partials (m and l, then acc), written before they are
    # read: no fill
    ws = [None, None, None]
    if splits > 1:
        ws = [torch.empty(B * K * splits * G * 2, dtype=torch.float32, device=q.device),
              torch.empty(B * K * splits * G * hdv, dtype=torch.float32, device=q.device),
              _arrivals(device, stream, rows)]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()] + \
        ([table.data_ptr()] if paged else []) + \
        [lengths.data_ptr(), out.data_ptr()] + \
        [None if w is None else w.data_ptr() for w in ws]
    dims = [B, K, G] + ([k.shape[0], bs, T] if paged else [k.shape[1]]) + [hd, hdv]
    fn = lib.flash_decode_paged if paged else lib.flash_decode
    rc = fn(*ptrs, *dims, float(scale), splits, bps, int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16), int(lowp), device, stream)
    check_launch(lib, rc, what)
    _count_decode(what, q, k)
    return out


def _count_decode(what: str, q, k) -> None:
    launches[what] += 1
    if q.dtype != k.dtype:
        mixed_launches[f"{what}:{str(q.dtype)[6:]}:{str(k.dtype)[6:]}"] += 1


def flash_decode(q, k, v, lengths, *, scale: Optional[float] = None,
                 lowp: Optional[bool] = None):
    """Single-query flash decode over a ragged KV cache.

    q: (B, K, G, hd) — one new token's query heads, grouped so the G heads
       sharing KV head k sit together.
    k: (B, Smax, K, hd)   v: (B, Smax, K, hdv) — the KV cache buffers, f32
       or bf16 whatever q's dtype is (a bf16 cache under f32 queries is a
       serving rung's: the kernel reads it in bf16 and computes in f32, as
       the reference's kernel casts it).
    lengths: (B,) int or a scalar — row b attends cache positions
       < min(lengths[b], Smax); rows with length 0 return zeros.

    The kernel is the paged decode's over the cache read as a table of
    64-position blocks (``decode_plan``): each row's keys split across
    blocks, the last block of a row to finish merging the splits' f32
    partials. Returns (B, K, G, hdv) in q's dtype.
    """
    B, K, G, hd = q.shape
    Smax = k.shape[1]
    hdv = v.shape[-1]
    if k.shape != (B, Smax, K, hd) or v.shape[:3] != (B, Smax, K):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _check_decode_inputs("flash_decode", q, k, v)
    lowp = attn_bf16(lowp)
    lengths = _lengths(lengths, B, q.device)
    if q.device.type == "cpu":
        return ref_flash_decode(q, k, v, lengths, scale=scale, lowp=lowp)
    return _decode_launch("flash_decode", q, k, v, None, lengths, scale, lowp)


def flash_decode_paged(q, k_pool, v_pool, block_table, lengths, *,
                       scale: Optional[float] = None,
                       lowp: Optional[bool] = None):
    """Single-query flash decode over a paged (block-pooled) KV cache.

    q: (B, K, G, hd) — grouped query heads, as in ``flash_decode``.
    k_pool: (num_blocks, block_size, K, hd)  v_pool: (..., hdv) — physical
       KV blocks shared by all sequences (no batch dimension).
    block_table: (B, T) int32 — logical block j of sequence b lives in
       physical block ``block_table[b, j]``; rows may point unused tail
       entries at any valid block (they are clamped and predicated away).
    lengths: (B,) int32 — row b attends to virtual positions < lengths[b]
       (position p lives at offset p % block_size of logical block
       p // block_size), clamped to T * block_size; rows with length 0
       produce zeros.

    The kernel splits each row's keys across blocks (``decode_paged_plan``),
    each translating its table entries once; the last block of a row to
    finish merges the splits' f32 partials. The math of ``flash_decode`` on
    the contiguous cache the table describes, summed in another order.
    Returns (B, K, G, hdv).
    """
    B, K, G, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    hdv = v_pool.shape[-1]
    if k_pool.shape != (NB, bs, K, hd) or v_pool.shape[:3] != (NB, bs, K):
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"k {tuple(k_pool.shape)} / v {tuple(v_pool.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _check_decode_inputs("flash_decode_paged", q, k_pool, v_pool)
    lowp = attn_bf16(lowp)
    lengths = _lengths(lengths, B, q.device)
    table = _table(block_table, B, q.device)
    if q.device.type == "cpu":
        return ref_flash_decode_paged(q, k_pool, v_pool, table.clamp(0, NB - 1),
                                      lengths, scale=scale, lowp=lowp)
    return _decode_launch("flash_decode_paged", q, k_pool, v_pool, table, lengths,
                          scale, lowp)


def _spec_launch(what: str, q, k, v, table, lengths, scale: float,
                 lowp: bool) -> torch.Tensor:
    """Launch ``flash_decode_spec`` (``table`` None: k, v a contiguous
    cache) or ``flash_decode_spec_paged`` on CUDA tensors: its plan, the
    splits' f32 workspace and the arrival counts. Returns (B, K, S, G, hdv)."""
    B, K, S, G, hd = q.shape
    hdv = v.shape[-1]
    paged = table is not None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, K, S, G, hdv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _spec_lib()
    device, stream = stream_args(q)
    R, rb = S * G, SPEC_ROWS
    if paged:
        T, bs = table.shape[1], k.shape[1]
    else:
        T, bs = -(-k.shape[1] // DECODE_CHUNK), DECODE_CHUNK
    n_rb, splits, bps = spec_plan(B, K, R, T, bs, sm_count(device))
    _check_kernel_geometry(
        what, lib.flash_decode_spec_smem_bytes(hd, hdv, k.element_size()),
        lib.flash_decode_spec_max_smem_bytes(), hd, hdv, k)
    ws = arrivals = None
    if splits > 1:  # each split's f32 partial, written before it is read: no fill
        ws = torch.empty(B * K * n_rb * splits * rb * (2 + hdv), dtype=torch.float32,
                         device=q.device)
        arrivals = _arrivals(device, stream, B * K * n_rb)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()] + \
        ([table.data_ptr()] if paged else []) + \
        [lengths.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
         None if arrivals is None else arrivals.data_ptr()]
    dims = [B, K, S, G] + ([k.shape[0], bs, T] if paged else [k.shape[1]]) + [hd, hdv]
    fn = lib.flash_decode_spec_paged if paged else lib.flash_decode_spec
    rc = fn(*ptrs, *dims, float(scale), rb, splits, bps,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            int(lowp), device, stream)
    check_launch(lib, rc, what)
    _count_decode(what, q, k)
    return out


def flash_decode_spec(q, k, v, lengths, *, scale: Optional[float] = None,
                      lowp: Optional[bool] = None):
    """Multi-token speculative verify over a ragged contiguous KV cache.

    q: (B, K, S, G, hd) — S draft positions' query heads, grouped per KV
       head as in ``flash_decode`` (GQA: G = H // K).
    k: (B, Smax, K, hd)   v: (B, Smax, K, hdv) — cache buffers with the S
       draft tokens' KV already scattered at positions
       lengths[b]..lengths[b]+S-1.
    lengths: (B,) int32 — BASE valid counts (before the drafts); draft
       position qi of row b attends cache positions < lengths[b] + qi + 1,
       clamped to Smax.

    The kernel cuts the S*G rows of each (b, KV head) into row blocks of
    ``SPEC_ROWS`` rows, each reading its keys once, and splits
    those keys across blocks (``spec_plan``), with the causal mask applied
    per row (r = qi*G + g) inside the key chunks; the last block of a row
    block to finish merges the splits' f32 partials. Any S*G is taken (no
    row ceiling), as in the reference. Returns (B, K, S, G, hdv).
    Serving path only (no gradient).
    """
    B, K, S, G, hd = q.shape
    Smax = k.shape[1]
    hdv = v.shape[-1]
    if k.shape != (B, Smax, K, hd) or v.shape[:3] != (B, Smax, K):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _check_decode_inputs("flash_decode_spec", q, k, v)
    lowp = attn_bf16(lowp)
    lengths = _lengths(lengths, B, q.device)
    if q.device.type == "cpu":
        return ref_flash_decode_spec(q, k, v, lengths, scale=scale, lowp=lowp)
    return _spec_launch("flash_decode_spec", q, k, v, None, lengths, scale, lowp)


def flash_decode_spec_paged(q, k_pool, v_pool, block_table, lengths, *,
                            scale: Optional[float] = None,
                            lowp: Optional[bool] = None):
    """Multi-token speculative verify over a paged (block-pooled) KV cache.

    q: (B, K, S, G, hd) — S draft positions, grouped as in
       ``flash_decode_spec``. k_pool/v_pool: (num_blocks, block_size, K, .)
       physical blocks; block_table: (B, T) int32 with blocks mapped through
       position lengths[b] + S - 1 (the engine appends draft positions before
       the verify call, so boundary blocks already exist).
    lengths: (B,) int32 BASE valid counts, as in ``flash_decode_spec``;
       limits are clamped to T * block_size.

    The kernel of ``flash_decode_spec`` with each split a range of whole
    pool blocks, each chunk's positions translated through the table as it
    is staged; any S*G is taken. Returns (B, K, S, G, hdv).
    """
    B, K, S, G, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    hdv = v_pool.shape[-1]
    if k_pool.shape != (NB, bs, K, hd) or v_pool.shape[:3] != (NB, bs, K):
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"k {tuple(k_pool.shape)} / v {tuple(v_pool.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _check_decode_inputs("flash_decode_spec_paged", q, k_pool, v_pool)
    lowp = attn_bf16(lowp)
    lengths = _lengths(lengths, B, q.device)
    table = _table(block_table, B, q.device)
    if q.device.type == "cpu":
        return ref_flash_decode_spec_paged(q, k_pool, v_pool, table.clamp(0, NB - 1),
                                           lengths, scale=scale, lowp=lowp)
    return _spec_launch("flash_decode_spec_paged", q, k_pool, v_pool, table, lengths,
                        scale, lowp)
