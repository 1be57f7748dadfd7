"""Flash-attention wrappers around the hand-written Hopper kernels.

Two kernels carry the serving path:

  flash_fwd     csrc/flash_fwd.cu     replaces _fwd_kernel    (prefill)
  flash_decode  csrc/flash_decode.cu  replaces _decode_kernel (every decode)

Each wrapper checks its inputs, and then runs the plain PyTorch version
(``kernels/ref.py``) for tensors on the CPU, or launches the CUDA kernel for
tensors on a CUDA device. There is no fallback between the two: a CUDA
tensor either launches the kernel or raises. Outputs are allocated here with
``torch.empty``; the kernels allocate nothing and run on PyTorch's current
stream.

``launches`` counts kernel launches (plain integers, one per wrapper), so a
caller can show that a run really went through the kernels. Plain-version
calls on the CPU do not count.

Forward only for now: the wrappers raise on an input that requires grad.
The ``torch.autograd.Function`` with the dq/dkv backward kernels is not
ported yet.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.backend import attn_bf16, check_launch, load_library
from repro_torch.kernels.ref import ref_flash_attention_fwd, ref_flash_decode

launches = {"flash_fwd": 0, "flash_decode": 0}

FWD_HEAD_DIMS = (16, 32, 64, 128)  # head dims flash_fwd.cu is instantiated for
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _fwd_lib():
    lib = load_library("flash_fwd")
    lib.flash_fwd.argtypes = [_P, _P, _P, _P, _P] + [_I] * 7 + \
        [ctypes.c_float, _I, _I, _I, _P]
    lib.flash_fwd.restype = _I
    return lib


@functools.cache
def _decode_lib():
    lib = load_library("flash_decode")
    lib.flash_decode.argtypes = [_P] * 5 + [_I] * 6 + \
        [ctypes.c_float, _I, _I, _I, _P]
    lib.flash_decode.restype = _I
    lib.flash_decode_smem_bytes.argtypes = [_I, _I, _I]
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_max_smem_bytes.argtypes = []
    lib.flash_decode_max_smem_bytes.restype = _I
    return lib


def _check_device(*tensors) -> str:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the flash kernels are forward only: the backward kernels "
            "(dq/dkv) are not ported yet")


def _check_dtype(*tensors) -> None:
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"flash kernels take f32 or bf16 inputs of one dtype, "
                        f"got {[t.dtype for t in tensors]}")


def _stream_args(t: torch.Tensor):
    """(device ordinal, PyTorch's current stream handle) for a CUDA tensor."""
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# prefill / training forward
# ---------------------------------------------------------------------------


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True, q_offset: int = 0,
                            lowp: Optional[bool] = None):
    """q, k, v: (B,H,S,hd) with one head count. Returns (o (B,H,Sq,hd) in q's
    dtype, lse (B,H,Sq) f32), the log-sum-exp rows a backward would reuse.

    ``lowp`` (default: ``REPRO_ATTN_BF16``) feeds the dots bf16 inputs while
    the softmax statistics and the accumulator stay f32.
    """
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
    _check_no_grad(q, k, v)
    _check_dtype(q, k, v)
    lowp = attn_bf16(lowp)
    if _check_device(q, k, v) == "cpu":
        return ref_flash_attention_fwd(q, k, v, causal=causal,
                                       q_offset=int(q_offset), lowp=lowp)
    if hd not in FWD_HEAD_DIMS:
        raise ValueError(f"flash_fwd is built for head dims {FWD_HEAD_DIMS}, "
                         f"got {hd}")
    Sk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _fwd_lib()
    device, stream = _stream_args(q)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), B, H, Sq, Sk, hd, int(bool(causal)),
                       int(q_offset), 1.0 / math.sqrt(hd),
                       int(q.dtype == torch.bfloat16), int(lowp), device,
                       stream)
    check_launch(lib, rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def flash_attention_mha(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        lowp: Optional[bool] = None):
    """q, k, v: (B,H,S,hd) with one head count. Returns (B,H,Sq,hd)."""
    return flash_attention_fwd_lse(q, k, v, causal=causal, q_offset=q_offset,
                                   lowp=lowp)[0]


# ---------------------------------------------------------------------------
# decode: single query token, per-sequence valid lengths
# ---------------------------------------------------------------------------


def flash_decode(q, k, v, lengths, *, scale: Optional[float] = None,
                 lowp: Optional[bool] = None):
    """Single-query flash decode over a ragged KV cache.

    q: (B, K, G, hd) — one new token's query heads, grouped so the G heads
       sharing KV head k sit together.
    k: (B, Smax, K, hd)   v: (B, Smax, K, hdv) — the KV cache buffers.
    lengths: (B,) int or a scalar — row b attends cache positions
       < min(lengths[b], Smax); rows with length 0 return zeros.
    Returns (B, K, G, hdv) in q's dtype.
    """
    B, K, G, hd = q.shape
    Smax = k.shape[1]
    hdv = v.shape[-1]
    if k.shape != (B, Smax, K, hd) or v.shape[:3] != (B, Smax, K):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    _check_no_grad(q, k, v)
    _check_dtype(q, k, v)
    lowp = attn_bf16(lowp)
    lengths = torch.as_tensor(lengths, device=q.device)
    if lengths.dim() > 1 or lengths.dtype.is_floating_point:
        raise ValueError("lengths must be an int scalar or a (B,) vector")
    lengths = lengths.to(torch.int32).expand(B).contiguous()
    if _check_device(q, k, v) == "cpu":
        return ref_flash_decode(q, k, v, lengths, scale=scale, lowp=lowp)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, K, G, hdv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _decode_lib()
    need = lib.flash_decode_smem_bytes(G, hd, hdv)
    if hd % 4 or hdv > 128 or need > lib.flash_decode_max_smem_bytes():
        # the MLA latent geometry (G=H, hd=576, hdv=512) needs another tiling
        raise ValueError(f"flash_decode takes hd % 4 == 0, hdv <= 128 and at "
                         f"most {lib.flash_decode_max_smem_bytes()} bytes of "
                         f"shared memory; got G={G}, hd={hd}, hdv={hdv} "
                         f"({need} bytes)")
    if k.data_ptr() % (4 * k.element_size()):
        raise ValueError("flash_decode reads K rows 4 elements at a time: the "
                         "cache must be aligned to 4 elements")
    device, stream = _stream_args(q)
    rc = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), B, K, G, Smax,
                          hd, hdv, float(scale),
                          int(q.dtype == torch.bfloat16), int(lowp), device,
                          stream)
    check_launch(lib, rc, "flash_decode")
    launches["flash_decode"] += 1
    return out
