"""Training backward of flash attention: wrappers around the two
hand-written Hopper kernels of ``csrc/flash_bwd.cu``.

  flash_bwd_dq   replaces _dq_kernel   (src/repro/kernels/flash_attention.py)
  flash_bwd_dkv  replaces _dkv_kernel

``flash_attention_bwd`` is the backward of ``flash_attention._FlashMHA``:
``delta = rowsum(do * o)`` in torch, as the reference's ``_bwd_call``
computes it outside any kernel, then the two kernels. As for the forward
wrappers, a CPU tensor runs the plain version (``kernels/ref.py``) and a
CUDA tensor launches the kernel or raises; ``launches`` counts the launches.

On the card the dtype and ``lowp`` choose the numeric mode, as the
reference's ``cdt`` does: with ``lowp`` (bf16 dot inputs) an f32 call is
rounded to bf16 here and every product runs on the tensor cores; bf16
inputs without ``lowp`` run the tensor-core kernels with p and ds kept f32
as split bf16 pairs; f32 inputs without ``lowp`` run the f32 FFMA kernels.
None of them falls back to another.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.backend import (check_device, check_launch,
                                         load_library, stream_args)
from repro_torch.kernels.flash_attention import (FWD_HEAD_DIMS, _check_aligned,
                                                 _check_dtype, _check_mha)
from repro_torch.kernels.ref import (ref_flash_attention_bwd, ref_flash_bwd_dkv,
                                    ref_flash_bwd_dq)

launches = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _bwd_lib():
    lib = load_library("flash_bwd")
    lib.flash_bwd_dq.argtypes = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _I,
                                                       _I, _P]
    lib.flash_bwd_dq.restype = _I
    lib.flash_bwd_dkv.argtypes = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _I,
                                                        _I, _P]
    lib.flash_bwd_dkv.restype = _I
    return lib


def _bwd_args(q, k, v, do, lse, delta, name: str, lowp: bool):
    """Contiguous, checked kernel inputs: autograd hands ``do`` over
    non-contiguous, and the GQA broadcast of ``ops.flash_attention`` leaves
    k and v as transposed views. Under ``lowp`` they are bf16."""
    B, H, Sq, hd = q.shape
    if hd not in FWD_HEAD_DIMS:
        raise ValueError(f"{name} is built for head dims {FWD_HEAD_DIMS}, "
                         f"got {hd}")
    if do.shape != q.shape or lse.shape != (B, H, Sq) or \
            delta.shape != (B, H, Sq):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"must match q {tuple(q.shape)}")
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    if lowp and q.dtype == torch.float32:
        # round to nearest even, as astype(bfloat16) rounds the reference's
        # dot inputs: the tensor-core kernels then run as for bf16 inputs
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    _check_aligned(name, q, k, v, do, lse, delta)
    return q, k, v, do, lse, delta


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 q_offset: int = 0, lowp: bool = False):
    """dq (B,H,Sq,hd) f32 of flash attention, given the forward's ``lse`` and
    ``delta = rowsum(do * o)`` (both (B,H,Sq) f32)."""
    _check_mha(q, k, v)
    _check_dtype(q, k, v, do)
    if check_device(q, k, v, do, lse, delta) == "cpu":
        return ref_flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                q_offset=int(q_offset), lowp=lowp)
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta,
                                        "flash_bwd_dq", lowp)
    B, H, Sq, hd = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    device, stream = stream_args(q)
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), B, H, Sq, k.shape[2], hd,
                          int(bool(causal)), int(q_offset), 1.0 / math.sqrt(hd),
                          int(q.dtype == torch.bfloat16), int(lowp), device,
                          stream)
    check_launch(lib, rc, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  q_offset: int = 0, lowp: bool = False):
    """(dk, dv), each (B,H,Sk,hd) f32, of flash attention, given the
    forward's ``lse`` and ``delta = rowsum(do * o)``."""
    _check_mha(q, k, v)
    _check_dtype(q, k, v, do)
    if check_device(q, k, v, do, lse, delta) == "cpu":
        return ref_flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                 q_offset=int(q_offset), lowp=lowp)
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta,
                                        "flash_bwd_dkv", lowp)
    B, H, Sq, hd = q.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    lib = _bwd_lib()
    device, stream = stream_args(q)
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2],
                           hd, int(bool(causal)), int(q_offset),
                           1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                           int(lowp), device, stream)
    check_launch(lib, rc, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0, lowp: bool = False):
    """(dq, dk, dv) f32 of flash attention: ``delta = rowsum(do * o)`` in
    torch, as the reference's ``_bwd_call`` computes it outside any kernel,
    then the two backward kernels. On the CPU: ``ref_flash_attention_bwd``."""
    if check_device(q, k, v, o, lse, do) == "cpu":
        _check_mha(q, k, v)
        _check_dtype(q, k, v, do)
        return ref_flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       q_offset=int(q_offset), lowp=lowp)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                      q_offset=q_offset, lowp=lowp)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           q_offset=q_offset, lowp=lowp)
    return dq, dk, dv
