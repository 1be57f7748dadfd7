"""RMSNorm: wrappers around the two hand-written Hopper kernels of
``csrc/rmsnorm.cu``.

  rmsnorm_fwd  csrc/rmsnorm.cu  replaces _rmsnorm_kernel     (src/repro/kernels/rmsnorm.py)
  rmsnorm_bwd  csrc/rmsnorm.cu  replaces _rmsnorm_bwd_kernel

``rmsnorm`` is differentiable: ``_RMSNorm`` is the counterpart of the
reference's ``_rmsnorm2d`` custom_vjp. Its forward saves (x, scale) only;
its backward recomputes ``r = rsqrt(mean(x^2) + eps)`` in the kernel, writes
dx, and writes f32 ``dscale`` partials, one row per block of rows, that the
wrapper sums, as the reference's wrapper sums its per-tile partials.

A CPU tensor runs the plain versions (``kernels/ref.ref_rmsnorm`` and
``ref_rmsnorm_bwd``); a CUDA tensor launches the kernel or raises.
``launches`` counts the launches. No model calls this: the port's
``models/common.apply_norm`` stays plain, as the reference's does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.backend import (check_device, check_launch,
                                         load_library, stream_args)
from repro_torch.kernels.ref import ref_rmsnorm, ref_rmsnorm_bwd

launches = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0}

_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = load_library("rmsnorm")
    lib.rmsnorm_fwd.argtypes = [_P] * 3 + [_I] * 2 + [ctypes.c_float] + [_I] * 6 + [_P]
    lib.rmsnorm_fwd.restype = _I
    lib.rmsnorm_bwd.argtypes = [_P] * 5 + [_I] * 2 + [ctypes.c_float] + [_I] * 3 + [_P]
    lib.rmsnorm_bwd.restype = _I
    lib.rmsnorm_rows_per_block.argtypes = []
    lib.rmsnorm_rows_per_block.restype = _I
    return lib


def _check(x2, scale) -> None:
    if scale.dim() != 1 or scale.shape[0] != x2.shape[1]:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not match "
                         f"the last dim of x ({x2.shape[1]})")
    if x2.dtype not in _DTYPES or not scale.is_floating_point():
        raise TypeError(f"rmsnorm takes f32 or bf16 x, got {x2.dtype}")


_THREADS = 256  # threads a block (csrc/rmsnorm.cu)
_MAX_NV = 16    # vectors a thread holds in registers
_GROUP_NV = 2   # vectors a thread of a group (up to a warp) a row holds


class FwdPlan(NamedTuple):
    """How the forward kernel splits rows: ``tpr`` threads a row (1-32, a
    power of 2, several rows a warp; or 256, a block a row), each holding
    ``nv`` vectors of ``vec`` elements (0: the row is read twice)."""
    vec: int
    tpr: int
    nv: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def fwd_plan(d: int, vec: int) -> FwdPlan:
    """The forward's row split for rows of ``d`` elements loaded ``vec`` (8,
    4 or 1) at a time: a group of up to 32 threads a row, at 1-2 vectors a
    thread, for rows of up to 64 vectors (several rows a warp when short); a
    block a row beyond, up to 16 vectors a thread; past that the row is read
    twice. Few vectors a thread spread small inputs over many blocks and
    leave registers for the next row's loads, in flight during this row's
    reduction."""
    n = -(-d // vec)  # vectors in a row
    if n <= 32 * _GROUP_NV:
        tpr = min(32, _pow2_at_least(-(-n // _GROUP_NV)))
        return FwdPlan(vec, tpr, _pow2_at_least(-(-n // tpr)))
    if n <= _THREADS * _MAX_NV:
        return FwdPlan(vec, _THREADS, _pow2_at_least(-(-n // _THREADS)))
    return FwdPlan(vec, _THREADS, 0)


def fwd_vec(d: int, elt: int, *ptrs: int) -> int:
    """Elements a forward load moves: 16 bytes where d is a multiple and
    every pointer 16-byte aligned, else 4 elements where that lines up,
    else 1."""
    for w in (16 // elt, 4):
        if d % w == 0 and all(p % (w * elt) == 0 for p in ptrs):
            return w
    return 1


def _vec(d: int, *tensors) -> int:
    """1 when the backward may load 4 elements at a time: d % 4 == 0 and
    every pointer aligned to 4 of its elements."""
    return int(d % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                                  for t in tensors))


def rmsnorm_fwd(x2, scale, eps: float = 1e-5):
    """x2: (rows, d); scale: (d,). Returns (rows, d) in x2's dtype."""
    _check(x2, scale)
    if check_device(x2, scale) == "cpu":
        return ref_rmsnorm(x2, scale, eps)
    rows, d = x2.shape
    x2 = x2.contiguous()
    # the kernel reads f32 or bf16 scale as it is; another dtype is cast
    s = (scale if scale.dtype in _DTYPES else scale.float()).contiguous()
    y = torch.empty_like(x2)
    if y.numel() == 0:
        return y
    plan = fwd_plan(d, fwd_vec(d, x2.element_size(), x2.data_ptr(), y.data_ptr()))
    lib = _lib()
    device, stream = stream_args(x2)
    rc = lib.rmsnorm_fwd(x2.data_ptr(), s.data_ptr(), y.data_ptr(), rows, d,
                         float(eps), int(x2.dtype == torch.bfloat16),
                         int(s.dtype == torch.bfloat16), plan.vec, plan.tpr,
                         plan.nv, device, stream)
    check_launch(lib, rc, "rmsnorm_fwd")
    launches["rmsnorm_fwd"] += 1
    return y


def rmsnorm_bwd(x2, scale, g, eps: float = 1e-5):
    """(dx (rows, d) in x2's dtype, dscale (d,) in scale's dtype) for the
    output cotangent ``g``: the kernel writes dx and per-block f32 partials
    of dscale, summed here."""
    _check(x2, scale)
    if g.shape != x2.shape:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} does not match x "
                         f"{tuple(x2.shape)}")
    if check_device(x2, scale, g) == "cpu":
        return ref_rmsnorm_bwd(x2, scale, g, eps)
    rows, d = x2.shape
    x2 = x2.contiguous()
    g = g.to(x2.dtype).contiguous()
    s = scale.float().contiguous()
    dx = torch.empty_like(x2)
    if dx.numel() == 0:
        return dx, torch.zeros_like(scale)
    lib = _lib()
    per = lib.rmsnorm_rows_per_block()
    part = torch.empty(((rows + per - 1) // per, d), dtype=torch.float32,
                       device=x2.device)
    device, stream = stream_args(x2)
    rc = lib.rmsnorm_bwd(x2.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(),
                         part.data_ptr(), rows, d, float(eps),
                         int(x2.dtype == torch.bfloat16),
                         _vec(d, x2, s, g, dx, part), device, stream)
    check_launch(lib, rc, "rmsnorm_bwd")
    launches["rmsnorm_bwd"] += 1
    return dx, part.sum(0).to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the hand-written backward: the counterpart of the
    reference's ``_rmsnorm2d`` custom_vjp (residuals: x and scale)."""

    @staticmethod
    def forward(ctx, x2, scale, eps: float):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x2, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d); scale: (d,). ``x * rsqrt(mean(x^2) + eps) * scale`` with
    f32 statistics, in x's dtype. Differentiable through ``_RMSNorm``."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = _RMSNorm.apply(x2, scale, float(eps))
    else:
        out = rmsnorm_fwd(x2, scale, eps)
    return out.reshape(x.shape)
