"""RMSNorm: wrappers around the two hand-written Hopper kernels of
``csrc/rmsnorm.cu``.

  rmsnorm_fwd  csrc/rmsnorm.cu  replaces _rmsnorm_kernel     (src/repro/kernels/rmsnorm.py)
  rmsnorm_bwd  csrc/rmsnorm.cu  replaces _rmsnorm_bwd_kernel

``rmsnorm`` is differentiable: ``_RMSNorm`` is the counterpart of the
reference's ``_rmsnorm2d`` custom_vjp. Its forward saves (x, scale) only;
its backward recomputes ``r = rsqrt(mean(x^2) + eps)`` in the kernel, writes
dx, and sums ``dscale`` from f32 partials, one row per block of the grid,
which the whole grid then adds up in one launch (the reference's wrapper
sums its per-tile partials).

Both kernels take their row split from a plan made here (``fwd_plan``,
``bwd_plan``) and read ``scale`` in its own dtype where it is f32 or bf16.

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
                                         load_library, sm_count, stream_args)
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
    lib.rmsnorm_bwd.argtypes = [_P] * 6 + [_I] * 2 + [ctypes.c_float] + [_I] * 8 + [_P]
    lib.rmsnorm_bwd.restype = _I
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
# the backward holds two tensors (x and g) a thread: half the forward's
# vectors of each in a block, and up to 4 in a warp for rows of 65-128
# vectors (a warp a row, not half a block idle)
_BWD_MAX_NV = _MAX_NV // 2
_BWD_GROUP_NV = 4
_BWD_BLOCKS_PER_SM = 2  # the backward's grid: blocks an SM, each walking rows


class RowPlan(NamedTuple):
    """How a kernel splits rows: ``tpr`` threads a row (1-32, a power of 2,
    several rows a warp; or 256, a block a row), each holding ``nv``
    vectors of ``vec`` elements (of each tensor it reads; 0: the row is
    read twice)."""
    vec: int
    tpr: int
    nv: int

    @property
    def groups(self) -> int:
        """Rows a block works on at once."""
        return _THREADS // self.tpr


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _row_plan(d: int, vec: int, group_nv: int, block_nv: int) -> RowPlan:
    """A group of up to 32 threads a row, at 1-2 vectors a thread (up to
    ``group_nv`` for a warp), for rows of up to 32 * group_nv vectors; a
    block a row beyond, up to ``block_nv`` vectors a thread; past that the
    row is read twice."""
    n = -(-d // vec)  # vectors in a row
    if n <= 32 * group_nv:
        tpr = min(32, _pow2_at_least(-(-n // _GROUP_NV)))
        return RowPlan(vec, tpr, _pow2_at_least(-(-n // tpr)))
    if n <= _THREADS * block_nv:
        return RowPlan(vec, _THREADS, _pow2_at_least(-(-n // _THREADS)))
    return RowPlan(vec, _THREADS, 0)


def fwd_plan(d: int, vec: int) -> RowPlan:
    """The forward's row split for rows of ``d`` elements loaded ``vec`` (8,
    4 or 1) at a time: a group of up to 32 threads a row, at 1-2 vectors a
    thread, for rows of up to 64 vectors (several rows a warp when short); a
    block a row beyond, up to 16 vectors a thread; past that the row is read
    twice. Few vectors a thread spread small inputs over many blocks and
    leave registers for the next row's loads, in flight during this row's
    reduction."""
    return _row_plan(d, vec, _GROUP_NV, _MAX_NV)


def bwd_plan(d: int, vec: int) -> RowPlan:
    """The backward's row split, as ``fwd_plan``'s but for a thread that
    holds its vectors of x and of g: a group of up to 32 threads a row, at
    1-2 vectors of each a thread, for rows of up to 64 vectors, and a warp
    at 4 for rows of up to 128; a block a row beyond, up to 8 vectors of
    each a thread (the bytes of the forward's 16 of one); past that the row
    is read twice."""
    return _row_plan(d, vec, _BWD_GROUP_NV, _BWD_MAX_NV)


def bwd_blocks(rows: int, plan: RowPlan, sms: int) -> int:
    """Blocks of the backward's grid: ``_BWD_BLOCKS_PER_SM`` an SM, each
    walking rows, or fewer where the rows run out (or, on the card, where
    fewer fit at once: the grid is launched cooperatively); the kernel
    writes one row of dscale partials a block."""
    return max(1, min(-(-rows // plan.groups), _BWD_BLOCKS_PER_SM * sms))


def fwd_vec(d: int, elt: int, *ptrs: int) -> int:
    """Elements a load of either kernel moves: 16 bytes where d is a
    multiple and every pointer 16-byte aligned, else 4 elements where that
    lines up, else 1."""
    for w in (16 // elt, 4):
        if d % w == 0 and all(p % (w * elt) == 0 for p in ptrs):
            return w
    return 1


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
    output cotangent ``g``: one launch writes dx, one row of f32 dscale
    partials a block of its grid (``bwd_blocks``) and their sum."""
    _check(x2, scale)
    if g.shape != x2.shape:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} does not match x "
                         f"{tuple(x2.shape)}")
    if check_device(x2, scale, g) == "cpu":
        return ref_rmsnorm_bwd(x2, scale, g, eps)
    rows, d = x2.shape
    x2 = x2.contiguous()
    g = g.to(x2.dtype).contiguous()
    # the kernel reads f32 or bf16 scale as it is; another dtype is cast
    s = (scale if scale.dtype in _DTYPES else scale.float()).contiguous()
    dx = torch.empty_like(x2)
    if dx.numel() == 0:
        return dx, torch.zeros_like(scale)
    plan = bwd_plan(d, fwd_vec(d, x2.element_size(), x2.data_ptr(), g.data_ptr(),
                               dx.data_ptr()))
    lib = _lib()
    device, stream = stream_args(x2)
    blocks = bwd_blocks(rows, plan, sm_count(device))
    # scratch for the partials, each block's row written before it is read:
    # no fill; dscale in scale's dtype where the kernel writes it
    part = torch.empty((blocks, d), dtype=torch.float32, device=x2.device)
    ds = torch.empty(d, dtype=s.dtype, device=x2.device)
    rc = lib.rmsnorm_bwd(x2.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(),
                         part.data_ptr(), ds.data_ptr(), rows, d, float(eps),
                         int(x2.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
                         int(ds.dtype == torch.bfloat16), plan.vec, plan.tpr, plan.nv,
                         blocks, device, stream)
    check_launch(lib, rc, "rmsnorm_bwd")
    launches["rmsnorm_bwd"] += 1
    return dx, ds.to(scale.dtype)


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
