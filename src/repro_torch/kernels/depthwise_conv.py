"""Depthwise convolution: the wrapper around the hand-written Hopper kernel
of ``csrc/depthwise_conv.cu``.

  depthwise_conv  csrc/depthwise_conv.cu  replaces _dw_kernel (src/repro/kernels/depthwise_conv.py)

NHWC, stride 1, SAME padding, odd kernel sizes: the shape inside
MobileNetV2's and ShuffleNetV2's stride-1 units. A CPU tensor runs the plain
version (``kernels/ref.ref_depthwise_conv``); a CUDA tensor launches the
kernel or raises. ``launches`` counts the launches.

Forward only, as in the reference: its ``depthwise_conv`` carries no
``custom_vjp``, so ``jax.grad`` through it fails. ``_DepthwiseConv`` keeps
that visible here. A launch through ctypes returns a tensor with no
``grad_fn``, which would silently drop every gradient upstream of the first
depthwise layer; instead the op is an autograd node whose backward raises,
on the CUDA kernel and on the CPU's plain version alike.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.backend import (check_device, check_launch,
                                         load_library, stream_args)
from repro_torch.kernels.ref import ref_depthwise_conv

launches = {"depthwise_conv": 0}

KERNEL_WIDTHS = (1, 3, 5, 7)  # kw the kernel is instantiated for
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = load_library("depthwise_conv")
    lib.depthwise_conv.argtypes = [_P] * 3 + [_I] * 15 + [_P]
    lib.depthwise_conv.restype = _I
    return lib


# the kernel's fixed shape (csrc/depthwise_conv.cu): 4 channels and a strip
# of 4 output columns a thread, at most 256 threads a block
_VEC, _STRIP, _MAX_THREADS = 4, 4, 256
_SMEM_BUDGET = 110 * 1024  # bytes a block: two blocks share an SM's 228 KB
ROUTES = {"tma": 0, "cp.async": 1, "plain": 2}  # the C entry's route codes


class DepthwisePlan(NamedTuple):
    """How the kernel cuts one call: tiles of ``ct`` channels, ``th`` output
    rows and ``tw`` output columns, ``rows`` of them a thread; the copy
    ``route`` into shared memory with ``copy_bytes`` a copy; ``store_vec``
    channels a store."""
    ct: int
    th: int
    tw: int
    rows: int
    route: str
    copy_bytes: int
    store_vec: int

    @property
    def threads(self) -> int:
        return self.ct // _VEC * (self.th // self.rows) * (self.tw // _STRIP)


def smem_bytes(ct: int, th: int, tw: int, kh: int, kw: int, elt: int) -> int:
    """Shared memory of one block (``smem_bytes`` in the C source): two
    input boxes, each rounded up to 128 bytes, the f32 weights and 128 bytes
    of alignment slack."""
    box = (th + kh - 1) * (tw + kw - 1) * ct * elt
    return 2 * (_cdiv(box, 128) * 128) + kh * kw * ct * 4 + 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def depthwise_plan(H: int, W: int, C: int, kh: int, kw: int, elt: int,
                   x_ptr: int) -> DepthwisePlan:
    """The tile and copy route for an (H, W, C) image, a kh x kw kernel and
    elements of ``elt`` bytes whose tensor starts at address ``x_ptr``.

    Strips of 4 columns cover up to 32 columns a tile. In bf16 a 3x3 (or
    3x1) kernel on an image of 8 rows or more gives a thread 2 output rows
    (in f32 their registers spill, and one row a thread was faster on the
    H100). Thread rows fill 256 threads at 128 bytes of channels a tile (32
    in f32, 64 in bf16); a small image takes all its rows a tile and more
    channels instead (up to 256, split evenly over the channel tiles, in
    16-byte units so that TMA can copy them). Two input boxes and the
    weights fit ``_SMEM_BUDGET``, shrinking rows, then columns, then
    channels. TMA copies the box where C * elt and the base are multiples
    of 16 bytes; cp.async copies 16, 8 or 4 bytes, whatever the pitch and
    base allow; plain loads take the rest (bf16 with odd C or a base 2
    bytes off)."""
    quantum = 16 // elt  # channels in 16 bytes
    rows = 2 if elt == 2 and kh == 3 and kw <= 3 and H >= 8 else 1
    ns = min(_cdiv(W, _STRIP), 8)
    h_rows = _cdiv(H, rows)  # thread rows that cover the image
    tr = min(h_rows, max(1, _MAX_THREADS // (128 // elt // _VEC * ns)))
    ct_max = max(quantum, min(256, _VEC * (_MAX_THREADS // (tr * ns))) // quantum * quantum)
    ct = _cdiv(_cdiv(C, _cdiv(C, ct_max)), quantum) * quantum
    tr = min(h_rows, max(1, _MAX_THREADS // (ct // _VEC * ns)))
    while smem_bytes(ct, tr * rows, _STRIP * ns, kh, kw, elt) > _SMEM_BUDGET:
        if tr > 1:
            tr = (tr + 1) // 2
        elif rows > 1:
            rows = 1
        elif ns > 1:
            ns //= 2
        elif ct > quantum:
            ct = max(quantum, ct // 2 // quantum * quantum)
        else:
            raise ValueError(f"depthwise_conv: a {kh}x{kw} kernel's input box does "
                             f"not fit one block's shared memory")
    tr = _cdiv(h_rows, _cdiv(h_rows, tr))  # as many thread rows, spread evenly over the tiles
    th, tw = tr * rows, _STRIP * ns
    pitch = C * elt
    if (pitch % 16 == 0 and x_ptr % 16 == 0 and th + kh - 1 <= 256
            and tw + kw - 1 <= 256):
        route, copy = "tma", 16
    else:
        copy = next((g for g in (16, 8, 4) if pitch % g == 0 and x_ptr % g == 0), 0)
        route, copy = ("cp.async", copy) if copy else ("plain", elt)
    store_vec = 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1
    return DepthwisePlan(ct, th, tw, rows, route, copy, store_vec)


def _check(x, w) -> None:
    if x.dim() != 4 or w.dim() != 3 or w.shape[2] != x.shape[3]:
        raise ValueError(f"depthwise_conv takes x (B,H,W,C) and w (kh,kw,C), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    kh, kw = w.shape[0], w.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"depthwise_conv takes odd kernel sizes (SAME "
                         f"padding), got {kh}x{kw}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv takes f32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")


def _forward(x, w):
    """The kernel (its plain version on the CPU), no autograd."""
    if check_device(x, w) == "cpu":
        return ref_depthwise_conv(x, w)
    B, H, W, C = x.shape
    kh, kw = w.shape[0], w.shape[1]
    if kw not in KERNEL_WIDTHS:
        raise ValueError(f"depthwise_conv is built for kernel widths "
                         f"{KERNEL_WIDTHS}, got {kw}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = depthwise_plan(H, W, C, kh, kw, x.element_size(), x.data_ptr())
    lib = _lib()
    device, stream = stream_args(x)
    rc = lib.depthwise_conv(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W,
                            C, kh, kw, int(x.dtype == torch.bfloat16), plan.ct,
                            plan.th, plan.tw, plan.rows, ROUTES[plan.route],
                            plan.copy_bytes, plan.store_vec, device, stream)
    check_launch(lib, rc, "depthwise_conv")
    launches["depthwise_conv"] += 1
    return out


class _DepthwiseConv(torch.autograd.Function):
    """The depthwise op as an autograd node with no gradient, as in the
    reference."""

    @staticmethod
    def forward(ctx, x, w):
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "depthwise_conv has no gradient: the reference's depthwise_conv "
            "(src/repro/kernels/ops.py) carries no custom_vjp and jax.grad "
            "through it fails; train a CNN with the plain path "
            "(attn_impl='naive')")


def depthwise_conv(x, w):
    """x: (B,H,W,C); w: (kh,kw,C) with odd kh and kw; stride 1, SAME padding.
    Returns (B,H,W,C) in x's dtype, summed in f32. Has no gradient: a
    backward pass through it raises ``NotImplementedError``."""
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DepthwiseConv.apply(x, w)
    return _forward(x, w)
