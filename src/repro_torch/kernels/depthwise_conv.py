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
    lib.depthwise_conv.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    lib.depthwise_conv.restype = _I
    return lib


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
    lib = _lib()
    device, stream = stream_args(x)
    rc = lib.depthwise_conv(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W,
                            C, kh, kw, int(x.dtype == torch.bfloat16), device,
                            stream)
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
