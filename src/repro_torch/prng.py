"""The counterpart of the ``jax.random`` functions the serve engine calls.

The JAX package keys every sampled token by
``fold_in(fold_in(PRNGKey(seed), uid), index)`` and draws it with
``jax.random.categorical``, under JAX's default PRNG (``threefry2x32``,
with ``jax_threefry_partitionable`` on). This module computes the same
functions bit for bit, so the port's sampled streams are the reference's
token for token, not only in distribution: ``PRNGKey``, ``fold_in``,
``random_bits`` (32-bit), ``uniform``, ``gumbel`` and ``categorical``.

A key is an int64 array or tensor of shape ``(..., 2)`` holding two uint32
words; every function takes a leading batch of keys (the reference's
``vmap``) and runs where its keys are: ``PRNGKey`` and ``fold_in`` work on
numpy arrays as on tensors (the engine derives its keys on the host and
copies them in with the step's other inputs), the draws on tensors, on the
keys' device. uint32 arithmetic runs in int64 masked to 32 bits after every
add and rotate, so no sign bit or carry leaks.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words held in int64 (numpy
    arrays or tensors, broadcast together): the hash under ``jax.random``'s
    default PRNG. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: a seed of 32 bits (the JAX package
    runs without x64) is the key ``(0, seed mod 2**32)``; a wider one is
    split into its high and low words."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 32 else (seed >> 32) & MASK32
    return np.array([hi, seed & MASK32], np.int64)


def _stack(a, b):
    if isinstance(a, torch.Tensor):
        return torch.stack(torch.broadcast_tensors(a, b), -1)
    return np.stack(np.broadcast_arrays(a, b), -1)


def fold_in(keys, data):
    """``jax.random.fold_in`` over a batch of keys: each key (..., 2) hashed
    with the counter ``(0, data)``; ``data`` (an int or an integer array of
    the keys' batch shape) is taken mod 2**32, as ``jnp.uint32`` takes it."""
    if isinstance(keys, torch.Tensor):
        data = torch.as_tensor(data, device=keys.device).to(torch.int64)
    else:
        data = np.asarray(data).astype(np.int64)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0 * data,
                          data & MASK32)
    return _stack(y0, y1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element of ``shape`` under each key, as
    ``jax.random.bits`` draws them with partitionable threefry: element i
    (the row-major flat index) hashes the counter ``(i >> 32, i & MASK32)``
    and its two output words are xored. Returns int64 of shape
    ``keys.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,))
    k1 = keys[..., 1].reshape(lead + (1,))
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(lead + shape)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 random bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval) and
    maxed with minval, each step rounded in float32 as XLA rounds it."""
    bits = random_bits(keys, shape)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    # float32 values as Python floats: a kernel takes them as arguments,
    # with no host tensor to copy in (a captured step may draw)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return (floats * span + lo).clamp_min(lo)


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel`` (its default low mode) in float32:
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` row by row: each key (..., 2) draws Gumbel
    noise of shape (V,) for its row of ``logits`` (..., V), and the token is
    the argmax of logits plus noise (the first maximum on a tie). Returns
    int64 of the keys' batch shape."""
    noise = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(logits + noise, dim=-1)
