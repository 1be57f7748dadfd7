"""Carry parameters across from the JAX package.

``from_numpy_tree`` takes the JAX package's parameter tree as nested dicts
of numpy arrays — layers stacked on a leading axis, as its ``init_decoder``
makes them — and returns the port's parameters: the same tree, the same
shapes, as torch tensors on ``device``. The caller does the ``jax -> numpy``
step (``jax.tree_util.tree_map(np.asarray, params)``), so the port never
sees JAX.

Weight layout: the port keeps JAX's ``x @ W`` with ``W`` of shape
(d_in, d_out), not ``nn.Linear``'s (d_out, d_in) transpose, so no weight is
transposed on the way and a tree can be compared leaf by leaf.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def from_numpy_tree(tree, *, device="cuda", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors.

    ``dtype`` casts floating leaves (None keeps each leaf's dtype).
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        t = t.to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)

