"""The port's depthwise-conv and RMSNorm kernels against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version
(``repro_torch.kernels.ref``); the JAX side runs the Pallas kernels in
interpret mode. Inputs are drawn with numpy from a seed and handed to both
(bf16 inputs are the same f32 draws rounded to nearest even on both sides).

Tolerances are those of ``tests/test_kernels.py``, 2e-5 at f32 and 5e-2 at
bf16, for the forwards; those of ``tests/test_kernel_grads.py``, 1e-4 at f32
and 5e-2 at bf16, for the RMSNorm gradients (the two packages sum the row
statistics and the dscale partials in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import depthwise_conv as tdw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trms

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _tol(tdtype):
    return dict(rtol=5e-2, atol=5e-2) if tdtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


def _pair(a, jdtype, tdtype):
    """One f32 numpy draw as a JAX array and a torch tensor of one dtype."""
    return jnp.asarray(a, jdtype), torch.from_numpy(a).to(tdtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape,k", [((2, 8, 8, 16), 3), ((1, 13, 11, 24), 3),
                                     ((2, 16, 16, 8), 5), ((1, 32, 32, 32), 3),
                                     ((2, 9, 7, 58), 3)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_depthwise_matches_pallas(shape, k, jdtype, tdtype):
    rng = np.random.default_rng(sum(shape) + k)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, k, shape[-1])).astype(np.float32)
    jx, tx = _pair(x, jdtype, tdtype)
    jw, tw = _pair(w, jdtype, tdtype)
    want = np.asarray(jops.depthwise_conv(jx, jw), np.float32)
    got = tops.depthwise_conv(tx, tw)
    assert got.dtype == tdtype and got.shape == shape
    np.testing.assert_allclose(_np(got), want, **_tol(tdtype))


def test_depthwise_wrapper_counts_only_kernel_launches():
    x = torch.randn(1, 5, 5, 4)
    w = torch.randn(3, 3, 4)
    before = dict(tdw.launches)
    tops.depthwise_conv(x, w)
    assert tdw.launches == before  # the CPU's plain version is no launch


@pytest.mark.parametrize("bad", ["even", "channels", "dtype"])
def test_depthwise_refuses_what_it_does_not_take(bad):
    x = torch.randn(1, 6, 6, 8)
    w = {"even": torch.randn(2, 3, 8), "channels": torch.randn(3, 3, 4),
         "dtype": torch.randn(3, 3, 8, dtype=torch.float64)}[bad]
    with pytest.raises((ValueError, TypeError)):
        tops.depthwise_conv(x, w)


@pytest.mark.parametrize("grad_of", ["x", "w"])
def test_backward_through_depthwise_raises_in_both_packages(grad_of):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16)).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    f = (lambda a: jops.depthwise_conv(a, jw).sum()) if grad_of == "x" else \
        (lambda a: jops.depthwise_conv(jx, a).sum())
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(f)(jx if grad_of == "x" else jw)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    (tx if grad_of == "x" else tw).requires_grad_()
    out = tops.depthwise_conv(tx, tw)
    assert out.grad_fn is not None  # an autograd node, not a detached tensor
    with pytest.raises(NotImplementedError, match="no custom_vjp"):
        out.sum().backward()


@pytest.mark.parametrize("shape", [(1, 7, 64), (4, 3, 96), (2, 1, 128), (3, 17, 256)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_rmsnorm_matches_pallas(shape, jdtype, tdtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    jx, tx = _pair(x, jdtype, tdtype)
    js, ts = _pair(s, jdtype, tdtype)
    want = np.asarray(jops.rmsnorm(jx, js), np.float32)
    got = tops.rmsnorm(tx, ts)
    assert got.dtype == tdtype and got.shape == shape
    np.testing.assert_allclose(_np(got), want, **_tol(tdtype))


@pytest.mark.parametrize("shape", [(1, 7, 64), (4, 3, 96), (3, 17, 256)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_rmsnorm_grads_match_jax(shape, jdtype, tdtype):
    """Gradients of sum(rmsnorm(x, s) * w) through the port's
    ``_RMSNorm`` (its backward's plain version on the CPU) against
    ``jax.grad`` through the reference's custom_vjp backward kernel."""
    rng = np.random.default_rng(100 + sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x, jdtype, tdtype)
    js, ts = _pair(s, jdtype, tdtype)
    gx, gs = jax.grad(lambda a, b: (jops.rmsnorm(a, b).astype(jnp.float32)
                                    * w).sum(), argnums=(0, 1))(jx, js)
    tx.requires_grad_()
    ts.requires_grad_()
    out = tops.rmsnorm(tx, ts)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert tx.grad.dtype == tdtype and ts.grad.dtype == tdtype
    tol = dict(rtol=5e-2, atol=5e-2) if tdtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx, np.float32), **tol)
    np.testing.assert_allclose(_np(ts.grad), np.asarray(gs, np.float32), **tol)


def test_rmsnorm_backward_plain_version_is_its_formula():
    """``rmsnorm_bwd``'s plain version against autograd through the plain
    forward: the written-out formulas are the forward's derivative. Neither
    is a kernel launch on the CPU."""
    from repro_torch.kernels.ref import ref_rmsnorm, ref_rmsnorm_bwd
    g = torch.Generator().manual_seed(0)
    x, cot = (torch.randn(6, 40, generator=g) for _ in range(2))
    s = torch.randn(40, generator=g)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    (ref_rmsnorm(xr, sr) * cot).sum().backward()
    before = dict(trms.launches)
    dx, ds = trms.rmsnorm_bwd(x, s, cot)
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ds, sr.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close((dx, ds), ref_rmsnorm_bwd(x, s, cot))
    assert trms.launches == before
