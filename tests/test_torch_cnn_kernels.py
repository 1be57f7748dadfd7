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


# every stride-1 depthwise layer of the paper's two depthwise CNNs, (H, W, C)
# 3x3 (models/cnn.py with configs/cnn_paper.py): MobileNetV2, then ShuffleNetV2
CNN_DW_LAYERS = [(32, 32, 192), (16, 16, 144), (8, 8, 192), (4, 4, 384), (4, 4, 576),
                 (2, 2, 960), (16, 16, 58), (8, 8, 116), (4, 4, 232)]


@pytest.mark.parametrize("hwc", CNN_DW_LAYERS)
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_depthwise_matches_pallas_at_the_cnn_layer_shapes(hwc, jdtype, tdtype):
    """``ops.depthwise_conv`` at each stride-1 layer shape of MobileNetV2 and
    ShuffleNetV2, batch 2, against the JAX op (Pallas in interpret mode)."""
    shape = (2, *hwc)
    rng = np.random.default_rng(sum(hwc))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, hwc[-1])).astype(np.float32)
    jx, tx = _pair(x, jdtype, tdtype)
    jw, tw = _pair(w, jdtype, tdtype)
    want = np.asarray(jops.depthwise_conv(jx, jw), np.float32)
    got = tops.depthwise_conv(tx, tw)
    assert got.dtype == tdtype and got.shape == shape
    np.testing.assert_allclose(_np(got), want, **_tol(tdtype))


def _covers(plan, H, W, C, kh, kw, elt):
    """The invariants the kernel's C entry checks, and a tiling that covers
    the image: 16-byte channel tiles of at most 256 channels, strips of 4
    columns, at most 256 threads, shared memory within the budget."""
    assert plan.ct % (16 // elt) == 0 and 0 < plan.ct <= 256
    assert plan.tw % 4 == 0 and 4 <= plan.tw <= 32
    assert plan.rows in (1, 2) and plan.th % plan.rows == 0
    assert 1 <= plan.th <= H + plan.rows - 1
    assert plan.rows == 1 or (kh == 3 and kw <= 3)  # two rows a thread: 3x1 and 3x3
    assert 1 <= plan.threads <= 256
    assert tdw.smem_bytes(plan.ct, plan.th, plan.tw, kh, kw, elt) <= tdw._SMEM_BUDGET
    assert C % plan.store_vec == 0
    n_ct = -(-C // plan.ct)
    assert (n_ct - 1) * plan.ct < C  # no channel tile is empty


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("hwc", CNN_DW_LAYERS + [(1, 1, 1), (2, 2, 33), (3, 2, 33),
                                                 (13, 11, 58), (300, 301, 3), (7, 40, 232)])
def test_depthwise_plan_covers_every_layer(hwc, elt):
    H, W, C = hwc
    plan = tdw.depthwise_plan(H, W, C, 3, 3, elt, 0)
    _covers(plan, H, W, C, 3, 3, elt)
    # a block fills its threads: 128 bytes of channels of whole 32-column
    # rows at MobileNetV2's largest layer, 2 output rows a thread in bf16;
    # all of an image's rows where they fit; row tiles of equal height
    if hwc == (32, 32, 192):
        assert (plan.ct * elt, plan.tw, plan.threads) == (128, 32, 256)
        assert plan.rows == (2 if elt == 2 else 1)
    if W <= 4 and C >= 64:
        assert plan.th == H, plan
    h_rows = -(-H // plan.rows)  # thread rows that cover the image
    n_rt = -(-h_rows // (plan.th // plan.rows))
    assert plan.th // plan.rows == -(-h_rows // n_rt)


@pytest.mark.parametrize("C,elt,ptr,route,copy", [
    (192, 4, 0, "tma", 16),        # 768-byte pitch, aligned base
    (192, 2, 0, "tma", 16),
    (58, 4, 0, "cp.async", 8),     # ShuffleNetV2's widths: 232-byte pitch
    (58, 2, 0, "cp.async", 4),     # 116 bytes
    (116, 2, 0, "cp.async", 8),    # 232 bytes
    (116, 4, 0, "tma", 16),        # 464 bytes
    (232, 2, 0, "tma", 16),
    (192, 4, 4, "cp.async", 4),    # a base 4 bytes off 16
    (192, 4, 8, "cp.async", 8),
    (192, 2, 2, "plain", 2),       # a bf16 base 2 bytes off: no copy lines up
    (33, 2, 0, "plain", 2),        # odd bf16 width: 66-byte pitch
    (33, 4, 0, "cp.async", 4),
    (1, 4, 0, "cp.async", 4),
])
def test_depthwise_plan_picks_the_copy_route_from_pitch_and_base(C, elt, ptr, route, copy):
    plan = tdw.depthwise_plan(8, 8, C, 3, 3, elt, ptr)
    assert (plan.route, plan.copy_bytes) == (route, copy)
    assert plan.store_vec == (4 if C % 4 == 0 else 2 if C % 2 == 0 else 1)


@pytest.mark.parametrize("kh,kw", [(1, 7), (7, 7), (31, 5), (101, 7), (9, 1)])
def test_depthwise_plan_shrinks_tiles_for_tall_kernels(kh, kw):
    for elt in (4, 2):
        plan = tdw.depthwise_plan(32, 32, 96, kh, kw, elt, 0)
        _covers(plan, 32, 32, 96, kh, kw, elt)
        if plan.route == "tma":
            assert plan.th + kh - 1 <= 256 and plan.tw + kw - 1 <= 256


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


@pytest.mark.parametrize("d", [100, 2048, 4096])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_rmsnorm_matches_pallas_at_the_kernel_row_shapes(d, jdtype, tdtype):
    """``ops.rmsnorm`` against the JAX op at row lengths that take the
    forward kernel's splits: several rows a warp (100), a block a row with
    2 and 4 vectors a thread (2048, 4096); 9 rows, not a multiple of a
    block's."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((9, d)).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32)
    jx, tx = _pair(x, jdtype, tdtype)
    js, ts = _pair(s, jdtype, tdtype)
    want = np.asarray(jops.rmsnorm(jx, js), np.float32)
    got = tops.rmsnorm(tx, ts)
    assert got.dtype == tdtype and got.shape == x.shape
    np.testing.assert_allclose(_np(got), want, **_tol(tdtype))


@pytest.mark.parametrize("d,vec,want", [
    (1, 1, (1, 1)), (3, 1, (2, 2)), (96, 4, (16, 2)), (100, 4, (16, 2)), (100, 1, (256, 1)),
    (256, 4, (32, 2)), (512, 4, (256, 1)), (513, 1, (256, 4)), (2048, 4, (256, 2)),
    (2048, 8, (256, 1)), (2048, 1, (256, 8)), (4096, 4, (256, 4)), (4096, 8, (256, 2)),
    (8192, 4, (256, 8)), (12288, 4, (256, 16)), (16384, 4, (256, 16)), (16388, 4, (256, 0)),
    (8192, 1, (256, 0)), (100000, 4, (256, 0))])
def test_rmsnorm_fwd_plan_matches_the_row_to_the_threads(d, vec, want):
    """Rows up to 64 vectors take a group of up to 32 threads at 1-2 vectors
    a thread (several rows a warp when short), longer ones a block; a
    thread holds up to 16 vectors, and a longer row (nv 0) is read twice."""
    plan = trms.fwd_plan(d, vec)
    assert (plan.tpr, plan.nv) == want
    assert plan.tpr in (1, 2, 4, 8, 16, 32, 256)
    if plan.nv:
        assert plan.nv in ((1, 2, 4, 8, 16) if plan.tpr == 256 else (1, 2))
        assert plan.tpr * plan.nv * vec >= d


@pytest.mark.parametrize("d,elt,ptrs,want", [
    (2048, 4, (0, 256), 4), (2048, 2, (0, 256), 8), (100, 2, (0, 0), 4),   # 100 % 8 != 0
    (2048, 2, (8, 0), 4), (2048, 4, (4, 0), 1), (2048, 2, (2, 0), 1), (97, 4, (0, 0), 1)])
def test_rmsnorm_fwd_vec_takes_what_d_and_the_pointers_allow(d, elt, ptrs, want):
    assert trms.fwd_vec(d, elt, *ptrs) == want


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
