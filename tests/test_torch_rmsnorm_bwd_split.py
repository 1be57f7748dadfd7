"""The RMSNorm backward kernel's order of work (``rmsnorm_bwd_kernel`` in
``src/repro_torch/csrc/rmsnorm.cu``), held against the gradient of the JAX
package's ``rmsnorm`` (``jax.vjp`` through its custom_vjp, the Pallas
backward kernel in interpret mode) on the CPU.

A torch emulation follows the kernel: the wrapper's plan (``bwd_plan``)
gives a group of ``tpr`` threads a row, ``groups`` rows a block at once;
the grid (``bwd_blocks``) is a fixed number of blocks an SM, block ``blk``'s
group ``q`` walking rows ``blk * groups + q``, then ``+ blocks * groups``,
...; each row's statistics and dx come from the row as loaded, once, and
each group keeps its columns' g * x * r partial across its rows; a block
sums its groups' partials in group order into its row of (blocks, d)
partials; after the grid-wide barrier each block sums ``ceil(d / blocks)``
columns, a thread taking every ``slices``-th row of partials of one column
(``slices = 256 // columns``, or all rows in order where a block sums 256
columns or more), the row slices merged in order.

Against JAX: 2e-5 in f32 (summation order only), 5e-2 in bf16 (dx rounded
to bf16 once, the tolerance of ``tests/test_kernels.py``), for dx and
dscale, with f32 and bf16 ``scale``. The plan and the grid are checked on
their own.

Inputs are drawn with numpy from a seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rmsnorm as jrms
from repro_torch.kernels import rmsnorm as trms

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
EPS = 1e-5
REG_BYTES = 256  # the bytes of x and g a thread holds: the forward's 16 vectors of 16
THREADS = 256    # threads a block


def _emulate(x, scale, g, *, sms, vec):
    """(dx, dscale, blocks) as rmsnorm_bwd computes them on a card of
    ``sms`` SMs with loads of ``vec`` elements."""
    rows, d = x.shape
    plan = trms.bwd_plan(d, vec)
    blocks = trms.bwd_blocks(rows, plan, sms)
    groups = plan.groups
    xf, gf, sf = x.float(), g.float(), scale.float()
    dx = torch.empty(rows, d)
    part = torch.empty(blocks, d)
    covered = torch.zeros(rows, dtype=torch.int64)
    for blk in range(blocks):
        acc = torch.zeros(groups, d)
        for q in range(groups):
            for row in range(blk * groups + q, rows, blocks * groups):
                covered[row] += 1
                xr, gs = xf[row], gf[row] * sf
                r = torch.rsqrt((xr * xr).sum() / d + EPS)
                k = r * r * r * ((gs * xr).sum() / d)
                dx[row] = r * gs - xr * k
                acc[q] += gf[row] * xr * r
        total = torch.zeros(d)
        for q in range(groups):  # group order
            total += acc[q]
        part[blk] = total
    assert (covered == 1).all(), "every row is taken once"
    cpb = -(-d // blocks)  # columns a block sums
    if cpb >= THREADS:
        dscale = torch.zeros(d)
        for blk in range(blocks):  # all rows in order
            dscale += part[blk]
    else:
        slices = THREADS // cpb
        dscale = torch.zeros(d)
        for q in range(slices):  # slice q: rows q, q + slices, ...; slices in order
            sl = torch.zeros(d)
            for blk in range(q, blocks, slices):
                sl += part[blk]
            dscale += sl
    return dx.to(x.dtype), dscale.to(scale.dtype), blocks


def _jax_grads(x, s, g, jdtype, sdtype):
    y, vjp = jax.vjp(lambda a, b: jrms.rmsnorm(a, b, eps=EPS, interpret=True),
                     jnp.asarray(x, jdtype), jnp.asarray(s, sdtype))
    dx, ds = vjp(jnp.asarray(g, jdtype).astype(y.dtype))
    return np.asarray(dx, np.float32), np.asarray(ds, np.float32)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("sdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(37, 96), (19, 512), (9, 2048)])
def test_bwd_emulation_matches_jax(rows, d, dtype, sdtype, sms):
    rng = np.random.default_rng(rows * d)
    x, g = (rng.standard_normal((rows, d)).astype(np.float32) for _ in range(2))
    s = rng.standard_normal(d).astype(np.float32)
    want_dx, want_ds = _jax_grads(x, s, g, getattr(jnp, dtype), getattr(jnp, sdtype))
    tdt, sdt = getattr(torch, dtype), getattr(torch, sdtype)
    vec = 16 // torch.empty((), dtype=tdt).element_size()
    dx, ds, blocks = _emulate(torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(sdt),
                              torch.from_numpy(g).to(tdt), sms=sms, vec=vec)
    if sms == 1:
        assert blocks < rows, "blocks walk several rows"
    tol = BF16 if tdt == torch.bfloat16 or sdt == torch.bfloat16 else F32
    np.testing.assert_allclose(dx.float().numpy(), want_dx, **tol)
    # dscale sums the rows: held relative to its largest element
    top = float(np.abs(want_ds).max())
    np.testing.assert_allclose(ds.float().numpy() / top, want_ds / top, **tol)


@pytest.mark.parametrize("d,vec,want", [
    (1, 1, (1, 1)), (96, 4, (16, 2)), (100, 1, (32, 4)), (256, 4, (32, 2)),
    (512, 4, (32, 4)), (513, 4, (256, 1)), (2048, 4, (256, 2)), (2048, 8, (256, 1)),
    (4096, 4, (256, 4)), (8192, 4, (256, 8)), (16384, 8, (256, 8)), (8196, 4, (256, 0)),
    (2049, 1, (256, 0))])
def test_bwd_plan_matches_the_row_to_the_threads(d, vec, want):
    plan = trms.bwd_plan(d, vec)
    assert (plan.tpr, plan.nv) == want


@pytest.mark.parametrize("elt", [2, 4])
def test_bwd_plan_fits_the_registers_and_covers_each_row(elt):
    """For every row length and load width: a thread's vectors of x and g
    fit the forward's register budget, the plan covers the row where it
    holds it (nv > 0), the group sizes are the kernel's, and the grid takes
    every row exactly once."""
    for vec in {1, 4, 16 // elt}:
        for d in (1, 3, 96, 100, 128, 257, 512, 1000, 2048, 4096, 8192, 16384, 20000):
            if d % vec:
                continue
            plan = trms.bwd_plan(d, vec)
            assert plan.tpr in (1, 2, 4, 8, 16, 32, 256)
            assert 2 * plan.nv * vec * elt <= REG_BYTES
            if plan.nv:
                assert plan.nv in ((1, 2, 4, 8) if plan.tpr == 256 else (1, 2, 4))
                assert plan.tpr * plan.nv * vec >= d
            else:
                assert plan.tpr == 256 and -(-d // vec) > 256 * trms._BWD_MAX_NV
            for rows in (1, 5, 37, 4096):
                for sms in (1, 132):
                    blocks = trms.bwd_blocks(rows, plan, sms)
                    assert 1 <= blocks <= trms._BWD_BLOCKS_PER_SM * sms
                    step = blocks * plan.groups
                    taken = np.zeros(rows, np.int64)
                    for blk in range(blocks):
                        for q in range(plan.groups):
                            taken[blk * plan.groups + q::step] += 1
                    assert (taken == 1).all()
                    # no block is left without a row
                    assert (blocks - 1) * plan.groups < rows
