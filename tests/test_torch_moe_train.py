"""Training of the moe family on the port against the JAX package.

deepseek-moe-16b and deepseek-v3-671b at ``ModelConfig.reduced()`` size (2
layers: one dense, one MoE of 8 experts top-2 with one shared; v3 with MLA
and the MTP head), initialised by JAX (``jax.jit`` of ``init``) and carried
over through numpy, the router of every MoE layer given a skew towards
expert 0 (its column times 6, in both packages) so that a capacity factor
of 1.25 drops tokens. Tokens are drawn with numpy from a seed.

- ``loss_decoder`` (through ``Model.loss``, which passes ``moe_cf``) and
  every gradient leaf against ``jax.value_and_grad`` of the reference's,
  under ``naive``, ``chunked`` and ``pallas`` (the port's kernels run their
  plain versions on the CPU, JAX's Pallas kernels interpret mode; MLA takes
  the chunked path under ``pallas`` in both packages, with the reference's
  warning, so the port's ``pallas`` is held to the reference's
  ``chunked`` there), at a capacity factor of 1.25 (tokens dropped,
  asserted) and 100 (none dropped). Each port case runs under remat ``none``, ``dots`` and
  ``full`` against the reference's value and gradients: ``jax.checkpoint``
  changes what the backward keeps, never a value, and
  ``tests/test_torch_remat.py`` holds the reference's checkpointed values
  to the port's for the dense archs.

The aux and MTP terms on their own, what the remat policies keep, the
capacity factor's way to ``Model.loss`` and an empty stack of layers are in
``tests/test_torch_moe_train_terms.py``; the train step, the train CLI and
checkpoints in ``tests/test_torch_moe_train_loop.py``. Both import this
file's fixtures and helpers.

Every comparison also asserts that the two packages took the same routing
and capacity decisions (each token's experts, and which of them kept it
within their capacity), recorded from ``_moe_local`` in both: a decision
taken differently would change the loss by more than any tolerance, so it
is held equal rather than hidden under a wider one. Tolerance: 2e-5 in
f32 (the two sides differ in the order of f32 sums only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.models import build_model, moe
from repro_torch.models.convert import from_numpy_tree
from repro_torch.tree import tree_leaves

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b"]
F32 = dict(rtol=2e-5, atol=2e-5)
SKEW = 6.0
CHUNK = 8  # two chunks of the 16 positions under "chunked"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _tokens(cfg, seed=1, B=2, S=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _n_moe(cfg) -> int:
    return cfg.n_layers - cfg.first_k_dense


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(cfg, JAX params, the same as numpy), the routers skewed."""
    cfg = ASSIGNED[request.param].reduced()
    params = _np_tree(jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0)))
    params["layers"]["moe"]["router"] = params["layers"]["moe"]["router"].copy()
    params["layers"]["moe"]["router"][..., 0] *= SKEW
    return cfg, jax.tree_util.tree_map(jnp.asarray, params), params


# ---------------------------------------------------------------------------
# routing and capacity decisions, recorded in both packages
# ---------------------------------------------------------------------------


def _decisions(gates, capacity):
    """(each token's routed experts, those of them that kept it within their
    capacity) as (T, E) boolean arrays, from a call's gates (T, E)."""
    gates = np.asarray(gates, np.float32)
    chosen = gates > 0
    cap = min(capacity, gates.shape[0])
    order = np.argsort(-gates, axis=0, kind="stable")[:cap]  # (cap, E)
    kept = np.zeros_like(chosen)
    np.put_along_axis(kept, order, True, axis=0)
    return chosen, kept & chosen


class Recorder:
    """Every ``_moe_local`` call's decisions, in call order, in the JAX
    package (``jax.debug.callback``: the calls run inside ``jit`` and
    ``scan``) or the port."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        real_j, real_t = jmoe._moe_local, moe._moe_local

        def jlocal(x_flat, gates, experts, cfg, capacity, e_offset, e_local, act):
            jax.debug.callback(
                lambda g: self.jax.append(_decisions(g, capacity)), gates)
            return real_j(x_flat, gates, experts, cfg, capacity, e_offset, e_local, act)

        def tlocal(x_flat, gates, top_i, experts, capacity, activation):
            self.torch.append(_decisions(gates.detach().float().numpy(), capacity))
            return real_t(x_flat, gates, top_i, experts, capacity, activation)

        monkeypatch.setattr(jmoe, "_moe_local", jlocal)
        monkeypatch.setattr(moe, "_moe_local", tlocal)

    def take(self):
        out = self.jax, self.torch
        self.jax, self.torch = [], []
        return out


def assert_same_decisions(jax_calls, torch_calls, n=None):
    """The first ``n`` calls of each (a checkpointed forward records again
    in its recomputation) took the same decisions; returns the tokens the
    capacity dropped in them."""
    n = len(jax_calls) if n is None else n
    assert len(jax_calls) >= n and len(torch_calls) >= n and n > 0
    dropped = 0
    for i, ((jc, jk), (tc, tk)) in enumerate(zip(jax_calls[:n], torch_calls[:n])):
        np.testing.assert_array_equal(tc, jc, err_msg=f"call {i}: routed experts")
        np.testing.assert_array_equal(tk, jk, err_msg=f"call {i}: capacity cuts")
        dropped += int(jc.sum() - jk.sum())
    return dropped


@pytest.fixture
def recorder(monkeypatch):
    return Recorder(monkeypatch)


# ---------------------------------------------------------------------------
# loss_decoder: value and gradients
# ---------------------------------------------------------------------------


_JAX_RESULTS = {}


def _jax_value_and_grad(arch, impl, cf, recorder):
    """The reference's loss and gradients (and its decisions), once per
    module for each (arch, impl, capacity factor)."""
    cfg, jparams, _ = arch
    if cfg.use_mla and impl == "pallas":
        impl = "chunked"  # the reference's MLA takes the chunked path under pallas
    key = (cfg.name, impl, cf)
    if key not in _JAX_RESULTS:
        model = jax_build_model(cfg, impl=impl, chunk=CHUNK, moe_cf=cf)
        recorder.take()
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            jparams, {"tokens": jnp.asarray(_tokens(cfg))})
        jax.block_until_ready(grads)
        _JAX_RESULTS[key] = (float(loss), _flat(_np_tree(grads)), recorder.take()[0])
    return _JAX_RESULTS[key]


def _port_value_and_grad(cfg, np_params, impl, remat, cf, tokens, loss_fn=None):
    model = build_model(cfg, impl=impl, chunk=CHUNK, remat=remat, moe_cf=cf,
                        device="cpu")
    params = from_numpy_tree(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    fn = loss_fn or model.loss
    loss = fn(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)  # the aux term's
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return float(loss.detach()), dict(zip(_flat(params).keys(), grads))


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), want[k], **tol, err_msg=k)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("impl,cf", [("naive", 1.25), ("chunked", 1.25),
                                     ("pallas", 1.25), ("naive", 100.0)])
def test_loss_and_grads_match_jax(arch, recorder, impl, cf, remat):
    cfg, _, np_params = arch
    jloss, jgrads, jdec = _jax_value_and_grad(arch, impl, cf, recorder)
    loss, grads = _port_value_and_grad(cfg, np_params, impl, remat, cf, _tokens(cfg))
    dropped = assert_same_decisions(jdec, recorder.take()[1], _n_moe(cfg))
    if cf == 1.25:
        assert dropped > 0  # the skewed routers overfill expert 0
    else:
        assert dropped == 0
    np.testing.assert_allclose(loss, jloss, **F32)
    _assert_grads_close(grads, jgrads, F32)
