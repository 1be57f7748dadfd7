"""Train and serve step functions over a ``Model``, and their compiled form.

``build_*_step`` return the step functions the JAX package returns; with
``jit=True`` (the default, as there) a serve step comes back wrapped in
:class:`CompiledStep`, the port's counterpart of ``jax.jit`` with the cache
donated, and ``engine/rungs.Rung.jitted_step`` wraps the train step the same
way. On the card a compiled step is captured once as a CUDA graph and
replayed; on the CPU, and with ``jit=False``, it runs eagerly. Serve steps
run under ``torch.inference_mode``. Where the JAX package donates a buffer
to a jitted step (the KV cache, the train state), the port writes it in
place.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.optim.compression import Compressor
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

# outputs with at most this many elements are copied out of a graph's
# static buffers on every replay (next_tok, loss, grad_norm); larger ones
# (the logits) are returned as the graph's own buffers
COPY_OUT_MAX = 1 << 16


def _flatten(tree, leaves: List[Any]):
    """The structure of ``tree`` (hashable), its leaves appended to
    ``leaves`` in order."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(struct, leaves):
    """Rebuild a tree of ``struct`` from an iterator over its leaves."""
    if struct is None:
        return next(leaves)
    kind, items = struct
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in items}
    return kind(_unflatten(v, leaves) for v in items)


def _launch_counters() -> Tuple[Dict[str, int], ...]:
    """Every kernel wrapper's launch counts (plain dicts, updated in place)."""
    from repro_torch.kernels import (depthwise_conv, flash_attention,
                                     flash_backward, rmsnorm)
    return (flash_attention.launches, flash_attention.mixed_launches,
            flash_backward.launches, depthwise_conv.launches, rmsnorm.launches)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, np.ndarray):
        return ("array", x.shape, x.dtype.str)
    return ("const", x)


class GraphPool:
    """A CUDA graph memory pool and the side stream its graphs are captured
    on, shared by compiled steps that never run at the same time (a train
    session's rungs). The caching allocator hands a freed block only to an
    allocation on the stream it was made on, so captures share memory only
    when they share the stream as well as the pool. Made lazily, on the
    first capture's device."""

    def __init__(self):
        self.handle = None
        self.stream = None

    def on(self, device) -> "GraphPool":
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.handle = torch.cuda.graph_pool_handle()
        return self


class _Graph:
    """One captured shape signature: the graph, the addresses of the state
    it captured, its static input buffers, its outputs and the launch counts
    one replay stands for."""

    def __init__(self):
        self.graph = None
        self.ptrs: Optional[tuple] = None
        self.inputs: Optional[List[torch.Tensor]] = None
        self.outputs = None  # (structure, [("state", i) | ("out", x)])
        self.launches: Optional[List[Dict[str, int]]] = None


class CompiledStep:
    """A step captured once per shape signature as a CUDA graph and replayed:
    the port's counterpart of ``jax.jit`` with donated buffers.

    ``fn(*args)`` is the eager step. The arguments at ``state_argnums`` are
    its state (parameters, KV cache, optimizer state): trees of tensors the
    step reads and writes in place, captured by address. Every other
    argument is an input: its tensor and numpy leaves are copied into
    static device buffers before each replay, its other leaves (Python
    scalars) are part of the signature, as static arguments are to jit.

    On a CUDA device (the state's), for each signature (the tree structure,
    every tensor's shape, dtype and device, every array's shape and dtype,
    every constant):

    - the first call runs ``fn`` eagerly on this step's own side stream,
      the stream the capture will use, so that what a step makes on first
      use (cuBLAS workspaces, the split kernels' arrival counts) is made
      there before the capture and outside the graph's memory. That call is
      the real step: a train step is not run twice;
    - the second call captures ``fn`` and replays the graph at once;
    - later calls copy the inputs into the static buffers and replay.

    A graph holds the addresses of the state it captured: when a call's
    state tensors lie elsewhere (a dtype migration casts the parameters to
    new storage), the graph is dropped and captured again, as jit retraces.
    A capture error propagates, naming the step; nothing falls back to
    eager. On the CPU, or with no CUDA tensor in the state, ``fn`` runs
    eagerly on every call.

    Outputs: a leaf that is one of the call's state tensors is returned as
    the caller's tensor; a tensor of at most ``COPY_OUT_MAX`` elements is
    copied out of the graph on every replay, so a later replay cannot
    overwrite it; a larger one (the logits) is the graph's own buffer and is
    valid until this step's next call, which the caller must not reach
    before it has read it.

    Launch counts: a capture launches no kernel, though the wrappers count
    it. What the counts gained during the capture is taken back out and
    kept as the graph's counts per replay, which every replay adds again:
    after N calls the counts read what N eager calls give.

    ``pool``: a :class:`GraphPool` shared with other steps that never run
    at the same time (a train session's rungs); by default the step's
    signatures share one of their own. Its stream is the one every first
    call and capture of these steps runs on.
    """

    def __init__(self, fn: Callable, name: str, *,
                 state_argnums: Sequence[int] = (0, 1),
                 pool: Optional[GraphPool] = None):
        self.fn = fn
        self.name = name
        self.state_argnums = tuple(state_argnums)
        self.pool = pool if pool is not None else GraphPool()
        self.captures = 0
        self.capture_s = 0.0  # host seconds spent capturing, all signatures
        self.replays = 0
        self.last_call: Optional[str] = None  # eager|warmup|capture|replay
        self._graphs: Dict[tuple, _Graph] = {}

    # -- inspection --------------------------------------------------------
    def _split(self, args):
        """(signature, state leaves, input leaves) of a call."""
        struct, state, inputs, keys = [], [], [], []
        for i, a in enumerate(args):
            leaves: List[Any] = []
            struct.append(_flatten(a, leaves))
            (state if i in self.state_argnums else inputs).extend(leaves)
            keys.extend(_leaf_key(x) for x in leaves)
        return (tuple(struct), tuple(keys)), state, inputs

    def _device(self, state) -> Optional[torch.device]:
        """The CUDA device of the state, or None: the step runs eagerly."""
        for x in state:
            if isinstance(x, torch.Tensor):
                return x.device if x.is_cuda else None
        return None

    @staticmethod
    def _ptrs(state) -> tuple:
        return tuple(x.data_ptr() if isinstance(x, torch.Tensor) else None
                     for x in state)

    def compiles(self, *args) -> bool:
        """True where a call with ``args`` would not replay: it would run the
        signature's eager first call or capture. Callers timing steps leave
        such calls out of their estimates."""
        sig, state, _ = self._split(args)
        if self._device(state) is None:
            return False
        g = self._graphs.get(sig)
        return g is None or g.graph is None or g.ptrs != self._ptrs(state)

    # -- the CUDA graph (overridden by the CPU tests' stub) ------------------
    def _eager_on_side_stream(self, device, args):
        side = self.pool.on(device).stream
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, device, run):
        """A captured graph of ``run()`` and what it returned.

        Python's garbage collector is kept off during the capture: a dead
        reference cycle that holds a CUDA graph (an engine caught in one)
        would otherwise be collected inside it, and releasing that graph's
        memory pool frees device memory, which invalidates a capture in the
        default global mode (``cudaErrorStreamCaptureInvalidated``). The
        cycle is collected after, as usual (``torch.cuda.graph`` no longer
        collects before capturing; a collection of its own would cost every
        capture the heap's walk)."""
        pool = self.pool.on(device)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream):
                out = run()
        finally:
            if collecting:
                gc.enable()
        return graph, out

    # -- calls -------------------------------------------------------------
    def __call__(self, *args):
        sig, state, inputs = self._split(args)
        device = self._device(state)
        if device is None:
            self.last_call = "eager"
            return self.fn(*args)
        g = self._graphs.get(sig)
        if g is None:
            self._graphs[sig] = _Graph()
            self.last_call = "warmup"
            return self._eager_on_side_stream(device, args)
        if g.inputs is None:
            with torch.inference_mode(False):  # buffers every mode may write
                g.inputs = [
                    torch.empty(tuple(x.shape), device=device,
                                dtype=x.dtype if isinstance(x, torch.Tensor)
                                else torch.from_numpy(np.empty(0, x.dtype)).dtype)
                    if isinstance(x, (torch.Tensor, np.ndarray)) else x
                    for x in inputs]
        for buf, x in zip(g.inputs, inputs):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if isinstance(x, torch.Tensor) and x.data_ptr() != buf.data_ptr():
                buf.copy_(x, non_blocking=True)
        ptrs = self._ptrs(state)
        if g.graph is None or g.ptrs != ptrs:
            self._capture_signature(g, device, args, state, ptrs)
            self.last_call = "capture"
        else:
            self.last_call = "replay"
        g.graph.replay()
        self.replays += 1
        for counts, gained in zip(_launch_counters(), g.launches):
            for k, n in gained.items():
                counts[k] += n
        return self._outputs(g, state)

    def _capture_signature(self, g: _Graph, device, args, state, ptrs):
        """Capture ``fn`` on the static inputs (filled already, so that the
        graph and any stand-in for it see this call's inputs)."""
        g.graph, g.outputs = None, None  # frees the old graph's memory first
        static = iter(g.inputs)
        static_args = []
        for i, a in enumerate(args):
            if i in self.state_argnums:
                static_args.append(a)
            else:
                leaves: List[Any] = []
                struct = _flatten(a, leaves)
                static_args.append(_unflatten(struct, (next(static)
                                                       for _ in leaves)))
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        try:
            graph, out = self._capture(device, lambda: self.fn(*static_args))
        except Exception as e:
            for c, b in zip(counters, before):
                c.update(b)
            raise RuntimeError(
                f"capturing the compiled step {self.name!r} as a CUDA graph "
                f"failed (a step that syncs with the host or makes a host "
                f"tensor cannot be captured; jit=False runs it eagerly): "
                f"{e}") from e
        g.launches = [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
                      for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        where = {id(x): i for i, x in enumerate(state)
                 if isinstance(x, torch.Tensor)}
        leaves = []
        struct = _flatten(out, leaves)
        g.outputs = (struct, [("state", where[id(x)]) if id(x) in where
                              else ("out", x) for x in leaves])
        g.graph, g.ptrs = graph, ptrs
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    @staticmethod
    def _outputs(g: _Graph, state):
        struct, leaves = g.outputs

        def leaf(kind, x):
            if kind == "state":
                return state[x]
            if isinstance(x, torch.Tensor) and x.numel() <= COPY_OUT_MAX:
                return x.clone()
            return x

        return _unflatten(struct, iter([leaf(k, x) for k, x in leaves]))


def _batch_to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(model: Model, optimizer: Optimizer, *, microbatch: int = 1,
                     lr: float = 0.05, compressor: Optional[Compressor] = None):
    """Returns f(state, batch) -> (state, metrics), state = {params, opt, err,
    step}, metrics = {loss, grad_norm} as 0-d f32 tensors on the device.
    ``Rung.jitted_step`` compiles it (:class:`CompiledStep`, the state
    captured by address, the batch an input).

    Microbatched gradient accumulation runs as a Python loop where the
    reference scans: the batch's leading axis splits into ``microbatch``
    contiguous slices, gradients and losses are summed in slice order and
    divided by ``microbatch``. Then the optional compression round trip with
    error feedback, then the optimizer.

    The state is updated in place: the parameters, the optimizer's moments
    and the error-feedback residuals are written into the tensors the
    caller passed, and the returned state holds those same tensors (the
    reference returns new arrays; at llama3.2-1b's full width a copy of the
    state would cost ~20 GB), the step counter and adam's ``t`` too, so that
    a replayed graph advances them. The caller that needs the old state
    keeps a copy.
    """
    comp = compressor or Compressor("none")

    def value_and_grad(params, mb):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]  # same storage
        it = iter(live)
        loss = model.loss(tree_map(lambda _: next(it), params), mb)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(state, batch):
        params = state["params"]
        batch = _batch_to(batch, model.device)
        if microbatch == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatch:
                raise ValueError(f"microbatch {microbatch} does not divide "
                                 f"batch {b}")
            n = b // microbatch
            loss, grads = None, None
            for i in range(microbatch):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                li, gi = value_and_grad(params, mb)
                if grads is None:
                    loss, grads = li, gi
                else:
                    loss = loss + li
                    tree_map(lambda a, g: a.add_(g), grads, gi)
                del gi
            loss = loss / microbatch
            tree_map(lambda g: g.div_(microbatch), grads)

        err = state.get("err", ())
        if comp.scheme != "none":
            grads, err = comp.roundtrip(grads, err)
            tree_map(lambda e, new: e.copy_(new), state["err"], err)
            err = state["err"]

        updates, opt_state = optimizer.update(grads, state["opt"], params, lr)
        params = apply_updates(params, updates)
        del updates
        with torch.no_grad():
            gnorm = sum(g.float().square().sum() for g in tree_leaves(grads))
            state["step"].add_(1)
        new_state = {"params": params, "opt": opt_state, "err": err,
                     "step": state["step"]}
        return new_state, {"loss": loss, "grad_norm": torch.sqrt(gnorm)}

    return train_step


def init_train_state(model: Model, optimizer: Optimizer, gen: torch.Generator,
                     compressor: Optional[Compressor] = None):
    """Fresh state; parameters drawn from ``gen`` (the reference takes a JAX
    PRNG key: the two give different numbers from one seed)."""
    params = model.init(gen)
    comp = compressor or Compressor("none")
    return {"params": params, "opt": optimizer.init(params),
            "err": comp.init_error(params) if comp.scheme != "none" else (),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def cast_params(params, dtype):
    """Floating leaves cast to ``dtype`` (new tensors where the dtype
    changes, the same ones where it does not)."""
    with torch.no_grad():
        return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                        params)


def build_prefill_step(model: Model):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def _compiled(fn, name: str, jit: bool):
    return CompiledStep(fn, name, state_argnums=(0, 1)) if jit else fn


def build_decode_step(model: Model, *, jit: bool = True, greedy: bool = True):
    """One-token decode step: (params, cache, tokens, cache_len) ->
    (next_tok (B,1) int32 on the device or None, logits, cache).

    The cache is updated in place — O(1) cache traffic per token, as the JAX
    package gets from donating it — and the returned cache is the same
    object. ``cache_len`` may be a scalar (lockstep) or (B,) vector
    (continuous batching). ``greedy=False`` skips the argmax.

    ``jit=True``: a :class:`CompiledStep` (params and cache captured by
    address; tokens and cache_len copied in). Its next_tok is the caller's;
    its logits are the graph's buffer, valid until the next call.
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, cache_len):
        logits, cache = model.decode_step(params, cache, tokens, cache_len)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None] \
            if greedy else None
        return next_tok, logits, cache

    return _compiled(decode_step, "decode_step", jit)


def build_paged_decode_step(model: Model, *, jit: bool = True,
                            greedy: bool = True):
    """One-token decode step over a paged KV cache.

    Same contract as :func:`build_decode_step` (pools updated in place,
    ``greedy=False`` skips the argmax) with one extra argument: the (B, T)
    int32 block table routing each sequence's virtual cache positions to
    physical pool blocks (an input of the compiled step, copied in).
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, cache_len, block_table):
        logits, cache = model.paged_decode_step(params, cache, tokens,
                                                cache_len, block_table)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)[:, None] \
            if greedy else None
        return next_tok, logits, cache

    return _compiled(decode_step, "paged_decode_step", jit)


def build_paged_prefill_step(model: Model, *, write: bool = True):
    """One block-sized chunk of paged prefill, writing prompt KV straight
    into the pool blocks the chunk's block-table column names:
    f(params, cache, tokens, start, block_table, last_pos) -> (logits,
    cache). ``write=True`` ingests in place; ``write=False`` is the
    read-only full-prefix-hit recompute and leaves the pools untouched."""
    @torch.inference_mode()
    def prefill_chunk(params, cache, tokens, start, block_table, last_pos):
        return model.paged_prefill_step(params, cache, tokens, start,
                                        block_table, last_pos, write)

    return prefill_chunk


def build_spec_decode_step(model: Model, *, jit: bool = True):
    """Speculative verify step: score a (B, S) draft window in one pass,
    f(params, cache, tokens, cache_len) -> (logits (B, S, V), cache), the
    cache updated in place. Row qi of the logits is the target model's
    next-token distribution after window position qi, which greedy
    verification consumes (an argmax chain).

    ``jit=True``: a :class:`CompiledStep` with one graph per window S met
    (the engine clamps the draft depth near the end of a budget). The
    logits are the graph's buffer: the engine verifies them before its next
    call, which would overwrite them."""
    @torch.inference_mode()
    def spec_step(params, cache, tokens, cache_len):
        return model.spec_decode_step(params, cache, tokens, cache_len)

    return _compiled(spec_step, "spec_decode_step", jit)


def build_paged_spec_decode_step(model: Model, *, jit: bool = True):
    """Speculative verify step over a paged KV cache (block-table routed):
    f(params, cache, tokens, cache_len, block_table) -> (logits, cache);
    ``jit`` as in :func:`build_spec_decode_step`."""
    @torch.inference_mode()
    def spec_step(params, cache, tokens, cache_len, block_table):
        return model.paged_spec_decode_step(params, cache, tokens, cache_len,
                                            block_table)

    return _compiled(spec_step, "paged_spec_decode_step", jit)


@torch.inference_mode()
def greedy_decode_tokens(model: Model, params, tokens, *, steps: int,
                         max_len: int, cache_dtype=torch.float32):
    """Greedy-decode ``steps`` tokens from ``tokens`` (B,1) with a fresh
    cache in lockstep (scalar cache_len); returns the (B, steps) numpy array
    of token ids."""
    cache = model.init_cache(tokens.shape[0], max_len, cache_dtype)
    t, out = tokens, []
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, t, i)
        t = logits[:, -1:, :].argmax(-1).to(torch.int32)
        out.append(t.cpu().numpy())
    return np.concatenate(out, 1)
