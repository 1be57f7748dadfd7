"""Execution choices — the objects Swan explores, prunes and migrates between.

Two concrete kinds behind one protocol:

- CoreChoice: a subset of SoC CPU cores (the paper's original choice space).
- MeshChoice: a (pod, data, model) submesh + sharding recipe + microbatch +
  remat + compression on a TPU fleet (the TPU-native choice space, DESIGN.md
  §2). The recipe rebinds the logical-axis rules in models/sharding.py, which
  is how a choice changes distribution without touching model code.

Both expose ``cost_key()`` — the Swan §4.3 total order (see core/cost.py).

A copy of the JAX package's ``core/choices.py``. In the port a MeshChoice
becomes a ``Rung`` through ``engine.rungs.Rung.from_mesh_choice``, with
``mesh_shape=None`` (one card); the sharding its ``rules()`` name has no
counterpart in the port.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.core.energy import SocModel

# ---------------------------------------------------------------------------
# SoC core combinations (paper-original)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoreChoice:
    cores: Tuple[int, ...]  # core ids, e.g. (4,5,6,7)
    soc: str  # SocModel name

    @property
    def name(self) -> str:
        return "".join(str(c) for c in self.cores)

    def counts(self, model: SocModel) -> Tuple[int, int, int]:
        """(n_prime, n_big, n_little) used."""
        np_ = nb = nl = 0
        for c in self.cores:
            kind = model.cores[c].name
            np_ += kind == "prime"
            nb += kind == "big"
            nl += kind == "little"
        return np_, nb, nl

    def cost_key(self, model: SocModel) -> Tuple:
        # Swan §4.3: prime > big > little (lexicographic), more cores costlier
        return self.counts(model)


def enumerate_core_choices(model: SocModel) -> List[CoreChoice]:
    """The paper's §4.2/Appendix-B state space: contiguous prefixes within
    each class plus class-combining choices (not the full 2^8 powerset)."""
    classes = model.classes()
    out: List[CoreChoice] = []
    little = classes.get("little", ())
    big = classes.get("big", ())
    prime = classes.get("prime", ())
    fast = big + prime
    for k in range(1, len(little) + 1):  # 0, 01, 012, 0123
        out.append(CoreChoice(little[:k], model.name))
    for k in range(1, len(fast) + 1):  # 4, 45, 456, 4567
        out.append(CoreChoice(fast[:k], model.name))
    if prime:  # prime-only and prime+big pairs
        out.append(CoreChoice(prime, model.name))
        if big:
            out.append(CoreChoice((big[0],) + prime, model.name))
    if little and fast:  # all-cores
        out.append(CoreChoice(little + fast, model.name))
    # dedupe, keep deterministic order
    seen, uniq = set(), []
    for c in out:
        if c.cores not in seen:
            seen.add(c.cores)
            uniq.append(c)
    return uniq


# ---------------------------------------------------------------------------
# TPU mesh choices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshChoice:
    mesh_shape: Tuple[int, ...]  # (data, model) or (pod, data, model)
    axis_names: Tuple[str, ...]
    microbatch: int = 1  # gradient-accumulation steps
    remat: str = "none"  # none | dots | full
    compression: str = "none"  # optim/compression scheme for cross-pod reduce
    prime_pod: bool = True  # occupies the serving-priority pod?
    seq_shard: bool = False  # sequence parallelism for activations
    moe_cf: float = 1.25
    chunk: int = 1024  # attention KV chunk
    wide_ep: bool = False  # experts sharded over (model x data); tokens move
    attn_impl: str = "chunked"  # attention kernel: chunked (jnp) | pallas

    @property
    def name(self) -> str:
        mesh = "x".join(map(str, self.mesh_shape))
        tags = [f"mb{self.microbatch}", f"remat-{self.remat}"]
        if self.compression != "none":
            tags.append(self.compression)
        if self.seq_shard:
            tags.append("sp")
        if self.wide_ep:
            tags.append("wide-ep")
        if self.attn_impl != "chunked":
            tags.append(f"attn-{self.attn_impl}")
        return f"{mesh}[{','.join(tags)}]"

    @property
    def n_chips(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n

    @property
    def tp_degree(self) -> int:
        if "model" in self.axis_names:
            return self.mesh_shape[self.axis_names.index("model")]
        return 1

    def cost_key(self) -> Tuple:
        # Swan §4.3 adapted (DESIGN.md §2): occupying the serving-priority
        # ("prime") pod is costliest, then total chips, then TP degree
        # (TP holds ICI links hostage; relinquishing them helps co-tenants).
        return (int(self.prime_pod), self.n_chips, self.tp_degree)

    def rung_fields(self) -> dict:
        """The executable subset of this choice — what engine.rungs.Rung can
        switch live (mesh-shape switches cost a checkpoint round-trip; the
        rest migrate in place)."""
        return {"microbatch": self.microbatch, "attn_impl": self.attn_impl,
                "mesh_shape": self.mesh_shape, "chunk": self.chunk,
                "remat": self.remat, "compression": self.compression}

    def rules(self) -> dict:
        """Logical-axis rule set for models/sharding.py."""
        has_pod = "pod" in self.axis_names
        batch = ("pod", "data") if has_pod else ("data",)
        return {
            "batch": batch,
            "seq": "model" if self.seq_shard else None,
            "fsdp": "data",
            "tp": "model",
            "ep": ("model", "data") if self.wide_ep else "model",
            "kvseq": "model",
        }


def enumerate_mesh_choices(total_chips: int = 256, *, multi_pod: bool = False,
                           microbatches=(1, 4, 16), remats=("none", "dots", "full"),
                           max_tp: int = 64,
                           attn_impls=("chunked",)) -> List[MeshChoice]:
    """The TPU execution-choice state space for one pod (or two).

    ``attn_impls`` widens the space along the kernel dimension — pass
    ``("chunked", "pallas")`` to let the planner trade the jnp online-softmax
    fallback against the fused Pallas flash kernels per choice.
    """
    out: List[MeshChoice] = []
    shapes = []
    chips = total_chips
    while chips >= max(total_chips // 8, 8):
        tp = 1
        while tp <= min(max_tp, chips):
            if chips % tp == 0:
                shapes.append((chips // tp, tp))
            tp *= 2
        chips //= 2
    for (dp, tp), mb, rm, ai in itertools.product(shapes, microbatches, remats,
                                                  attn_impls):
        if multi_pod:
            out.append(MeshChoice((2, dp, tp), ("pod", "data", "model"),
                                  microbatch=mb, remat=rm, attn_impl=ai))
        else:
            out.append(MeshChoice((dp, tp), ("data", "model"),
                                  microbatch=mb, remat=rm, attn_impl=ai,
                                  prime_pod=(dp * tp == total_chips)))
    return out
