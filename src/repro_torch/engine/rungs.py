"""Rung: an *executable* ladder entry (the JAX package's
``engine/rungs.py`` on one card).

The Swan planner's pruned ladder (core/cost.py) is a list of ChoiceProfiles —
passive cost-model objects. A Rung is the runnable counterpart: the knobs a
live session can actually switch mid-training (microbatch, attention kernel,
parameter dtype) plus a lazily built and cached compiled train step from
launch/steps.py (``jitted_step``, as in the reference: a ``CompiledStep``,
captured as a CUDA graph on the card). ``rungs_from_ladder`` maps a
ChoiceProfile ladder onto Rungs so the planner's output becomes directly
runnable: a ladder of MeshChoices (with ``mesh_shape=None``) or of the Rungs
``core.profiler.profile_rung`` measured (``SwanPlan.rung_ladder``);
``default_rung_ladder`` builds the downgrade ladder the CLI runs when no
planner ran.

Migration compatibility: every Rung here runs on the one card
(``mesh_shape`` is always None), so any two exchange state in place (dtype
changes go through launch.steps.cast_params). The reference's mesh-shape
rungs and their checkpoint round-trip have no counterpart yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost import ChoiceProfile, ladder_sensitivities

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass
class Rung:
    """One executable execution choice. Fastest/costliest rungs sit at the
    top of a ladder; every field below is switchable at a migration."""
    name: str
    microbatch: int = 1
    attn_impl: str = "chunked"
    param_dtype: str = "float32"
    mesh_shape: Optional[Tuple[int, ...]] = None  # must be None: one card
    chunk: int = 1024
    remat: str = "none"
    compression: str = "none"
    # fraction of a co-tenant's contention this rung still feels (1.0 = full
    # overlap with the contended resource; cheap rungs relinquish it)
    interference_sensitivity: float = 1.0
    # latency relative to the ladder head (used to scale calibrations onto
    # rungs that have never run) and an absolute planner estimate if one exists
    rel_latency: float = 1.0
    latency_estimate_s: Optional[float] = None

    def __post_init__(self):
        if self.mesh_shape is not None:
            raise NotImplementedError(
                f"rung {self.name!r}: mesh_shape={self.mesh_shape} needs a "
                f"device mesh; repro_torch runs on one card (mesh_shape=None)")
        self._model = None
        self._model_key = None
        self._step = None
        self._step_key = None

    # -- identity ----------------------------------------------------------
    def signature(self) -> Tuple:
        return (self.microbatch, self.attn_impl, self.param_dtype,
                self.mesh_shape, self.chunk, self.remat, self.compression)

    @property
    def dtype(self):
        return _DTYPES[self.param_dtype]

    def rung_fields(self) -> dict:
        """The switchable fields, as ``MeshChoice.rung_fields()`` gives a
        mesh choice's: ``Rung.from_mesh_choice`` of a Rung rebuilds it."""
        return {"microbatch": self.microbatch, "attn_impl": self.attn_impl,
                "param_dtype": self.param_dtype, "mesh_shape": self.mesh_shape,
                "chunk": self.chunk, "remat": self.remat,
                "compression": self.compression}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_mesh_choice(cls, choice, *, name: Optional[str] = None,
                         **overrides) -> "Rung":
        """Build a Rung from a core.choices.MeshChoice (or anything exposing
        ``rung_fields()``, a Rung among them). A MeshChoice's mesh raises
        unless ``mesh_shape=None`` overrides it: one card."""
        fields = dict(choice.rung_fields())
        fields.update(overrides)
        return cls(name=name or getattr(choice, "name", "rung"), **fields)

    # -- executable surface ------------------------------------------------
    def build_model(self, cfg, device="cuda"):
        """Model under this rung's kernel/dtype knobs (cached per config)."""
        from repro_torch.models.registry import build_model
        key = (cfg.name, self.signature(), str(device))
        if self._model is None or self._model_key != key:
            self._model = build_model(cfg, impl=self.attn_impl, chunk=self.chunk,
                                      remat=self.remat, param_dtype=self.dtype,
                                      device=device)
            self._model_key = key
        return self._model

    def train_step_fn(self, model, optimizer, *, lr: float = 0.05,
                      compressor=None):
        """The raw (uncompiled) step ``jitted_step`` wraps."""
        from repro_torch.launch.steps import build_train_step
        from repro_torch.optim.compression import Compressor
        comp = compressor or Compressor(self.compression)
        return build_train_step(model, optimizer, microbatch=self.microbatch,
                                lr=lr, compressor=comp)

    def jitted_step(self, cfg, optimizer, *, lr: float = 0.05,
                    compressor=None, device="cuda", jit: bool = True,
                    pool=None):
        """Lazily built cached compiled step: the first call on a rung runs
        the step eagerly on its capture stream, the second captures it as a
        CUDA graph, later calls (including after migrating away and back)
        replay it, and a call whose state lies at new addresses (a dtype
        migration casts the parameters) captures again
        (``launch/steps.CompiledStep``). Eager on the CPU and with
        ``jit=False``. ``pool``: a ``launch.steps.GraphPool`` shared with
        the other rungs of one session (they never run at once), read when
        the step is built."""
        from repro_torch.launch.steps import CompiledStep
        key = (cfg.name, self.signature(), optimizer.name, float(lr),
               getattr(compressor, "scheme", self.compression), str(device),
               bool(jit))
        if self._step is None or self._step_key != key:
            self._step = None  # drop the old graphs before building anew
            model = self.build_model(cfg, device)
            step = self.train_step_fn(model, optimizer, lr=lr,
                                      compressor=compressor)
            self._step = CompiledStep(step, f"train_step[{self.name}]",
                                      state_argnums=(0,), pool=pool) \
                if jit else step
            self._step_key = key
        return self._step

    def invalidate(self):
        """Drop the compiled step, its graphs (and with them their memory)
        and the model it closes over."""
        self._step = None
        self._step_key = None

    def profile(self, *, position: int = 0, n: int = 1) -> ChoiceProfile:
        """A ChoiceProfile view of this rung so SwanController (which walks
        ChoiceProfile ladders) can drive it directly."""
        lat = self.latency_estimate_s if self.latency_estimate_s is not None \
            else self.rel_latency
        return ChoiceProfile(choice=self, latency_s=lat, energy_j=lat,
                             power_w=1.0, cost_key=(n - position,))


def rungs_from_ladder(profiles: Sequence[ChoiceProfile], **overrides
                      ) -> List[Rung]:
    """Map a pruned ChoiceProfile ladder (fastest first, backed by
    MeshChoices or Rungs) onto executable Rungs, preserving order; latency
    estimates come from the profiles and interference sensitivities from
    the cost model's ladder positions."""
    if not profiles:
        raise ValueError("empty ladder")
    sens = ladder_sensitivities(len(profiles))
    head_lat = profiles[0].latency_s
    out = []
    for i, p in enumerate(profiles):
        out.append(Rung.from_mesh_choice(
            p.choice, name=p.name,
            interference_sensitivity=sens[i],
            rel_latency=p.latency_s / max(head_lat, 1e-12),
            latency_estimate_s=p.latency_s, **overrides))
    return out


def default_rung_ladder(*, batch: int, microbatch: int = 1,
                        attn_impl: str = "chunked",
                        mesh_shape: Optional[Tuple[int, ...]] = None,
                        include_bf16: bool = True) -> List[Rung]:
    """Downgrade ladder for the CLI path (no planner run): each rung trades
    latency for relinquished burst compute — deeper gradient accumulation
    shrinks the per-microbatch working set, and the bottom rung additionally
    halves parameter memory traffic with bfloat16."""
    if microbatch < 1 or batch % microbatch:
        raise ValueError(f"microbatch {microbatch} does not divide batch "
                         f"{batch}; the accumulation reshape would fail")
    specs = [("full", microbatch, "float32", 1.00),
             ("accum", microbatch * 2, "float32", 1.15),
             ("lean", microbatch * 4, "bfloat16" if include_bf16 else "float32",
              1.35)]
    specs = [(n, mb, dt, rl) for n, mb, dt, rl in specs if batch % mb == 0]
    sens = ladder_sensitivities(len(specs))
    return [Rung(name=n, microbatch=mb, attn_impl=attn_impl, param_dtype=dt,
                 mesh_shape=mesh_shape, interference_sensitivity=s,
                 rel_latency=rl)
            for (n, mb, dt, rl), s in zip(specs, sens)]
