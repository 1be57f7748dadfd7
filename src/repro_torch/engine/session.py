"""TrainSession: the live migration loop (paper Fig. 4b, runnable), on one
card.

The JAX package's ``engine/session.py``, single-card subset. The session
owns the training state and implements the :class:`SocJob` protocol
(engine/jobs.py); ``run()`` is a one-job :class:`SwanRuntime`. Per quantum
the job:

1. executes the active Rung's compiled train step (``step``;
   ``Rung.jitted_step``, a CUDA graph on the card, eager with
   ``jit=False`` and on the CPU),
2. digests the observed latency and lets its SwanController *propose* a
   migration (``observe``) — the runtime arbitrates across co-tenant jobs,
3. applies a committed migration *without restarting* (``migrate``):
   microbatch, kernel and dtype migrations carry the state over in place,
   casting the parameters with launch.steps.cast_params when the dtype
   changes (optimizer moments stay f32).

Pause and resume (foreground preemption) go through the checkpoint manager,
as in the reference. Not ported, each refused where it is asked for: the
``elastic`` controller, remeshing and ``on_device_loss`` (the reference
re-shards the state over a surviving device mesh; there is one card), and
fault-event sources, which exist to drive device loss.

Latency semantics: the wall time of each step is measured (after a device
synchronise: the step's loss is read back); a synthetic InterferenceTrace
(the ``--interference-trace`` flag) multiplies what the *monitor observes*
by the burst's slowdown scaled by the active rung's interference
sensitivity — downgrading genuinely shrinks the simulated contention, the
relinquish-and-recover dynamic of the paper. A ``latency_fn`` override
replaces the observation entirely (deterministic tests / benchmarks); real
compute still runs either way.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.controller import SwanController
from repro_torch.engine.events import InterferenceTrace
from repro_torch.engine.jobs import SocJob, StepReport
from repro_torch.engine.rungs import Rung
from repro_torch.engine.timeline import MigrationRecord, Timeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import GraphPool, cast_params, init_train_state
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class SessionResult:
    losses: List[float]
    timeline: Timeline
    state: Any
    final_rung: str
    controller: Optional[SwanController] = None


class TrainSession(SocJob):
    # background personalization training: a foreground burst pauses it
    preemptible = True

    def __init__(self, cfg, rungs: Sequence[Rung], *, optimizer, batch_fn,
                 lr: float = 0.05, compressor=None,
                 ckpt: Optional[CheckpointManager] = None, ckpt_every: int = 0,
                 elastic=None, fault_events: Optional[Callable] = None,
                 trace: Optional[InterferenceTrace] = None,
                 adaptive: bool = True, upgrade_patience: int = 5,
                 latency_fn: Optional[Callable] = None,
                 log_every: int = 0, verbose: bool = True,
                 name: str = "train", priority: float = 1.0,
                 device="cuda", jit: bool = True):
        if not rungs:
            raise ValueError("need at least one rung")
        if elastic is not None or fault_events is not None:
            raise NotImplementedError(
                "elastic remeshing and device-loss events need a device mesh; "
                "repro_torch's TrainSession runs on one card")
        if latency_fn is not None and any(
                r.latency_estimate_s is None for r in rungs):
            raise ValueError("latency_fn mode needs latency_estimate_s on "
                             "every rung (observations are compared to them)")
        self.cfg = cfg
        self._rungs = list(rungs)
        self.optimizer = optimizer
        self.batch_fn = batch_fn
        self.lr = lr
        self.compressor = compressor
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.trace = trace
        self.adaptive = adaptive and len(self._rungs) > 1
        self.latency_fn = latency_fn
        self.log_every = log_every
        self.verbose = verbose
        self.name = name
        self.priority = float(priority)
        self.device = resolve_device(device)
        # steps are captured as CUDA graphs on the card (Rung.jitted_step);
        # jit=False runs them eagerly
        self.jit = bool(jit)
        self._graph_pool = None

        n = len(self._rungs)
        profiles = [r.profile(position=i, n=n)
                    for i, r in enumerate(self._rungs)]
        self.ctl = SwanController(profiles, upgrade_patience=upgrade_patience)
        self.controller = self.ctl  # SocJob protocol name (same object)
        self.timeline = Timeline()
        self._expected: Dict[str, float] = {}  # rung name -> clean latency
        if latency_fn is not None:
            for r in self._rungs:
                self._expected[r.name] = r.latency_estimate_s
        self._steps_on_rung = 0
        self._migrate_ckpt: Optional[CheckpointManager] = None
        self._migrate_tmpdir = None
        # job binding (set by bind()/run())
        self._until: Optional[int] = None
        self._step_idx = 0
        self._losses: List[float] = []
        self._state = None
        self._init_state = None
        self._rng_seed = 0
        self._prepared = False
        self._last_dt = 0.0
        self._last_rung_name = self.rung.name
        self._ran_tick = None  # last tick whose step() already executed

    # -- rung plumbing -------------------------------------------------------
    def rungs(self) -> Sequence[Rung]:
        return self._rungs

    @property
    def rung(self) -> Rung:
        return self._rungs[self.ctl.idx]

    def step_fn(self):
        """The active rung's compiled train step. Every rung of the session
        captures into one CUDA graph memory pool, on one stream: one rung
        runs at a time, so their graphs' activations and gradients can share
        the memory."""
        if self._graph_pool is None:
            self._graph_pool = GraphPool()
        return self.rung.jitted_step(self.cfg, self.optimizer, lr=self.lr,
                                     compressor=self.compressor,
                                     device=self.device, jit=self.jit,
                                     pool=self._graph_pool)

    # -- migrations --------------------------------------------------------
    def _ckpt(self) -> CheckpointManager:
        """Manager for pause round-trips: the user's, or a private tempdir
        one (kept separate so an unconfigured session doesn't start
        periodic-checkpointing into a directory nobody reads)."""
        if self.ckpt is not None:
            return self.ckpt
        if self._migrate_ckpt is None:
            # TemporaryDirectory cleans itself up when the session is
            # collected, so pause round-trips don't leak checkpoints
            self._migrate_tmpdir = tempfile.TemporaryDirectory(
                prefix="swan_migrate_")
            self._migrate_ckpt = CheckpointManager(self._migrate_tmpdir.name)
        return self._migrate_ckpt

    def _apply_migration(self, step: int, state, from_rung: Rung,
                         reason: str, completed: int):
        """Carry state from ``from_rung`` onto the (already switched)
        controller's active rung, in place. ``completed`` = optimizer steps
        finished so far (the reference labels its remesh checkpoint with
        it; every migration here is in place). Returns (state,
        MigrationRecord)."""
        to_rung = self.rung
        t0 = time.perf_counter()
        if to_rung.param_dtype != from_rung.param_dtype:
            # cast only the parameters: optimizer moments stay float32 (adam
            # keeps full-precision state under bf16 params)
            state = dict(state)
            state["params"] = cast_params(state["params"], to_rung.dtype)
        cost_s = time.perf_counter() - t0
        self._recalibrate(from_rung, to_rung)
        rec = self.timeline.record_migration(
            step=step, from_rung=from_rung.name, to_rung=to_rung.name,
            reason=reason, kind="in-place", cost_s=round(cost_s, 6),
            cost_steps=0)
        self._steps_on_rung = 0
        if self.verbose:
            print(f"[swan] step {step}: migrate {from_rung.name} -> "
                  f"{to_rung.name} ({reason}, in-place)")
        return state, rec

    # -- SocJob surface ------------------------------------------------------
    def bind(self, until: int, *, start: int = 0, state=None,
             rng_seed: int = 0) -> "TrainSession":
        """Set this job's work target before handing it to a SwanRuntime.
        ``run()`` does this implicitly for the standalone path."""
        self._until = until
        self._step_idx = start
        self._losses = []
        self._init_state = state
        self._rng_seed = rng_seed
        self._prepared = False
        return self

    @property
    def done(self) -> bool:
        return self._prepared and self._step_idx >= self._until

    def _materialize(self, state):
        """Align a host/checkpoint state with the active rung and place it on
        the session's device. A checkpoint may have been written on any rung
        (e.g. the bf16 bottom), so the parameter dtype is re-aligned here."""
        state = tree_map(lambda a: torch.as_tensor(a, device=self.device)
                         if hasattr(a, "dtype") else a, dict(state))
        state["params"] = cast_params(state["params"], self.rung.dtype)
        return state

    def prepare(self) -> None:
        if self._prepared:
            return
        if self._until is None:
            raise RuntimeError("TrainSession must be bind()-ed (or run via "
                               "run()) before a runtime can step it")
        state = self._init_state
        if state is None:
            model = self.rung.build_model(self.cfg, self.device)
            state = init_train_state(model, self.optimizer,
                                     model.generator(self._rng_seed),
                                     compressor=self.compressor)
        self._state = self._materialize(state)
        self._init_state = None
        self._prepared = True

    # -- preemption (foreground bursts) --------------------------------------
    def on_pause(self, tick: int) -> None:
        """Checkpoint and *release* the training state — the foreground app
        that preempted us wants the memory. The checkpoint is labeled with
        the completed-step count, so resume (or a crash during the pause)
        restarts exactly at the pre-pause step. The rungs' CUDA graphs go
        too (their pool holds a step's activations and gradients); resume
        runs the first step eagerly and captures again."""
        if not self._prepared or self._state is None:
            return
        t0 = time.perf_counter()
        self._ckpt().save(self._step_idx, self._state)
        self._state = None
        for r in self._rungs:
            r.invalidate()
        self._graph_pool = None
        self.timeline.record_migration(
            step=self._step_idx, from_rung=self.rung.name,
            to_rung=self.rung.name, reason="pause", kind="pause",
            cost_s=round(time.perf_counter() - t0, 6))

    def on_resume(self, tick: int) -> None:
        """Reload the pause checkpoint through the normal restore machinery.
        ``restore_latest`` skips a corrupt/torn newest file and falls back to
        the previous step — in that case the step counter rewinds with the
        state so no optimizer step is skipped."""
        if not self._prepared or self._state is not None:
            return
        t0 = time.perf_counter()
        restored = self._ckpt().restore_latest()
        if restored is None:
            raise RuntimeError(
                f"{self.name}: no readable checkpoint to resume from")
        step, state = restored
        self._state = self._materialize(state)
        self._step_idx = int(step)
        self._steps_on_rung = 0  # first post-resume step re-warms caches
        self.timeline.record_migration(
            step=self._step_idx, from_rung=self.rung.name,
            to_rung=self.rung.name, reason="resume", kind="pause",
            cost_s=round(time.perf_counter() - t0, 6))

    def on_device_loss(self, tick: int, failed: Sequence[int]) -> None:
        raise NotImplementedError(
            "device loss needs a remesh over the surviving devices; "
            "repro_torch's TrainSession runs on one card")

    def step(self, tick: int) -> StepReport:
        step = self._step_idx
        rung = self.rung
        self._ran_tick = tick
        batch = self.batch_fn(step)
        fn = self.step_fn()
        # compile=True marks the first quantum on a rung (it pays the
        # first-use costs: kernel loads, allocator growth), as the
        # reference tags its compile spans, and every quantum whose compiled
        # step does not replay: the first call of a shape runs eagerly and
        # the second captures the graph (again after a migration moved the
        # state), so neither calibrates the controller
        compiles = getattr(fn, "compiles", None)
        warmup = self._steps_on_rung == 0 or bool(
            compiles and compiles(self._state, batch))
        with obs.get_telemetry().span("train.step", job=self.name, step=step,
                                      rung=rung.name, compile=warmup):
            t0 = time.perf_counter()
            self._state, metrics = fn(self._state, batch)
            loss = float(metrics["loss"])  # blocks until the step is done
            dt = time.perf_counter() - t0
        self._steps_on_rung += 1
        self._losses.append(loss)
        self._last_dt = dt
        self._last_rung_name = rung.name
        leaves = tree_leaves(batch)
        work = float(leaves[0].shape[0]) if leaves else 1.0  # samples
        return StepReport(latency_s=dt, work=work, loss=loss, warmup=warmup)

    def observe(self, tick: int, report: StepReport,
                slowdown: float) -> Optional[str]:
        step = self._step_idx
        rung = self.rung
        dt = report.latency_s
        # what the monitor sees
        if self.latency_fn is not None:
            observed = float(self.latency_fn(step, rung, dt))
        else:
            observed = dt * slowdown
        report.observed_s = observed
        self.timeline.record_step(step=step, rung=rung.name,
                                  latency_s=round(dt, 6),
                                  observed_s=round(observed, 6),
                                  loss=report.loss, warmup=report.warmup,
                                  work=report.work)
        return self._monitor_proposal(report, rung, dt, observed)

    def migrate(self, direction: str, reason: str,
                tick: int) -> Optional[MigrationRecord]:
        prev = self.ctl.idx
        self.ctl.commit(direction, reason)
        if self.ctl.idx == prev:
            return None
        ran = self._ran_tick == tick
        self._state, rec = self._apply_migration(
            self._step_idx, self._state, self._rungs[prev], reason,
            completed=self._step_idx + (1 if ran else 0))
        return rec

    def end_tick(self, tick: int) -> None:
        step = self._step_idx
        if self.log_every and (step % self.log_every == 0
                               or step == self._until - 1):
            print(f"step {step:5d} loss {self._losses[-1]:8.4f} "
                  f"({self._last_dt * 1e3:.0f} ms) [{self._last_rung_name}]")
        if self.ckpt is not None and self.ckpt_every and \
                (step + 1) % self.ckpt_every == 0:
            self.ckpt.save(step + 1, self._state)
        self._step_idx = step + 1

    def publish_metrics(self, metrics) -> None:
        if self._losses:
            metrics.gauge("train_loss").labels(job=self.name).set(
                self._losses[-1])
        metrics.gauge("train_steps_total").labels(job=self.name).set(
            float(self._step_idx))

    def finalize(self) -> None:
        if self.ckpt is not None and self._losses:
            self.ckpt.save(self._step_idx, self._state)

    def result(self) -> SessionResult:
        return SessionResult(losses=self._losses, timeline=self.timeline,
                             state=self._state, final_rung=self.rung.name,
                             controller=self.ctl)

    # -- standalone entry point ---------------------------------------------
    def run(self, steps: int, *, start: int = 0, state=None,
            rng_seed: int = 0) -> SessionResult:
        """Train standalone: a single-job SwanRuntime over this session."""
        from repro_torch.engine.runtime import SwanRuntime
        self.bind(steps, start=start, state=state, rng_seed=rng_seed)
        rt = SwanRuntime([self], trace=self.trace)
        rt.run(steps, start=start)
        return self.result()
