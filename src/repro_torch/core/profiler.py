"""Profiling execution choices (paper §4.2).

SoC choices are profiled with the analytic device model (stands in for the
paper's few-batch on-device benchmarking; see core/energy.py): a copy of the
SoC half of the JAX package's ``core/profiler.py``.

The reference profiles its TPU mesh choices without running them (AOT
compilation and an HLO roofline). The port's counterpart measures instead:
:func:`profile_rung` runs a few real train steps of one ``engine.rungs.Rung``
on the card, as §4.2 benchmarks a few batches on the phone, and the steps it
times are training, not thrown away (work-conserving).
"""
from __future__ import annotations

import statistics
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core import energy as E
from repro_torch.core.choices import CoreChoice
from repro_torch.core.cost import ChoiceProfile

# ---------------------------------------------------------------------------
# SoC analytic profiler (paper's local benchmarking)
# ---------------------------------------------------------------------------


def soc_throughput(choice: CoreChoice, model: E.SocModel, mem_intensity: float) -> float:
    """Effective GFLOP/s of a core combination for a given workload.

    - heterogenous combinations pace OMP barriers to the slowest core;
    - parallel overhead grows with thread count;
    - memory-bound fraction suffers the cache-thrash penalty (O2) that grows
      with the number of *threads sharing the cache*.
    """
    cores = [model.cores[c] for c in choice.cores]
    n = len(cores)
    slowest = min(c.gflops for c in cores)
    raw = slowest * n  # barrier-paced data parallelism
    raw /= 1.0 + model.parallel_overhead * (n - 1)
    thrash = 1.0 + model.thrash_coef * mem_intensity * (n - 1)
    return raw / thrash


def profile_soc_choice(choice: CoreChoice, model: E.SocModel, workload: str,
                       *, batches: int = 1) -> ChoiceProfile:
    gflops = E.WORKLOAD_GFLOPS_PER_STEP[workload]
    mem = E.WORKLOAD_MEM_INTENSITY[workload]
    thr = soc_throughput(choice, model, mem)
    latency = gflops / thr  # seconds per local step (batch 16)
    power = model.base_power_w + sum(model.cores[c].power_w for c in choice.cores)
    return ChoiceProfile(
        choice=choice, latency_s=latency * batches, energy_j=power * latency * batches,
        power_w=power, cost_key=choice.cost_key(model),
        meta={"workload": workload, "throughput_gflops": thr})


def greedy_baseline_profile(model: E.SocModel, workload: str) -> ChoiceProfile:
    """PyTorch default: one thread per low-latency core, no affinity pinning
    (paper §5.1 baseline). Unpinned threads migrate => migration_penalty."""
    classes = model.classes()
    fast = classes.get("big", ()) + classes.get("prime", ())
    choice = CoreChoice(fast, model.name)
    prof = profile_soc_choice(choice, model, workload)
    lat = prof.latency_s * model.migration_penalty
    # during migration stalls the cores idle, so average power drops
    core_w = sum(model.cores[c].power_w for c in choice.cores)
    power = model.base_power_w + core_w / model.migration_penalty
    return ChoiceProfile(choice=choice, latency_s=lat, energy_j=power * lat,
                         power_w=power, cost_key=choice.cost_key(model),
                         meta={"workload": workload, "baseline": True})


# ---------------------------------------------------------------------------
# measured rung profiler (the card)
# ---------------------------------------------------------------------------

# the card's board power as nvidia-smi reads it, sampled every POWER_PERIOD_MS:
# the instant reading, since on Hopper ``power.draw`` averages over a second,
# longer than three replays of a fast rung
POWER_FIELD = "power.draw.instant"
POWER_PERIOD_MS = 50
# steps timed a rung (on the card: replays, going on until they span at
# least POWER_WINDOW_S and hold one power sample, failing past the timeout)
TIMED_STEPS = 3
POWER_WINDOW_S = 0.25
POWER_TIMEOUT_S = 30.0


class _PowerSampler:
    """``nvidia-smi``'s ``POWER_FIELD`` of one card every ``POWER_PERIOD_MS``,
    from a child process; each sample is stamped with the host's
    ``perf_counter`` as it arrives. Use as a context manager: leaving it
    stops the process."""

    def __init__(self, device: torch.device):
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        self.samples: List[Tuple[float, float]] = []
        self.rejected: List[str] = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={POWER_FIELD}",
             "--format=csv,noheader,nounits", "-i",
             uuid if uuid.startswith("GPU-") else f"GPU-{uuid}",
             "-lms", str(POWER_PERIOD_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self._proc.stdout:
            try:
                self.samples.append((time.perf_counter(), float(line)))
            except ValueError:
                self.rejected.append(line.strip())

    def between(self, t0: float, t1: float) -> List[float]:
        return [w for t, w in list(self.samples) if t0 <= t <= t1]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)


def profile_rung(rung, cfg, state, *, optimizer, batch_fn: Callable,
                 start: int = 0, lr: float = 0.05, position: int = 0,
                 n: int = 1, device="cuda") -> Tuple[ChoiceProfile, Any]:
    """Profile ``rung`` by training on it: the port's counterpart of the
    reference's ``profile_mesh_choice``. Returns (its ChoiceProfile, the
    state after the profiled steps).

    The steps are real train steps of ``rung.jitted_step`` on ``state``
    (the parameters cast to the rung's dtype first, as a session's
    migration does), on ``batch_fn(start)``, ``batch_fn(start + 1)``, ...:
    the state returned is the one a session on ``rung`` would hold after as
    many steps from the same start (work-conserving, §4.2).
    ``meta["steps"]`` says how many ran.

    On the card (``device="cuda"``): the rung's first two calls are its
    eager step and its capture (``launch/steps.CompiledStep``); then at
    least ``TIMED_STEPS`` replays, each timed with CUDA events, go on until they
    span ``POWER_WINDOW_S`` and hold a power sample. ``latency_s`` is the
    median replay; ``memory_bytes`` is ``torch.cuda.max_memory_allocated``
    over the rung's steps (the peak statistics are reset); ``power_w`` is
    the mean of nvidia-smi's ``POWER_FIELD`` over the timed replays. A timed
    call that does not replay raises. On the CPU (``device="cpu"``, as the
    tests ask) the compiled step runs eagerly, ``TIMED_STEPS`` steps are timed
    with ``time.perf_counter``, and power and memory are not measured:
    ``power_w`` stays ``Rung.profile``'s 1.0 and ``memory_bytes`` 0. Only
    ``device`` chooses between the two. Either way ``energy_j = power_w *
    latency_s`` and ``cost_key`` is ``rung.profile(position=position,
    n=n)``'s: the rung's place in the list being explored.

    The rung's compiled step is dropped at the end (``Rung.invalidate``),
    so its graphs' memory goes back before the next rung is profiled; a
    session on the planned ladder captures its own.
    """
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.steps import cast_params
    dev = resolve_device(device)
    state = dict(state)
    state["params"] = cast_params(state["params"], rung.dtype)
    fn = rung.jitted_step(cfg, optimizer, lr=lr, device=dev)
    step, calls, losses, step_s = start, [], [], []

    def run(batch):
        nonlocal state, step
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))  # blocks until the step is done
        calls.append(fn.last_call)
        step += 1

    meta: Dict[str, Any] = {"start": start, "device": str(dev)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with _PowerSampler(dev) as power:
            batch = batch_fn(step)
            while fn.compiles(state, batch):  # the eager call, the capture
                if len(calls) == 2:
                    raise RuntimeError(f"rung {rung.name!r}: its step did not "
                                       f"settle into replays ({calls})")
                run(batch)
                batch = batch_fn(step)
            t_begin = time.perf_counter()
            while (len(step_s) < TIMED_STEPS
                   or time.perf_counter() - t_begin < POWER_WINDOW_S
                   or not power.between(t_begin, time.perf_counter())):
                if time.perf_counter() - t_begin > POWER_TIMEOUT_S:
                    raise RuntimeError(
                        f"rung {rung.name!r}: no power sample from nvidia-smi "
                        f"in {POWER_TIMEOUT_S} s (it printed {power.rejected})")
                batch = batch_fn(step) if batch is None else batch
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                run(batch)
                e1.record()
                if calls[-1] != "replay":
                    raise RuntimeError(f"rung {rung.name!r}: a timed step did "
                                       f"not replay ({calls})")
                e1.synchronize()
                step_s.append(e0.elapsed_time(e1) / 1e3)
                batch = None
            watts = power.between(t_begin, time.perf_counter())
        power_w = statistics.fmean(watts)
        memory = torch.cuda.max_memory_allocated(dev)
        meta.update(power=f"nvidia-smi {POWER_FIELD}, mean of {len(watts)} "
                    f"samples over the timed replays",
                    capture_ms=1e3 * fn.capture_s, timing="cuda events")
    else:
        for _ in range(TIMED_STEPS):
            batch = batch_fn(step)
            t0 = time.perf_counter()
            run(batch)
            step_s.append(time.perf_counter() - t0)
        power_w, memory = 1.0, 0
        meta.update(power="unmeasured", memory="unmeasured",
                    timing="perf_counter")
    rung.invalidate()
    latency = statistics.median(step_s)
    meta.update(steps=step - start, calls=calls, losses=losses,
                step_s=step_s)
    return ChoiceProfile(choice=rung, latency_s=latency,
                         energy_j=power_w * latency, power_w=power_w,
                         cost_key=rung.profile(position=position, n=n).cost_key,
                         memory_bytes=memory, meta=meta), state
