"""Adaptive runtime (paper Fig. 4b as a live engine), on one card.

``rungs``    — executable training ladder entries (Rung) with cached steps,
               and ``rungs_from_ladder`` (a planner ladder onto rungs).
``jobs``     — the SocJob protocol (anything migratable the arbiter can
               schedule), serving rungs, ServeJob and ForegroundAppJob.
``chaos``    — the seeded fault injector the runtime consults every tick.
``runtime``  — SwanRuntime: the single event loop + arbiter over every job
               sharing the device (traces, thermals, energy budget).
``events``   — interference and thermal traces.
``timeline`` — machine-readable migration/step history.
``session``  — TrainSession: the training job; standalone ``run()`` is a
               single-job runtime.

``jobs``, ``chaos``, ``runtime``, ``events`` and ``timeline`` are
framework-free copies of the JAX package's modules; ``rungs`` and
``session`` are its single-card ports.
"""
from repro_torch.engine.events import (Burst, DeviceLossEvent,  # noqa: F401
                                       FaultModelEvents, InterferenceTrace,
                                       ScriptedFaults, ThermalTrace)
from repro_torch.engine.jobs import (ForegroundAppJob, ServeJob,  # noqa: F401
                                     ServeRung, SocJob, StepReport,
                                     default_serve_ladder)
from repro_torch.engine.rungs import (Rung, default_rung_ladder,  # noqa: F401
                                      rungs_from_ladder)
from repro_torch.engine.runtime import RuntimeResult, SwanRuntime  # noqa: F401
from repro_torch.engine.session import SessionResult, TrainSession  # noqa: F401
from repro_torch.engine.timeline import (MigrationRecord, StepRecord,  # noqa: F401
                                         Timeline)
