"""Adaptive runtime (paper Fig. 4b as a live engine), on one card.

``rungs``    — executable training ladder entries (Rung) with cached steps.
``jobs``     — the SocJob protocol (anything migratable the arbiter can
               schedule).
``runtime``  — SwanRuntime: the single event loop + arbiter over every job
               sharing the device (traces, thermals, energy budget).
``events``   — interference and thermal traces.
``timeline`` — machine-readable migration/step history.
``session``  — TrainSession: the training job; standalone ``run()`` is a
               single-job runtime.

``jobs``, ``runtime``, ``events`` and ``timeline`` are framework-free copies
of the JAX package's modules; ``rungs`` and ``session`` are its single-card
ports.
"""
