"""Fleet runtime: thousands of FL client SoCs co-scheduled through SwanRuntime.

The device half (``fleet.job``) wraps one client's local training round as a
preemptible, checkpointable :class:`FLTrainJob` driven through a per-device
``SwanRuntime`` — battery/thermal/foreground events come from the client's
``BatteryTrace``. The coordinator half (``fleet.coordinator``) owns the round
lifecycle: over-provisioned invites, binding deadlines with a stale-update
window, bounded retry/backoff, checksum/dedup acceptance, and
crash-consistent aggregation through ``repro_torch.checkpoint``.

The JAX package's ``fleet/``, numpy as there, over the port's engine and
planner.
"""
from repro_torch.fleet.coordinator import (CoordinatorCrash, FleetConfig,
                                           FleetCoordinator, FleetResult,
                                           FleetRound, build_fleet_clients,
                                           run_fleet)
from repro_torch.fleet.job import (ClientOutcome, FleetClient, FLRung,
                                   FLTrainJob, run_client_round)

__all__ = [
    "ClientOutcome", "CoordinatorCrash", "FLRung", "FLTrainJob",
    "FleetClient", "FleetConfig", "FleetCoordinator", "FleetResult",
    "FleetRound", "build_fleet_clients", "run_client_round", "run_fleet",
]
