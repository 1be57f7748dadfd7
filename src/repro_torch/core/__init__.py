"""Swan's planner and control loop: copies of the JAX package's ``core/``
(choices, cost, controller, interference, energy, planner and the SoC half of
the profiler), with ``core.profiler.profile_rung`` measuring rungs on the
card in place of the reference's HLO roofline."""
from repro_torch.core.choices import CoreChoice, MeshChoice, enumerate_core_choices, enumerate_mesh_choices  # noqa: F401
from repro_torch.core.cost import ChoiceProfile, ladder, pareto_prune, pick_fastest  # noqa: F401
from repro_torch.core.controller import SwanController  # noqa: F401
from repro_torch.core.planner import SwanPlan, explore_soc, plan_from_profiles  # noqa: F401
