from repro_torch.fl.aggregation import FedYogi, fedavg, fedprox_grad  # noqa: F401
from repro_torch.fl.client import SwanClient  # noqa: F401
from repro_torch.fl.simulator import FLConfig, FLResult, compare_policies, run_fl  # noqa: F401
from repro_torch.fl.traces import make_client_traces, pchip_interpolate  # noqa: F401
