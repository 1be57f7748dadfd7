from repro_torch.optim.optimizers import adam, sgd, apply_updates  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule, warmup_linear  # noqa: F401
