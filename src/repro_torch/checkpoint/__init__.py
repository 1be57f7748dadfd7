from repro_torch.checkpoint.store import save_pytree, load_pytree  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
