from repro_torch.optim.optimizers import adam, sgd, apply_updates  # noqa: F401
