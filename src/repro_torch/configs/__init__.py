"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>`` resolution.

Only the architectures whose family the port serves are registered; any
other arch id raises until its family is ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3p2_1b import CONFIG as _llama1b

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in (_llama1b,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; "
            f"ported: {sorted(REGISTRY)}")
    return REGISTRY[name]
