"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>`` resolution.

Only the architectures whose family the port runs are registered: the dense
decoders (llama3.2-1b, granite-3-2b, nemotron-4-15b, command-r-35b), the
deepseek MoE decoders (deepseek-moe-16b, deepseek-v3-671b with MLA) and the
paper's three CNNs (``cnn_paper.py``). Any other arch id raises until its
family is ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.cnn_paper import MOBILENET_V2, RESNET34, SHUFFLENET_V2
from repro_torch.configs.command_r_35b import CONFIG as _commandr35b
from repro_torch.configs.deepseek_moe_16b import CONFIG as _dsmoe16b
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.granite3_2b import CONFIG as _granite2b
from repro_torch.configs.llama3p2_1b import CONFIG as _llama1b
from repro_torch.configs.nemotron4_15b import CONFIG as _nemotron15b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in (_llama1b, _granite2b, _nemotron15b, _commandr35b,
                        _dsmoe16b, _dsv3, RESNET34, MOBILENET_V2, SHUFFLENET_V2)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; "
            f"ported: {sorted(REGISTRY)}")
    return REGISTRY[name]
