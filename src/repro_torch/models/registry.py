"""Model API over the ported families.

``build_model(cfg)`` returns a ``Model`` whose functions take params and
inputs and return tensors, as the JAX package's do. Only ``family="dense"``
is ported; other families raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # generator -> params
    forward: Callable[[Any, dict], Any]  # (params, batch) -> logits
    prefill: Callable  # (params, batch) -> (logits, cache)
    init_cache: Callable  # (batch, max_len, dtype) -> cache
    decode_step: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)
    build_kwargs: dict = dataclasses.field(default_factory=dict)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def build_model(cfg: ModelConfig, *, impl: str = "chunked", chunk: int = 1024,
                param_dtype=torch.float32, device="cuda") -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch")
    dev = resolve_device(device)
    kw = dict(impl=impl, chunk=chunk, param_dtype=param_dtype, device=dev)

    def prefill(p, b):
        return transformer.prefill_decoder(p, cfg, b["tokens"], impl=impl,
                                           chunk=chunk,
                                           last_pos=b.get("last_pos"))

    return Model(
        cfg=cfg,
        device=dev,
        init=lambda gen: transformer.init_decoder(gen, cfg, param_dtype),
        forward=lambda p, b: transformer.forward_decoder(
            p, cfg, b["tokens"], impl=impl, chunk=chunk)[0],
        prefill=prefill,
        init_cache=lambda batch, max_len, dtype=torch.bfloat16:
            transformer.init_cache_decoder(cfg, batch, max_len, dtype, dev),
        decode_step=lambda p, cache, tokens, cache_len:
            transformer.decode_step_decoder(p, cfg, cache, tokens, cache_len,
                                            impl=impl),
        build_kwargs=kw,
    )
