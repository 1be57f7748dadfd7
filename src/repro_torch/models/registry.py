"""Model API over the ported families.

``build_model(cfg)`` returns a ``Model`` whose functions take params and
inputs and return tensors, as the JAX package's do. The dense and moe
decoders and the CNN family (``family="cnn"``: init, forward and loss only;
its serving fields are None, as in the reference) are ported; other
families raise. Under MLA the speculative steps are None, as in the
reference. ``moe_cf``, the MoE layers' capacity factor, reaches every
function of the model, the loss among them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn, transformer


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]  # generator -> params
    forward: Callable[[Any, dict], Any]  # (params, batch) -> logits
    loss: Callable[[Any, dict], Any]  # (params, batch) -> scalar
    # the serving surface; None for a family that does not decode (CNNs)
    prefill: Optional[Callable] = None  # (params, batch) -> (logits, cache)
    init_cache: Optional[Callable] = None  # (batch, max_len, dtype) -> cache
    # (params, cache, tokens, cache_len) -> (logits, cache)
    decode_step: Optional[Callable] = None
    # (num_blocks, block_size, dtype) -> paged pools
    init_paged_cache: Optional[Callable] = None
    # (params, cache, tokens, cache_len, block_table) -> (logits, cache)
    paged_decode_step: Optional[Callable] = None
    # (params, cache, tokens, start, block_table, last_pos, write) -> (logits, cache)
    paged_prefill_step: Optional[Callable] = None
    # (params, cache, tokens (B,S), cache_len) -> (logits (B,S,V), cache)
    spec_decode_step: Optional[Callable] = None
    # (params, cache, tokens (B,S), cache_len, block_table) -> (logits, cache)
    paged_spec_decode_step: Optional[Callable] = None
    # the exact build_model kwargs this model was constructed with, so a
    # single-knob rebuild preserves the rest
    build_kwargs: dict = dataclasses.field(default_factory=dict)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def rebuild_model(model: Model, **overrides) -> Model:
    """Rebuild a model changing only the given build_model kwargs."""
    kw = dict(model.build_kwargs)
    kw.update(overrides)
    return build_model(model.cfg, **kw)


def build_model(cfg: ModelConfig, *, impl: str = "chunked", chunk: int = 1024,
                remat: str = "none", param_dtype=torch.float32,
                moe_cf: float = 1.25, device="cuda") -> Model:
    if cfg.family not in ("dense", "moe", "cnn"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported to repro_torch")
    dev = resolve_device(device)
    kw = dict(impl=impl, chunk=chunk, remat=remat, param_dtype=param_dtype,
              moe_cf=moe_cf, device=dev)
    if cfg.family == "cnn":
        # the depthwise kernel with impl="pallas", the plain path otherwise
        cnn_impl = "pallas" if impl == "pallas" else "naive"
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda gen: cnn.init_cnn(gen, cfg, param_dtype),
            forward=lambda p, b: cnn.forward_cnn(p, cfg, b["images"],
                                                 impl=cnn_impl),
            loss=lambda p, b: cnn.loss_cnn(p, cfg, b, impl=cnn_impl),
            build_kwargs=kw,
        )

    def prefill(p, b):
        return transformer.prefill_decoder(p, cfg, b["tokens"], impl=impl,
                                           chunk=chunk,
                                           last_pos=b.get("last_pos"),
                                           moe_cf=moe_cf)

    spec = not cfg.use_mla  # MLA has no verify window, as in the reference
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda gen: transformer.init_decoder(gen, cfg, param_dtype),
        forward=lambda p, b: transformer.forward_decoder(
            p, cfg, b["tokens"], impl=impl, chunk=chunk, remat=remat,
            moe_cf=moe_cf)[0],
        loss=lambda p, b: transformer.loss_decoder(p, cfg, b, impl=impl,
                                                   chunk=chunk, remat=remat,
                                                   moe_cf=moe_cf),
        prefill=prefill,
        init_cache=lambda batch, max_len, dtype=torch.bfloat16:
            transformer.init_cache_decoder(cfg, batch, max_len, dtype, dev),
        decode_step=lambda p, cache, tokens, cache_len:
            transformer.decode_step_decoder(p, cfg, cache, tokens, cache_len,
                                            impl=impl, moe_cf=moe_cf),
        init_paged_cache=lambda num_blocks, block_size, dtype=torch.bfloat16:
            transformer.init_paged_cache_decoder(cfg, num_blocks, block_size,
                                                 dtype, dev),
        paged_decode_step=lambda p, cache, tokens, cache_len, block_table:
            transformer.decode_step_decoder(p, cfg, cache, tokens, cache_len,
                                            impl=impl, moe_cf=moe_cf,
                                            block_table=block_table),
        paged_prefill_step=lambda p, cache, tokens, start, block_table,
        last_pos=None, write=True: transformer.paged_prefill_step_decoder(
            p, cfg, cache, tokens, start, block_table, last_pos=last_pos,
            write=write, moe_cf=moe_cf),
        spec_decode_step=(lambda p, cache, tokens, cache_len:
                          transformer.spec_decode_step_decoder(
                              p, cfg, cache, tokens, cache_len, impl=impl,
                              moe_cf=moe_cf)) if spec else None,
        paged_spec_decode_step=(lambda p, cache, tokens, cache_len, block_table:
                                transformer.spec_decode_step_decoder(
                                    p, cfg, cache, tokens, cache_len, impl=impl,
                                    moe_cf=moe_cf, block_table=block_table))
        if spec else None,
        build_kwargs=kw,
    )
