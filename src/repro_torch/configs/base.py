"""Unified model configuration (a copy of the JAX package's, kept in step by hand).

One dataclass covers every assigned architecture family (dense / MoE / SSM /
hybrid / enc-dec / VLM / CNN). Fields irrelevant to a family keep their
defaults; `family` drives which blocks the registry assembles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | cnn

    # --- transformer backbone ---
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu"  # silu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"  # rope | sinusoidal | learned | none
    max_position: int = 1 << 20

    # --- MoE ---
    n_experts: int = 0  # routed experts (0 -> dense MLP)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (fine-grained)
    first_k_dense: int = 0  # leading layers with dense MLP
    dense_d_ff: int = 0  # hidden for those dense layers (0 -> d_ff)
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MTP (deepseek-v3) ---
    n_mtp_modules: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    shared_attn_every: int = 0  # zamba2: apply the shared attn block every N layers

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500  # stub conv frontend output length

    # --- VLM ---
    cross_attn_every: int = 0  # insert cross-attn layer every N decoder layers
    n_image_tokens: int = 1601  # stub vision frontend output length

    # --- CNN (paper's own workloads) ---
    cnn_stages: Tuple[int, ...] = ()
    cnn_widths: Tuple[int, ...] = ()
    n_classes: int = 0
    image_size: int = 32
    in_channels: int = 3
    cnn_kind: str = ""  # resnet | mobilenet | shufflenet

    # --- notes ---
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family != "cnn" and self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived properties ------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return self.family != "cnn"

    # -- parameter accounting (used for MODEL_FLOPS = 6*N*D) ---------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.use_mla:
            q = self.d_model * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.qk_rope_head_dim)
            kv = self.d_model * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            o = self.n_heads * self.v_head_dim * d
            return q + kv + o
        nq, nkv = self.n_heads, max(self.n_kv_heads, 1)
        return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

    def _mlp_params(self, ff: int) -> int:
        mult = 2 if self.activation == "relu2" else 3  # gated MLPs have 3 mats
        return mult * self.d_model * ff

    def _ssm_params(self) -> int:
        d_inner = self.ssm_expand * self.d_model
        # mamba2-ish: in_proj (z,x,B,C,dt), conv, out_proj
        p = self.d_model * (2 * d_inner + 2 * self.ssm_n_groups * self.ssm_state)
        p += d_inner * self.ssm_conv_width + d_inner * self.d_model + 2 * d_inner
        return p

    def _rwkv_params(self) -> int:
        d = self.d_model
        tmix = 4 * d * d + d * self.d_ff // 2  # r,k,v,o + lora-ish decay (approx)
        cmix = 2 * d * self.d_ff
        return tmix + cmix

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        if self.family == "cnn":
            return self._cnn_param_count()
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._rwkv_params() if "rwkv" in self.name else self._ssm_params()
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            total = self.n_layers * self._ssm_params()
            if self.shared_attn_every:
                shared = self._attn_params() + self._mlp_params(self.d_ff) + 2 * d * d
                total += shared  # params shared across applications
        else:
            attn = self._attn_params()
            total = 0
            for layer in range(self.n_layers):
                if self.is_moe and layer >= self.first_k_dense:
                    ff = (self.n_experts + self.n_shared_experts) * self._mlp_params(self.moe_d_ff)
                    ff += d * self.n_experts  # router
                else:
                    ff = self._mlp_params(self.dense_d_ff or self.d_ff)
                total += attn + ff
            if self.family == "encdec":
                # encoder stack + decoder cross-attn
                total += self.n_encoder_layers * (attn + self._mlp_params(self.d_ff))
                total += self.n_layers * attn  # cross-attn per decoder layer
            if self.family == "vlm" and self.cross_attn_every:
                total += (self.n_layers // self.cross_attn_every) * self._attn_params()
        return total + emb

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        total = 0
        for layer in range(self.n_layers):
            if layer >= self.first_k_dense:
                ff = (self.top_k + self.n_shared_experts) * self._mlp_params(self.moe_d_ff)
                ff += d * self.n_experts
            else:
                ff = self._mlp_params(self.dense_d_ff or self.d_ff)
            total += attn + ff
        return total + emb

    def _cnn_param_count(self) -> int:
        # rough but adequate for FLOPs accounting in the SoC model
        total, cin = 0, self.in_channels
        for w, n in zip(self.cnn_widths, self.cnn_stages):
            for _ in range(n):
                if self.cnn_kind == "resnet":
                    total += 2 * 9 * w * w + (cin != w) * cin * w
                else:  # depthwise-separable families
                    total += 9 * w + cin * w + w * w
                cin = w
        total += cin * self.n_classes
        return total

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2) or self.n_layers,
            d_model=min(self.d_model, 64) if self.d_model else 0,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256) if self.vocab_size else 0,
            head_dim=16 if self.n_heads else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 32) if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            dense_d_ff=min(self.dense_d_ff, 128) if self.dense_d_ff else 0,
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 16) if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_audio_frames=32,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_image_tokens=16,
            n_mtp_modules=min(self.n_mtp_modules, 1),
            cnn_stages=tuple(min(s, 1) for s in self.cnn_stages),
            cnn_widths=tuple(min(w, 16) for w in self.cnn_widths),
            n_classes=min(self.n_classes, 10) if self.n_classes else 0,
            image_size=min(self.image_size, 16) if self.image_size else 0,
        )
        return ModelConfig(**kw)
