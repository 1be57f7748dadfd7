"""deepseek-moe-16b [moe] — arXiv:2401.06066 (hf tier).

28L d_model=2048 16H (MHA, kv=16), fine-grained MoE: 2 shared + 64 routed
top-6 experts with d_ff=1408; layer 0 dense with d_ff=10944 (hf config).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_k_dense=1,
    dense_d_ff=10944,
    activation="silu",
    norm="rmsnorm",
    rope_theta=10000.0,
    source="arXiv:2401.06066; hf",
)
