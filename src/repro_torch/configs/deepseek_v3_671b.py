"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf tier).

61L d_model=7168 128H MLA (q_lora=1536, kv_lora=512, nope=128, rope=64,
v=128); MoE: 1 shared + 256 routed top-8 with d_ff=2048; first 3 layers dense
(d_ff=18432); 1 MTP module.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    moe_d_ff=2048,
    vocab_size=129280,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    first_k_dense=3,
    dense_d_ff=18432,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_mtp_modules=1,
    activation="silu",
    norm="rmsnorm",
    rope_theta=10000.0,
    source="arXiv:2412.19437; hf",
)
