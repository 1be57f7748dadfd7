"""nemotron-4-15b [dense] — arXiv:2402.16819 (unverified tier).

GQA, squared-ReLU MLP (2-matrix, non-gated)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    source="arXiv:2402.16819; unverified",
)
