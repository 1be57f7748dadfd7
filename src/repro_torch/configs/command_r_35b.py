"""command-r-35b [dense] — hf:CohereForAI/c4ai-command-r-v01 (unverified tier).

GQA, no-bias, layernorm (Cohere uses non-standard LN w/o bias)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    activation="silu",
    norm="layernorm",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8000000.0,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
