"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE = CONFIG.replace(
    name="llama3.2-1b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
)
