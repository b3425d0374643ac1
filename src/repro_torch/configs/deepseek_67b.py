"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    dtype="bfloat16",
    source="arXiv:2401.02954",
)

SMOKE = CONFIG.replace(
    name="deepseek-67b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
)
