"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2407.10671",
)

SMOKE = CONFIG.replace(
    name="qwen2-0.5b-smoke",
    num_layers=2,
    d_model=224,
    num_heads=7,
    num_kv_heads=1,
    head_dim=32,
    d_ff=448,
    vocab_size=512,
    dtype="float32",
)
