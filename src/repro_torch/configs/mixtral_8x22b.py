"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    source="arXiv:2401.04088",
)

SMOKE = CONFIG.replace(
    name="mixtral-8x22b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
    sliding_window=16,
    dtype="float32",
)
