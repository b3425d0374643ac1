"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = CONFIG.replace(
    name="qwen2-moe-a2.7b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=128,
    moe_d_ff=128,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
    num_shared_experts=1,
    dtype="float32",
)
