"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54 Mamba2 layers with ONE shared (weight-tied) attention+MLP block
invoked after every 6 SSM layers (9 invocations).  The per-invocation
LoRA adapters of the real model are omitted, as in the JAX package."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    attn_every=6,
    dtype="bfloat16",
    source="arXiv:2411.15242",
)

SMOKE = CONFIG.replace(
    name="zamba2-2.7b-smoke",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    attn_every=2,
    dtype="float32",
)
