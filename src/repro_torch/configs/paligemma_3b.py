"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

The SigLIP vision tower + projector are STUBBED, as in the JAX package:
``input_specs`` provides 256 precomputed patch embeddings of width
d_model; this config is the gemma-2b language decoder that consumes
them, with attention at head dim 256."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="vision_stub",
    num_prefix_tokens=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2407.07726",
)

SMOKE = CONFIG.replace(
    name="paligemma-3b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_prefix_tokens=16,
    dtype="float32",
)
